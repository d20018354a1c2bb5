"""Counterpart of ``repro.nn``: parameter conventions, layers, RoPE,
attention and its KV cache."""
