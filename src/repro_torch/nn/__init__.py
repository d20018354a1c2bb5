"""Counterpart of ``repro.nn``: parameter conventions, layers, RoPE and
attention (the path without a KV cache)."""
