"""Counterpart of ``repro.nn``: parameter conventions, layers, RoPE,
attention and its KV cache, the MoE FFN and the Mamba2 SSD mixer and its
state cache."""
