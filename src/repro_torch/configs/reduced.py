"""Reduced same-family configs for CPU tests (counterpart of
``repro/configs/reduced.py``, the same cuts).

Shrinks width, depth, vocabulary and experts while keeping every structural
feature of the full architecture (family, GQA ratio, RoPE variant, QKV
bias, MoE top-k, SSD state, hybrid sharing period).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LMConfig


def reduced(cfg: LMConfig) -> LMConfig:
    scale = {}
    # depth: keep >= 2 layers; hybrid keeps one full group + tail
    if cfg.family == "hybrid":
        scale["n_layers"] = 2 * cfg.attn_every + 1
    else:
        scale["n_layers"] = 2
    if cfg.n_heads:
        n_heads = min(cfg.n_heads, 4)
        n_kv = max(1, min(cfg.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        scale.update(n_heads=n_heads, n_kv_heads=n_kv, d_head=32)
    scale.update(
        d_model=128,
        d_ff=min(cfg.d_ff, 256) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        vocab_round=64,
    )
    if cfg.family == "moe":
        scale.update(n_experts=min(cfg.n_experts, 8),
                     moe_top_k=min(cfg.moe_top_k, 2))
    if cfg.family in ("ssm", "hybrid"):
        scale.update(ssm_state=min(cfg.ssm_state, 16), ssm_headdim=16,
                     ssm_chunk=16)
    if cfg.rope_variant == "mrope":
        scale["mrope_sections"] = (4, 6, 6)
    scale["embedding"] = dataclasses.replace(
        cfg.embedding, c=min(cfg.embedding.c, 16), m=min(cfg.embedding.m, 8),
        d_c=64, d_m=64)
    scale["compute_dtype"] = "float32"
    scale["remat"] = False
    return dataclasses.replace(cfg, **scale)
