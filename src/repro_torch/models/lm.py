"""Decoder LM, the dense family (counterpart of ``repro/models/lm.py``):

  dense : [RMSNorm -> GQA attention] + [RMSNorm -> MLP], n_layers times

The input embedding is the paper's compressed embedding whenever
``cfg.embedding.kind != "dense"``: token ids -> packed codes -> codebook
decode (``hash_decode`` on the card) -> decoder MLP.  ``blocks`` holds each
per-layer leaf stacked on a leading layer axis, as ``jax.vmap`` leaves them
in the JAX package, so ``interop.params_from_jax`` carries a JAX init across
unchanged; the forward unbinds the stack once, so the backward stacks the
layer gradients once.  ``remat=True`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant) as the JAX scan body is
checkpointed.

The forward marks its stages (embed, blocks, head, loss) for
``stages.StageTimer``.  Only the path without a cache (training, prefill from zero) is ported; the
moe, ssm, hybrid, audio and vlm families, the KV cache and the chunked
cross-entropy raise, naming their ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LM_SLICE, LMConfig
from repro_torch.core import embedding as emb_lib
from repro_torch.core import lsh
from repro_torch.core.backend import torch_dtype
from repro_torch.nn.attention import SERVING_SLICE, AttentionConfig, attention, init_attention
from repro_torch.nn.layers import init_mlp, init_norm, mlp, norm
from repro_torch.nn.module import Params, dense_init
from repro_torch.nn.rope import default_positions, rope_cos_sin
from repro_torch.stages import stage

NEG_INF = -1e30


def attn_config(cfg: LMConfig) -> AttentionConfig:
    return AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, qkv_bias=cfg.qkv_bias, impl=cfg.attn_impl)


def check_ported(cfg: LMConfig) -> None:
    if cfg.family != "dense" or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.input_mode} input) is not ported "
            f"yet; it comes with {LM_SLICE}")


def init_attn_block(generator: torch.Generator, cfg: LMConfig) -> Params:
    return {
        "norm1": init_norm(generator, cfg.d_model, cfg.norm),
        "attn": init_attention(generator, attn_config(cfg)),
        "norm2": init_norm(generator, cfg.d_model, cfg.norm),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act),
    }


def attn_block(p: Params, x: torch.Tensor, cfg: LMConfig, cos, sin) -> torch.Tensor:
    h, _ = attention(p["attn"], norm(p["norm1"], x, cfg.norm), attn_config(cfg),
                     cos=cos, sin=sin)
    x = x + h
    return x + mlp(p["mlp"], norm(p["norm2"], x, cfg.norm), cfg.act)


def _stack(trees):
    """Per-layer param dicts -> one dict of leaves stacked on axis 0."""
    first = trees[0]
    return {k: _stack([t[k] for t in trees]) if isinstance(v, dict)
            else torch.stack([t[k] for t in trees]) for k, v in first.items()}


def _unstack(tree, n: int):
    """Inverse of ``_stack``: n per-layer dicts of views (one ``unbind`` per
    leaf, so autograd stacks the layer gradients once)."""
    out = [dict() for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for i in range(n):
            out[i][k] = parts[i]
    return out


def init_lm(generator: torch.Generator, cfg: LMConfig,
            codes: Optional[torch.Tensor] = None, aux=None) -> Params:
    """``codes``: packed vocabulary codes (from the co-occurrence pass and
    Algorithm 1); ``aux``: the auxiliary matrix to encode from.  With
    neither, random codes (ALONE), as in the JAX package."""
    check_ported(cfg)
    ecfg = cfg.embedding_config()
    if ecfg.needs_codes and codes is None and aux is None:
        codes = lsh.encode_random(generator, ecfg.n_entities, ecfg.c, ecfg.m)
    params: Params = {
        "embed": emb_lib.init_embedding(generator, ecfg, codes=codes, aux=aux),
        "final_norm": init_norm(generator, cfg.d_model, cfg.norm),
        "head": dense_init(generator, (cfg.d_model, cfg.vocab_padded)),
        "blocks": _stack([init_attn_block(generator, cfg) for _ in range(cfg.n_layers)]),
    }
    return params


def _sinusoidal_pe(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    half = d // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                     * (math.log(10000.0) / half))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: LMConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    """Decode in f32 (the backend's sum), MLP tail and output in the compute
    dtype."""
    dtype = torch_dtype(cfg.compute_dtype)
    x = emb_lib.embed_lookup(params["embed"], tokens, cfg.embedding_config()).to(dtype)
    if cfg.rope_variant == "none":
        x = x + _sinusoidal_pe(positions, cfg.d_model, dtype)
    return x


def _rope(cfg: LMConfig, positions: torch.Tensor):
    if cfg.rope_variant == "none" or not cfg.n_heads:
        return None, None
    frac = 0.5 if cfg.rope_variant == "half" else 1.0
    sections = cfg.mrope_sections if cfg.rope_variant == "mrope" else None
    return rope_cos_sin(positions, cfg.head_dim, theta=cfg.rope_theta,
                        fraction=frac, mrope_sections=sections)


def lm_forward(params: Params, tokens: torch.Tensor, cfg: LMConfig, cache=None,
               positions: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, None]:
    """tokens (B, S) int -> (logits (B, S, Vpad) f32, None), causal over S."""
    check_ported(cfg)
    if cache is not None:
        raise NotImplementedError(f"lm_forward with a cache is not ported yet; "
                                  f"it comes with {SERVING_SLICE}")
    B, S = tokens.shape[:2]
    if positions is None:
        positions = default_positions(B, S, cfg.rope_variant, tokens.device)
    cos, sin = _rope(cfg, positions)
    with stage("embed"):
        x = _embed_tokens(params, tokens, cfg, positions)
    with stage("blocks"):
        for lp in _unstack(params["blocks"], cfg.n_layers):
            if cfg.remat:
                x = checkpoint(attn_block, lp, x, cfg, cos, sin, use_reentrant=False)
            else:
                x = attn_block(lp, x, cfg, cos, sin)
    with stage("head"):
        x = norm(params["final_norm"], x, cfg.norm)
        logits = (x @ params["head"].to(x.dtype)).float()
    return logits, None


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig) -> torch.Tensor:
    """Next-token cross-entropy on the full logits; the vocabulary padding
    is masked out of the softmax at -1e30."""
    if cfg.loss_vocab_chunk and cfg.vocab_padded % cfg.loss_vocab_chunk == 0:
        raise NotImplementedError(f"the chunked cross-entropy is not ported "
                                  f"yet; it comes with {LM_SLICE}")
    logits, _ = lm_forward(params, batch["tokens"], cfg,
                           positions=batch.get("positions"))
    with stage("loss"):
        if cfg.vocab_size != cfg.vocab_padded:
            pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, NEG_INF)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["labels"].to(torch.int64)[..., None])[..., 0]
        return (logz - gold).mean()
