"""Grouped-query attention with RoPE and a KV cache (counterpart of
``repro/nn/attention.py``).

Shapes: x (B, S, D); q heads H, kv heads K (H % K == 0); head dim Dh.
``impl="flash"`` runs the hand-written Hopper kernel
(``kernels/flash_attention``); ``"xla"`` keeps the JAX package's name for
the plain einsum path (q-chunked beyond ``xla_chunk_threshold`` keys).
With a cache (prefill into it, decode, chunked prefill) the new keys and
values are written into the cache and the queries attend over all S_max
slots through the plain einsum path, whatever ``impl`` is, as in the JAX
package: causal at the cache's offset, with the slots past it masked.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.nn.kvcache import KVCache
from repro_torch.nn.layers import init_linear, linear
from repro_torch.nn.module import Params
from repro_torch.nn.rope import apply_rope

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    out_bias: bool = False
    impl: str = "xla"          # "xla" | "flash" (the Hopper kernel tiles itself)
    xla_chunk_threshold: int = 8192
    xla_chunk_q: int = 256


def init_attention(generator: torch.Generator, cfg: AttentionConfig) -> Params:
    H, K, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    return {
        "wq": init_linear(generator, D, H * Dh, cfg.qkv_bias),
        "wk": init_linear(generator, D, K * Dh, cfg.qkv_bias),
        "wv": init_linear(generator, D, K * Dh, cfg.qkv_bias),
        "wo": init_linear(generator, H * Dh, D, cfg.out_bias),
    }


def _qkv(params: Params, x: torch.Tensor, cfg: AttentionConfig, cos, sin):
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = linear(params["wq"], x, x.dtype).reshape(B, S, H, Dh)
    k = linear(params["wk"], x, x.dtype).reshape(B, S, K, Dh)
    v = linear(params["wv"], x, x.dtype).reshape(B, S, K, Dh)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _attend_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, q_offset: int = 0,
                kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Sk,K,Dh) -> (B,Sq,H,Dh).  f32 softmax.
    ``q_offset``: the position of q's first row; ``kv_valid`` (Sk,) bool
    masks the key slots that hold no token."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores * (1.0 / math.sqrt(Dh))
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    if kv_valid is not None:
        scores = torch.where(kv_valid, scores, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H, Dh)


def _attend_xla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, chunk: int, q_offset: int = 0,
                        kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with q in chunks (scores live at (…, chunk, S), not
    (…, S, S)); each chunk is checkpointed, so the backward recomputes it."""
    outs = [checkpoint(_attend_xla, q[:, s:s + chunk], k, v, causal=causal,
                       q_offset=s + q_offset, kv_valid=kv_valid, use_reentrant=False)
            for s in range(0, q.shape[1], chunk)]
    return torch.cat(outs, dim=1)


def attention(params: Params, x: torch.Tensor, cfg: AttentionConfig, *,
              cos=None, sin=None, causal: bool = True,
              cache: Optional[KVCache] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (y (B,S,D), the updated cache).  Without a cache: the train /
    prefill-from-zero path.  With one: S new tokens (1 to decode) at
    ``cache.pos``, attending over the cache."""
    q, k, v = _qkv(params, x, cfg, cos, sin)
    S = q.shape[1]
    if cache is not None:
        q_offset = cache.pos
        cache = cache.update(k, v)
        k_all, v_all = cache.k.to(q.dtype), cache.v.to(q.dtype)
        kv_valid = cache.valid_mask()
        if S > cfg.xla_chunk_threshold and S % cfg.xla_chunk_q == 0:
            out = _attend_xla_chunked(q, k_all, v_all, causal=True, chunk=cfg.xla_chunk_q,
                                      q_offset=q_offset, kv_valid=kv_valid)
        else:
            out = _attend_xla(q, k_all, v_all, causal=True, q_offset=q_offset,
                              kv_valid=kv_valid)
    elif cfg.impl == "flash":
        out = fa_ops.flash_attention(q, k, v, causal=causal)
    elif cfg.impl != "xla":
        raise ValueError(f"unknown attention impl {cfg.impl!r} (xla | flash)")
    elif S > cfg.xla_chunk_threshold and S % cfg.xla_chunk_q == 0:
        out = _attend_xla_chunked(q, k, v, causal=causal, chunk=cfg.xla_chunk_q)
    else:
        out = _attend_xla(q, k, v, causal=causal)
    B = x.shape[0]
    y = linear(params["wo"], out.reshape(B, S, cfg.n_heads * cfg.d_head), x.dtype)
    return y, cache
