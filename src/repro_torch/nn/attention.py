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

Across ranks an ``AttnSplit`` says how the call is cut: the rank's query
heads (and KV heads, where they split too) of a ``ShardPlan`` whose
``enter`` feeds them; where the KV heads stay whole under split query
heads, each rank projects all of them from the un-entered input, enters
the keys and values (their gradient summed over ``model``), and attends
with the ones its query heads read.  Where the cache's slots are split
over mesh axes (``kv_seq`` bound: flash-decoding), a decode step attends
over the rank's own slots, keeping each query's (max, sum, f32 partial
output), and the ranks' three are all-gathered and combined in rank order
(``attend_split``); the query heads, where ``model`` splits both them and
the slots, are gathered first and the rank's own cut back out after.  A
prefill into a split cache attends over its new keys (a fresh cache holds
nothing else) and writes the slots the rank holds.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class AttnSplit:
    """One rank's cut of an attention call (module docstring).  ``plan``:
    the ``ShardPlan`` (None: heads whole); ``q_split`` / ``kv_split``:
    whether the rank's ``wq`` / ``wk`` hold a block of the heads;
    ``kv_sel``: (first, count) of the computed KV heads its query heads
    read, None for all; ``kv_axes``: the mesh axes the cache's slots are
    split over, () for none."""
    plan: Any = None
    q_split: bool = False
    kv_split: bool = False
    kv_sel: Optional[Tuple[int, int]] = None
    kv_axes: Tuple[str, ...] = ()

    @property
    def gather_q(self) -> bool:
        """Whether a split-KV decode gathers the query heads over ``model``
        first (``model`` splits both them and the slots)."""
        return self.q_split and "model" in self.kv_axes


def _qkv(params: Params, x: torch.Tensor, cfg: AttentionConfig, cos, sin,
         split: Optional[AttnSplit] = None):
    B, S, _ = x.shape
    H, K, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    xq = xk = x
    if split is not None and split.q_split:
        xq = split.plan.enter(x)
        xk = xq if split.kv_split else x
    q = linear(params["wq"], xq, x.dtype).reshape(B, S, H, Dh)
    k = linear(params["wk"], xk, x.dtype).reshape(B, S, K, Dh)
    v = linear(params["wv"], xk, x.dtype).reshape(B, S, K, Dh)
    if split is not None and split.q_split and not split.kv_split:
        k, v = split.plan.enter(k), split.plan.enter(v)
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


def _partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int,
             k_offset: int, kv_valid: torch.Tensor) -> torch.Tensor:
    """One rank's part of attention over its key slots (global positions
    from ``k_offset``): per query its f32 max score, sum of exponentials
    and unnormalised output, packed (B, K, g, Sq, 2 + Dh)."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, Dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float() * (1.0 / math.sqrt(Dh))
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device) + k_offset
    mask = (kpos[None, :] <= qpos[:, None]) & kv_valid[None, :]
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    o = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return torch.cat([m[..., None], p.sum(dim=-1)[..., None], o], dim=-1)


def combine_partials(parts) -> torch.Tensor:
    """The ranks' packed partials (``_partial``), in rank order, combined:
    the max over them, then the rescaled sums and outputs added in rank
    order.  Returns the f32 output (B, K, g, Sq, Dh)."""
    from repro_torch.parallel.tensor import ordered_sum
    top = torch.stack([t[..., 0] for t in parts]).amax(dim=0)
    scale = [torch.exp(t[..., 0] - top) for t in parts]
    total = ordered_sum([t[..., 1] * c for t, c in zip(parts, scale)])
    out = ordered_sum([t[..., 2:] * c[..., None] for t, c in zip(parts, scale)])
    return out / total[..., None]


def attend_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, q_offset: int,
                 k_offset: int, kv_valid: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Exact attention of q (B, Sq, H, Dh) over keys whose slots are split
    over ``axes`` of ``mesh``: this rank's k / v (B, S_loc, K, Dh) hold the
    slots from ``k_offset`` on (``kv_valid`` marks the live ones); each
    rank's partial is all-gathered and the ranks' combined in rank order,
    the same bits on every rank.  Returns (B, Sq, H, Dh) in q's dtype."""
    B, Sq, H, Dh = q.shape
    part = _partial(q, k, v, q_offset, k_offset, kv_valid)
    out = combine_partials(mesh.all_gather(part.contiguous(), axes, name="kv_combine"))
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dh).to(q.dtype)


def _select_kv(k: torch.Tensor, split: Optional[AttnSplit]) -> torch.Tensor:
    if split is None or split.kv_sel is None:
        return k
    lo, n = split.kv_sel
    return k[:, :, lo:lo + n]


def attention(params: Params, x: torch.Tensor, cfg: AttentionConfig, *,
              cos=None, sin=None, causal: bool = True,
              cache: Optional[KVCache] = None,
              split: Optional[AttnSplit] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Returns (y (B,S,D), the updated cache).  Without a cache: the train /
    prefill-from-zero path.  With one: S new tokens (1 to decode) at
    ``cache.pos``, attending over the cache.  ``split``: this rank's cut
    across ranks (``AttnSplit``); ``cfg`` then holds the rank's query heads
    and the KV heads it computes, and ``y`` is its partial sum where ``wo``
    is split (the caller adds it over ``model``)."""
    q, k, v = _qkv(params, x, cfg, cos, sin, split)
    S = q.shape[1]
    if cache is not None and cache.is_split:
        q_offset = cache.pos
        cache = cache.update(k, v)
        if S > 1:
            if q_offset:
                raise NotImplementedError("a chunked prefill into a cache whose slots are "
                                          "split over ranks")
            # the cache path's plain einsums, whatever ``impl`` is
            out = _attend_new(q, _select_kv(k, split), _select_kv(v, split),
                              dataclasses.replace(cfg, impl="xla"), causal)
        else:
            if split is None or not split.kv_axes:
                raise ValueError("a cache split over ranks needs the AttnSplit of its axes")
            mesh = split.plan.mesh
            qa = q
            if split.gather_q:
                qa = torch.cat(mesh.all_gather(q.contiguous(), "model", name="q_gather"), dim=2)
            out = attend_split(qa, cache.k.to(q.dtype), cache.v.to(q.dtype), q_offset=q_offset,
                               k_offset=cache.lo, kv_valid=cache.valid_mask(), mesh=mesh,
                               axes=split.kv_axes)
            if split.gather_q:
                H = q.shape[2]
                out = out[:, :, split.plan.tp_index * H:(split.plan.tp_index + 1) * H]
    elif cache is not None:
        q_offset = cache.pos
        cache = cache.update(k, v)
        k_all = _select_kv(cache.k, split).to(q.dtype)
        v_all = _select_kv(cache.v, split).to(q.dtype)
        kv_valid = cache.valid_mask()
        if S > cfg.xla_chunk_threshold and S % cfg.xla_chunk_q == 0:
            out = _attend_xla_chunked(q, k_all, v_all, causal=True, chunk=cfg.xla_chunk_q,
                                      q_offset=q_offset, kv_valid=kv_valid)
        else:
            out = _attend_xla(q, k_all, v_all, causal=True, q_offset=q_offset,
                              kv_valid=kv_valid)
    else:
        out = _attend_new(q, _select_kv(k, split), _select_kv(v, split), cfg, causal)
    B = x.shape[0]
    y = linear(params["wo"], out.reshape(B, S, cfg.n_heads * cfg.d_head), x.dtype)
    return y, cache


def _attend_new(q, k, v, cfg: AttentionConfig, causal: bool) -> torch.Tensor:
    """Attention over the call's own keys (no cache): the kernel or the
    plain einsum path by ``cfg.impl``."""
    S = q.shape[1]
    if cfg.impl == "flash":
        return fa_ops.flash_attention(q, k, v, causal=causal)
    if cfg.impl != "xla":
        raise ValueError(f"unknown attention impl {cfg.impl!r} (xla | flash)")
    if S > cfg.xla_chunk_threshold and S % cfg.xla_chunk_q == 0:
        return _attend_xla_chunked(q, k, v, causal=causal, chunk=cfg.xla_chunk_q)
    return _attend_xla(q, k, v, causal=causal)
