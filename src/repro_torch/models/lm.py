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
checkpointed; it applies only without a cache, as in JAX.

``lm_forward(cache=)`` decodes (or prefills) at ``cache.pos`` against an
``LMCache``, whose (sites, B, S_max, K, Dh) buffers have the JAX package's
stacked layout and are written in place, one site a layer.
``loss_vocab_chunk`` streams the head in vocabulary chunks
(``_chunked_ce``), so the (tokens, vocab) logits are never held.

The forward marks its stages (embed, blocks, head, loss) for
``stages.StageTimer``.  The moe, ssm, hybrid, audio and vlm families raise,
naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LM_SLICE, LMConfig
from repro_torch.core import embedding as emb_lib
from repro_torch.core import lsh
from repro_torch.core.backend import torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.attention import AttentionConfig, attention, init_attention
from repro_torch.nn.kvcache import KVCache
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


@dataclasses.dataclass
class LMCache:
    """Every attention site's KV buffers, stacked as in the JAX package:
    ``kv_k`` / ``kv_v`` (sites, B, S_max, K, Dh); ``pos`` the next write
    index, a Python int.  The ssm fields come with the ssm family."""
    pos: int
    kv_k: Optional[torch.Tensor] = None
    kv_v: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.kv_k, self.kv_v)
                   if t is not None)


def init_cache(cfg: LMConfig, batch: int, s_max: int, dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> LMCache:
    check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    return LMCache(pos=0, kv_k=torch.zeros(shape, dtype=dtype, device=dev),
                   kv_v=torch.zeros(shape, dtype=dtype, device=dev))


def init_attn_block(generator: torch.Generator, cfg: LMConfig) -> Params:
    return {
        "norm1": init_norm(generator, cfg.d_model, cfg.norm),
        "attn": init_attention(generator, attn_config(cfg)),
        "norm2": init_norm(generator, cfg.d_model, cfg.norm),
        "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act),
    }


def attn_block(p: Params, x: torch.Tensor, cfg: LMConfig, cos, sin,
               kv: Optional[KVCache] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    h, kv = attention(p["attn"], norm(p["norm1"], x, cfg.norm), attn_config(cfg),
                      cos=cos, sin=sin, cache=kv)
    x = x + h
    return x + mlp(p["mlp"], norm(p["norm2"], x, cfg.norm), cfg.act), kv


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


def lm_forward(params: Params, tokens: torch.Tensor, cfg: LMConfig,
               cache: Optional[LMCache] = None, positions: Optional[torch.Tensor] = None,
               return_hidden: bool = False) -> Tuple[torch.Tensor, Optional[LMCache]]:
    """tokens (B, S) int -> (logits (B, S, Vpad) f32, cache).

    ``cache=None``: train / prefill from zero, causal over S.  With a
    cache: decode or chunked prefill at ``cache.pos``; the cache's buffers
    are written in place and the returned cache has ``pos`` advanced by S.
    ``return_hidden``: the final-norm hidden states (B, S, D) in place of
    the logits."""
    check_ported(cfg)
    B, S = tokens.shape[:2]
    offset = cache.pos if cache is not None else 0
    if positions is None:
        positions = default_positions(B, S, cfg.rope_variant, tokens.device) + offset
    cos, sin = _rope(cfg, positions)
    with stage("embed"):
        x = _embed_tokens(params, tokens, cfg, positions)
    new_cache = None
    with stage("blocks"):
        layers = _unstack(params["blocks"], cfg.n_layers)
        if cache is None:
            for lp in layers:
                if cfg.remat:
                    x, _ = checkpoint(attn_block, lp, x, cfg, cos, sin, use_reentrant=False)
                else:
                    x, _ = attn_block(lp, x, cfg, cos, sin)
        else:
            for i, lp in enumerate(layers):
                x, _ = attn_block(lp, x, cfg, cos, sin,
                                  kv=KVCache(cache.kv_k[i], cache.kv_v[i], cache.pos))
            new_cache = LMCache(pos=cache.pos + S, kv_k=cache.kv_k, kv_v=cache.kv_v)
    with stage("head"):
        x = norm(params["final_norm"], x, cfg.norm)
        if return_hidden:
            return x, new_cache
        logits = (x @ params["head"].to(x.dtype)).float()
    return logits, new_cache


def _ce_chunk(xf: torch.Tensor, head_c: torch.Tensor, lab: torch.Tensor,
              m_prev: torch.Tensor, s_prev: torch.Tensor, gold_prev: torch.Tensor,
              lo: int, vocab_size: int):
    """One vocabulary chunk [lo, lo + chunk) of ``_chunked_ce``: its logits,
    the pad columns masked, folded into the running max, sum of
    exponentials and gold logit."""
    chunk = head_c.shape[1]
    logits = (xf @ head_c.to(xf.dtype)).float()                    # (T, chunk)
    if lo + chunk > vocab_size:
        col = torch.arange(lo, lo + chunk, device=logits.device)
        logits = logits.masked_fill(col >= vocab_size, NEG_INF)
    m_new = torch.maximum(m_prev, torch.amax(logits, dim=-1))
    s_new = (s_prev * torch.exp(m_prev - m_new)
             + torch.exp(logits - m_new[:, None]).sum(dim=-1))
    in_chunk = (lab >= lo) & (lab < lo + chunk)
    local = (lab - lo).clamp(0, chunk - 1)
    gold_c = torch.gather(logits, 1, local[:, None])[:, 0]
    return m_new, s_new, torch.where(in_chunk, gold_c, gold_prev)


def _chunked_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                cfg: LMConfig) -> torch.Tensor:
    """Cross-entropy without the (B, S, Vpad) logits: the head product in
    ``loss_vocab_chunk`` columns, carrying the running (max, sum of
    exponentials, gold logit), as the JAX package's scan does.  Each chunk
    is checkpointed (non-reentrant), so its (T, chunk) logits are
    recomputed in the backward, not kept.  The pad columns fall in the
    final chunk and are masked there."""
    chunk = cfg.loss_vocab_chunk
    assert cfg.vocab_padded % chunk == 0
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    lab = labels.reshape(B * S).to(torch.int64)
    m = torch.full((B * S,), NEG_INF, dtype=torch.float32, device=x.device)
    s_sum = torch.zeros(B * S, dtype=torch.float32, device=x.device)
    gold = torch.zeros(B * S, dtype=torch.float32, device=x.device)
    for i, head_c in enumerate(head.split(chunk, dim=1)):
        m, s_sum, gold = checkpoint(_ce_chunk, xf, head_c, lab, m, s_sum, gold,
                                    i * chunk, cfg.vocab_size, use_reentrant=False)
    return (m + torch.log(s_sum) - gold).mean()


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig) -> torch.Tensor:
    """Next-token cross-entropy; the vocabulary padding is masked out of the
    softmax at -1e30.  With ``loss_vocab_chunk`` dividing the padded
    vocabulary, the chunked form (``_chunked_ce``)."""
    if cfg.loss_vocab_chunk and cfg.vocab_padded % cfg.loss_vocab_chunk == 0:
        x, _ = lm_forward(params, batch["tokens"], cfg, positions=batch.get("positions"),
                          return_hidden=True)
        with stage("loss"):
            return _chunked_ce(x, params["head"], batch["labels"], cfg)
    logits, _ = lm_forward(params, batch["tokens"], cfg,
                           positions=batch.get("positions"))
    with stage("loss"):
        if cfg.vocab_size != cfg.vocab_padded:
            pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab_size
            logits = logits.masked_fill(pad, NEG_INF)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, batch["labels"].to(torch.int64)[..., None])[..., 0]
        return (logz - gold).mean()
