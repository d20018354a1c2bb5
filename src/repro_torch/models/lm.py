"""Decoder LM (counterpart of ``repro/models/lm.py``), four families:

  dense  : [RMSNorm -> GQA attention] + [RMSNorm -> MLP], n_layers times
  moe    : [RMSNorm -> GQA attention] + [RMSNorm -> MoE]  (``nn.moe``)
  ssm    : [RMSNorm -> Mamba2 SSD]                        (``nn.ssm``)
  hybrid : groups of ``attn_every`` mamba layers, each group followed by
           ONE SHARED transformer block (one set of weights called at every
           site, a KV cache per site), then ``n_layers % attn_every`` tail
           mamba layers

The input embedding is the paper's compressed embedding whenever
``cfg.embedding.kind != "dense"``: token ids -> packed codes -> codebook
decode (``hash_decode`` on the card) -> decoder MLP.  ``blocks`` (and
``tail``) hold each per-layer leaf stacked on a leading layer axis, as
``jax.vmap`` leaves them in the JAX package (the hybrid's ``blocks`` on
(groups, attn_every)), so ``interop.params_from_jax`` carries a JAX init
across unchanged; the forward unbinds the stack once, so the backward
stacks the layer gradients once.  ``init_lm`` draws each layer in turn
into the preallocated stack, so it never holds the layers twice.
``remat=True`` checkpoints each layer (``torch.utils.checkpoint``,
non-reentrant) as the JAX scan body is checkpointed, and the hybrid each
group with each of its layers inside; it applies only without a cache, as
in JAX.

``lm_forward(cache=)`` decodes (or prefills) at ``cache.pos`` against an
``LMCache``, whose buffers have the JAX package's stacked layout and are
written in place, one site or layer at a time: (sites, B, S_max, K, Dh)
keys and values, (ssm layers, B, H, N, P) f32 states and (ssm layers, B,
W-1, C) conv tails.  ``loss_vocab_chunk`` streams the head in vocabulary
chunks (``_chunked_ce``), so the (tokens, vocab) logits are never held.

The forward marks its stages (embed, blocks, head, loss) for
``stages.StageTimer``.  The audio and vlm families raise, naming their
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LM_SLICE, LMConfig
from repro_torch.core import embedding as emb_lib
from repro_torch.core import lsh
from repro_torch.core.backend import torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.attention import AttentionConfig, attention, init_attention
from repro_torch.nn.kvcache import KVCache, SSMCache
from repro_torch.nn.layers import init_mlp, init_norm, mlp, norm
from repro_torch.nn.module import Params, dense_init, map_tree
from repro_torch.nn.moe import MoEConfig, init_moe, moe_dense_ffn, moe_ffn_ep
from repro_torch.nn.rope import default_positions, rope_cos_sin
from repro_torch.nn.ssm import SSMConfig, init_ssm, ssm_forward
from repro_torch.stages import stage

NEG_INF = -1e30
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def attn_config(cfg: LMConfig) -> AttentionConfig:
    return AttentionConfig(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim, qkv_bias=cfg.qkv_bias, impl=cfg.attn_impl)


def moe_config(cfg: LMConfig) -> MoEConfig:
    return MoEConfig(
        d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
        top_k=cfg.moe_top_k, n_experts_padded=cfg.n_experts_padded,
        capacity_factor=cfg.moe_capacity_factor, act=cfg.act, impl=cfg.moe_impl)


def ssm_config(cfg: LMConfig) -> SSMConfig:
    return SSMConfig(
        d_model=cfg.d_model, d_state=cfg.ssm_state, headdim=cfg.ssm_headdim,
        expand=cfg.ssm_expand, chunk=cfg.ssm_chunk)


def _n_attn_sites(cfg: LMConfig) -> int:
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0


def _n_ssm_layers(cfg: LMConfig) -> int:
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def check_ported(cfg: LMConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.input_mode} input) is not ported "
            f"yet; it comes with {LM_SLICE}")


@dataclasses.dataclass
class LMCache:
    """Every attention site's KV buffers and every SSM layer's state, stacked
    as in the JAX package: ``kv_k`` / ``kv_v`` (sites, B, S_max, K, Dh);
    ``ssm_state`` (ssm layers, B, H, N, P) f32; ``conv`` (ssm layers, B,
    W-1, C); ``pos`` the next write index, a Python int."""
    pos: int
    kv_k: Optional[torch.Tensor] = None
    kv_v: Optional[torch.Tensor] = None
    ssm_state: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.kv_k, self.kv_v, self.ssm_state, self.conv)
                   if t is not None)

    def ssm_layer(self, i: int) -> SSMCache:
        return SSMCache(self.ssm_state[i], self.conv[i])

    def put_ssm_layer(self, i: int, layer: SSMCache) -> None:
        self.ssm_state[i].copy_(layer.state)
        self.conv[i].copy_(layer.conv)


def init_cache(cfg: LMConfig, batch: int, s_max: int, dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> LMCache:
    check_ported(cfg)
    dev = resolve_device(device)
    cache = LMCache(pos=0)
    sites, nssm = _n_attn_sites(cfg), _n_ssm_layers(cfg)
    if sites:
        shape = (sites, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
        cache.kv_k = torch.zeros(shape, dtype=dtype, device=dev)
        cache.kv_v = torch.zeros(shape, dtype=dtype, device=dev)
    if nssm:
        scfg = ssm_config(cfg)
        cache.ssm_state = torch.zeros(
            (nssm, batch, scfg.n_heads, scfg.d_state, scfg.headdim), device=dev)
        cache.conv = torch.zeros(
            (nssm, batch, scfg.conv_width - 1, scfg.conv_channels), dtype=dtype, device=dev)
    return cache


def init_attn_block(generator: torch.Generator, cfg: LMConfig) -> Params:
    p = {
        "norm1": init_norm(generator, cfg.d_model, cfg.norm),
        "attn": init_attention(generator, attn_config(cfg)),
        "norm2": init_norm(generator, cfg.d_model, cfg.norm),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(generator, moe_config(cfg))
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def attn_block(p: Params, x: torch.Tensor, cfg: LMConfig, cos, sin,
               kv: Optional[KVCache] = None) -> Tuple[torch.Tensor, Optional[KVCache]]:
    h, kv = attention(p["attn"], norm(p["norm1"], x, cfg.norm), attn_config(cfg),
                      cos=cos, sin=sin, cache=kv)
    x = x + h
    h2 = norm(p["norm2"], x, cfg.norm)
    if "moe" in p:
        B, S, D = h2.shape
        mcfg = moe_config(cfg)
        fn = moe_dense_ffn if mcfg.impl == "dense" else moe_ffn_ep
        y = fn(p["moe"], h2.reshape(B * S, D), mcfg).reshape(B, S, D)
    else:
        y = mlp(p["mlp"], h2, cfg.act)
    return x + y, kv


def init_ssm_block(generator: torch.Generator, cfg: LMConfig) -> Params:
    return {
        "norm1": init_norm(generator, cfg.d_model, cfg.norm),
        "ssm": init_ssm(generator, ssm_config(cfg)),
    }


def ssm_block(p: Params, x: torch.Tensor, cfg: LMConfig,
              cache: Optional[SSMCache] = None) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    h, cache = ssm_forward(p["ssm"], norm(p["norm1"], x, cfg.norm), ssm_config(cfg),
                           cache=cache)
    return x + h, cache


def _init_stacked(n: int, init_one: Callable[[], Params]) -> Params:
    """n layers drawn in turn by ``init_one``, each copied into its slot of
    leaves preallocated with a leading axis of n: the same bits as drawing
    all n and stacking them, holding one layer beside the stack, not n."""
    first = init_one()
    stacked = map_tree(lambda _, t: t.new_empty((n,) + tuple(t.shape)), first)

    def put(i, layer):
        map_tree(lambda _, dst, src: dst[i].copy_(src), stacked, layer)

    put(0, first)
    del first
    for i in range(1, n):
        put(i, init_one())
    return stacked


def _unstack(tree, n: int):
    """n per-layer dicts of views (one ``unbind`` per leaf, so autograd
    stacks the layer gradients once)."""
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
    }
    if cfg.family in ("dense", "moe"):
        params["blocks"] = _init_stacked(cfg.n_layers, lambda: init_attn_block(generator, cfg))
    elif cfg.family == "ssm":
        params["blocks"] = _init_stacked(cfg.n_layers, lambda: init_ssm_block(generator, cfg))
    else:                                   # hybrid
        groups, rem = divmod(cfg.n_layers, cfg.attn_every)
        flat = _init_stacked(groups * cfg.attn_every, lambda: init_ssm_block(generator, cfg))
        params["blocks"] = map_tree(
            lambda _, t: t.view((groups, cfg.attn_every) + tuple(t.shape[1:])), flat)
        params["shared"] = init_attn_block(generator, cfg)       # ONE shared block
        if rem:
            params["tail"] = _init_stacked(rem, lambda: init_ssm_block(generator, cfg))
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


def _layer(fn, cfg: LMConfig, *args):
    """One layer without a cache, checkpointed under ``cfg.remat``."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _attn_layer(lp, x, cfg, cos, sin):
    return attn_block(lp, x, cfg, cos, sin)[0]


def _ssm_layer(lp, x, cfg):
    return ssm_block(lp, x, cfg)[0]


def _hybrid_group(gp, shared, x, cfg, cos, sin):
    """One hybrid group without a cache: its mamba layers (each
    checkpointed under ``cfg.remat``: the group's checkpoint alone would
    keep all its layers' SSD internals live in its backward), then the
    shared block."""
    for lp in _unstack(gp, cfg.attn_every):
        x = _layer(_ssm_layer, cfg, lp, x, cfg)
    return attn_block(shared, x, cfg, cos, sin)[0]


def _ssm_layers_cached(layers, x, cfg, cache: LMCache, first: int):
    """SSM layers ``first``, ``first + 1``, ... against the cache's state,
    each layer's new state written back in place."""
    for i, lp in enumerate(layers):
        x, sc = ssm_block(lp, x, cfg, cache=cache.ssm_layer(first + i))
        cache.put_ssm_layer(first + i, sc)
    return x


def _blocks(params: Params, x: torch.Tensor, cfg: LMConfig, cos, sin,
            cache: Optional[LMCache]) -> torch.Tensor:
    """The family's layer stack; with a cache, its buffers are written."""
    if cfg.family in ("dense", "moe"):
        for i, lp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            if cache is None:
                x = _layer(_attn_layer, cfg, lp, x, cfg, cos, sin)
            else:
                x, _ = attn_block(lp, x, cfg, cos, sin,
                                  kv=KVCache(cache.kv_k[i], cache.kv_v[i], cache.pos))
    elif cfg.family == "ssm":
        layers = _unstack(params["blocks"], cfg.n_layers)
        if cache is None:
            for lp in layers:
                x = _layer(_ssm_layer, cfg, lp, x, cfg)
        else:
            x = _ssm_layers_cached(layers, x, cfg, cache, 0)
    else:                                   # hybrid
        every = cfg.attn_every
        groups, rem = divmod(cfg.n_layers, every)
        shared = params["shared"]
        for g, gp in enumerate(_unstack(params["blocks"], groups)):
            if cache is None:
                x = _layer(_hybrid_group, cfg, gp, shared, x, cfg, cos, sin)
            else:
                x = _ssm_layers_cached(_unstack(gp, every), x, cfg, cache, g * every)
                x, _ = attn_block(shared, x, cfg, cos, sin,
                                  kv=KVCache(cache.kv_k[g], cache.kv_v[g], cache.pos))
        if rem:
            tail = _unstack(params["tail"], rem)
            if cache is None:
                for lp in tail:
                    x = _layer(_ssm_layer, cfg, lp, x, cfg)
            else:
                x = _ssm_layers_cached(tail, x, cfg, cache, groups * every)
    return x


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
    with stage("blocks"):
        x = _blocks(params, x, cfg, cos, sin, cache)
    new_cache = None if cache is None else dataclasses.replace(cache, pos=cache.pos + S)
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
