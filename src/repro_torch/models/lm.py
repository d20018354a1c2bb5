"""Decoder LM (counterpart of ``repro/models/lm.py``), six families:

  dense  : [RMSNorm -> GQA attention] + [RMSNorm -> MLP], n_layers times
  audio  : dense blocks over the sum of ``n_codebooks`` token streams'
           embeddings, (B, S, nq) ids -> (B, S, nq, Vpad) logits (musicgen)
  vlm    : dense blocks under M-RoPE, (3, B, S) positions (qwen2-vl)
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

Across ranks (``train.step.make_train_step(mesh=...)``), ``lm_loss`` runs
under the ``parallel.tensor.ShardPlan`` that ``use_plan`` made active, and
passes it down explicitly: each layer's params are its blocks, gathered on
their FSDP dim inside the (checkpointed) layer; under tensor parallelism
attention runs on the rank's heads (``wo``'s partial sums added over
``model``), the MLP on its slice of ``d_ff``, the MoE on its experts (EP),
a dense table looks up its slice of the vocabulary, and the loss takes a
vocab-parallel log-sum-exp.  The hash embedding's codes, codebooks and
decoder are whole on every rank: each rank decodes its own tokens.

The forward marks its stages (embed, blocks, head, loss) for
``stages.StageTimer``.
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.core import embedding as emb_lib
from repro_torch.core import lsh
from repro_torch.core.backend import torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.nn.attention import AttentionConfig, AttnSplit, attention, init_attention
from repro_torch.nn.kvcache import KVCache, SSMCache
from repro_torch.nn.layers import init_mlp, init_norm, mlp, norm
from repro_torch.nn.module import Params, dense_init, map_tree
from repro_torch.nn.moe import MoEConfig, init_moe, moe_dense_ffn, moe_ffn_ep
from repro_torch.nn.rope import default_positions, rope_cos_sin
from repro_torch.nn.ssm import SSMConfig, init_ssm, ssm_forward
from repro_torch.parallel.tensor import active_plan, layer_specs, ordered_sum
from repro_torch.stages import stage

NEG_INF = -1e30
ATTN_FAMILIES = ("dense", "moe", "audio", "vlm")      # a stack of attention blocks


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
    if cfg.family in ATTN_FAMILIES:
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0


def _n_ssm_layers(cfg: LMConfig) -> int:
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


@dataclasses.dataclass
class LMCache:
    """Every attention site's KV buffers and every SSM layer's state, stacked
    as in the JAX package: ``kv_k`` / ``kv_v`` (sites, B, S_max, K, Dh);
    ``ssm_state`` (ssm layers, B, H, N, P) f32; ``conv`` (ssm layers, B,
    W-1, C); ``pos`` the next write index, a Python int.  Across ranks
    (``init_cache(mesh=)``) the buffers are the rank's blocks under
    ``policy.cache_shardings_policy`` and ``kv_seq`` names the mesh axes
    the KV slots are split over (() where each rank holds all of them)."""
    pos: int
    kv_k: Optional[torch.Tensor] = None
    kv_v: Optional[torch.Tensor] = None
    ssm_state: Optional[torch.Tensor] = None
    conv: Optional[torch.Tensor] = None
    kv_seq: Tuple[str, ...] = ()

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.kv_k, self.kv_v, self.ssm_state, self.conv)
                   if t is not None)

    def kv_site(self, i: int, mesh=None) -> KVCache:
        """Site ``i``'s ``KVCache`` (views of the stacked buffers): on a
        rank whose slots are a block over ``kv_seq``, with its first
        slot's global index and the global length."""
        if not self.kv_seq:
            return KVCache(self.kv_k[i], self.kv_v[i], self.pos)
        held = self.kv_k.shape[2]
        return KVCache(self.kv_k[i], self.kv_v[i], self.pos, lo=mesh.index(self.kv_seq) * held,
                       s_max=held * mesh.axes_size(self.kv_seq))

    def ssm_layer(self, i: int) -> SSMCache:
        return SSMCache(self.ssm_state[i], self.conv[i])

    def put_ssm_layer(self, i: int, layer: SSMCache) -> None:
        self.ssm_state[i].copy_(layer.state)
        self.conv[i].copy_(layer.conv)


def _cache_shapes(cfg: LMConfig, batch: int, s_max: int) -> Dict[str, Tuple[int, ...]]:
    """The whole cache's buffer shapes, by ``LMCache`` field."""
    out = {}
    sites, nssm = _n_attn_sites(cfg), _n_ssm_layers(cfg)
    if sites:
        out["kv_k"] = out["kv_v"] = (sites, batch, s_max, cfg.n_kv_heads, cfg.head_dim)
    if nssm:
        scfg = ssm_config(cfg)
        out["ssm_state"] = (nssm, batch, scfg.n_heads, scfg.d_state, scfg.headdim)
        out["conv"] = (nssm, batch, scfg.conv_width - 1, scfg.conv_channels)
    return out


def init_cache(cfg: LMConfig, batch: int, s_max: int, dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None, mesh=None, strategy=None) -> LMCache:
    """A zero cache for ``batch`` rows of ``s_max`` slots (the SSM states in
    f32); with ``mesh`` (and ``strategy``) this rank's blocks of it under
    ``policy.cache_shardings_policy``."""
    dev = resolve_device(device) if mesh is None else torch.device(device or mesh.device)
    shapes = _cache_shapes(cfg, batch, s_max)
    specs = {}
    if mesh is not None:
        from repro_torch.parallel import policy
        from repro_torch.parallel.sharding import _axes_tuple, shard_shape
        whole = LMCache(pos=0, **{k: types.SimpleNamespace(shape=v) for k, v in shapes.items()})
        sp = policy.cache_shardings_policy(cfg, whole, mesh,
                                           strategy or policy.DEFAULT_STRATEGY)
        specs = {k: getattr(sp, k) for k in shapes}
        shapes = {k: shard_shape(v, specs[k], mesh) for k, v in shapes.items()}
    cache = LMCache(pos=0)
    for name, shape in shapes.items():
        setattr(cache, name, torch.zeros(
            shape, dtype=torch.float32 if name == "ssm_state" else dtype, device=dev))
    if "kv_k" in specs:
        cache.kv_seq = tuple(a for a in _axes_tuple(specs["kv_k"][2]) if mesh.shape[a] > 1)
    return cache


def cache_shardings(cfg: LMConfig, batch: int, s_max: int, dtype: torch.dtype = torch.bfloat16):
    """Every cache buffer's spec from its logical axes under the active
    mesh and rules (an ``LMCache`` of specs; None without a mesh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.parallel.sharding import logical_sharding
    with FakeTensorMode():
        cache = init_cache(cfg, batch, s_max, dtype, device="cpu")
    names = {
        "kv": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
        "ssm": (None, "batch", "ssm_heads", "ssm_state", None),
        "conv": (None, "batch", None, "d_ff"),
    }

    def shard_of(buf, kind):
        return None if buf is None else logical_sharding(tuple(buf.shape), *names[kind])

    return LMCache(pos=None, kv_k=shard_of(cache.kv_k, "kv"), kv_v=shard_of(cache.kv_v, "kv"),
                   ssm_state=shard_of(cache.ssm_state, "ssm"), conv=shard_of(cache.conv, "conv"))


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


def _tp_attention(p: Params, acfg: AttentionConfig, plan, kv_axes=()):
    """(params, config, ``AttnSplit``) of the rank's heads: its columns of
    wq / wk / wv and rows of wo are its blocks already; a replicated bias
    of a split projection is cut to them.  Where the query heads split and
    the KV heads stay whole (they do not divide the model axis), the rank
    computes every KV head and attends with those its query heads read."""
    Dh = acfg.d_head
    H_loc = p["wq"]["w"].shape[-1] // Dh
    K_loc = p["wk"]["w"].shape[-1] // Dh
    q_split, kv_split = H_loc != acfg.n_heads, K_loc != acfg.n_kv_heads
    if kv_split and not q_split:
        raise NotImplementedError(f"kv heads split over the model axis with all "
                                  f"{acfg.n_heads} query heads whole")
    kv_sel = None
    if q_split and not kv_split:
        g = acfg.n_heads // acfg.n_kv_heads
        first = plan.tp_index * H_loc
        if H_loc % g == 0:
            kv_sel = (first // g, H_loc // g)
        elif g % H_loc == 0:
            kv_sel = (first // g, 1)
        else:
            raise NotImplementedError(f"{H_loc} query heads a rank straddle the groups of "
                                      f"{g} that share a KV head")
    out = {}
    for name, sub in p.items():
        out[name] = dict(sub)
        if "b" in sub and name != "wo" and sub["b"].shape[-1] != sub["w"].shape[-1]:
            out[name]["b"] = plan.split(sub["b"], dim=-1)
    split = AttnSplit(plan=plan, q_split=q_split, kv_split=kv_split, kv_sel=kv_sel,
                      kv_axes=tuple(kv_axes))
    return out, dataclasses.replace(acfg, n_heads=H_loc, n_kv_heads=K_loc), split


def _tp_mlp(p: Params, x: torch.Tensor, act: str, plan) -> torch.Tensor:
    """The MLP on the rank's slice of d_ff (column-parallel in, row-parallel
    out, the partial sums added over ``model``)."""
    dt = x.dtype
    x = plan.enter(x)
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return plan.exit(h @ p["w_down"].to(dt))
    h = F.gelu(x @ p["w_up"].to(dt) + plan.split(p["b_up"], -1).to(dt), approximate="tanh")
    return plan.exit(h @ p["w_down"].to(dt)) + p["b_down"].to(dt)


def attn_block(p: Params, x: torch.Tensor, cfg: LMConfig, cos, sin,
               kv: Optional[KVCache] = None, plan=None,
               kv_axes=()) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """One attention block; ``plan``: its params are this rank's (gathered)
    blocks under that ``ShardPlan``; ``kv_axes``: the mesh axes ``kv``'s
    slots are split over."""
    acfg = attn_config(cfg)
    h = norm(p["norm1"], x, cfg.norm)
    if plan is None:
        h, kv = attention(p["attn"], h, acfg, cos=cos, sin=sin, cache=kv)
    else:
        pa, acfg_local, split = _tp_attention(p["attn"], acfg, plan, kv_axes)
        h, kv = attention(pa, h, acfg_local, cos=cos, sin=sin, cache=kv, split=split)
        if split.q_split:
            h = plan.exit(h)
    x = x + h
    h2 = norm(p["norm2"], x, cfg.norm)
    if "moe" in p:
        B, S, D = h2.shape
        mcfg = moe_config(cfg)
        if mcfg.impl == "dense":
            y = moe_dense_ffn(p["moe"], h2.reshape(B * S, D), mcfg)
        else:
            y = moe_ffn_ep(p["moe"], h2.reshape(B * S, D), mcfg, plan=plan)
        y = y.reshape(B, S, D)
    elif plan is not None and p["mlp"]["w_down"].shape[-2] != cfg.d_ff:
        y = _tp_mlp(p["mlp"], h2, cfg.act, plan)
    else:
        y = mlp(p["mlp"], h2, cfg.act)
    return x + y, kv


def init_ssm_block(generator: torch.Generator, cfg: LMConfig) -> Params:
    return {
        "norm1": init_norm(generator, cfg.d_model, cfg.norm),
        "ssm": init_ssm(generator, ssm_config(cfg)),
    }


def ssm_block(p: Params, x: torch.Tensor, cfg: LMConfig, cache: Optional[SSMCache] = None,
              plan=None) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """One Mamba2 block; ``plan``: its params are this rank's (gathered)
    blocks, its heads split over ``model`` where the plan's specs split
    them."""
    h, cache = ssm_forward(p["ssm"], norm(p["norm1"], x, cfg.norm), ssm_config(cfg),
                           cache=cache, plan=plan)
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


def _n_streams(cfg: LMConfig) -> int:
    """Token streams a position: the audio family's codebooks, else 1."""
    return cfg.n_codebooks if cfg.input_mode == "audio_tokens" else 1


def _table_config(cfg: LMConfig) -> emb_lib.EmbeddingConfig:
    """The embedding over every stream's vocabulary: the audio family's
    codebook ``q`` holds rows ``q * vocab_padded`` onward."""
    ecfg = cfg.embedding_config()
    return dataclasses.replace(ecfg, n_entities=ecfg.n_entities * _n_streams(cfg))


def init_lm(generator: torch.Generator, cfg: LMConfig,
            codes: Optional[torch.Tensor] = None, aux=None, keep=None) -> Params:
    """``codes``: packed vocabulary codes (from the co-occurrence pass and
    Algorithm 1); ``aux``: the auxiliary matrix to encode from.  With
    neither, random codes (ALONE), as in the JAX package.  Codes with fewer
    rows than the table (the audio family's one vocabulary for its
    codebooks) are tiled to it.  ``keep(path, tensor, stacked)``: the part
    of each drawn leaf to store (a rank's block; ``stacked`` for one layer
    of a stacked leaf): every leaf is drawn whole from ``generator``, in
    the one-rank order, and only that part kept."""
    if keep is None:
        keep = lambda _, t, stacked: t     # noqa: E731

    def top(prefix):
        return lambda path, t: keep(prefix + path, t, False)

    def layer(prefix, draw, stacked=True):
        """One layer drawn whole, each leaf cut by ``keep``."""
        return lambda: map_tree(lambda path, t: keep(prefix + path, t, stacked), draw())
    ecfg, tcfg = cfg.embedding_config(), _table_config(cfg)
    if ecfg.needs_codes and codes is None and aux is None:
        codes = lsh.encode_random(generator, ecfg.n_entities, ecfg.c, ecfg.m)
    if codes is not None and ecfg.needs_codes and codes.shape[0] != tcfg.n_entities:
        reps = -(-tcfg.n_entities // codes.shape[0])
        codes = codes.repeat(reps, 1)[:tcfg.n_entities]
    params: Params = {
        "embed": map_tree(top(("embed",)),
                          emb_lib.init_embedding(generator, tcfg, codes=codes, aux=aux)),
        "final_norm": map_tree(top(("final_norm",)),
                               init_norm(generator, cfg.d_model, cfg.norm)),
        "head": keep(("head",), dense_init(
            generator, (cfg.d_model, cfg.vocab_padded * _n_streams(cfg))), False),
    }
    attn_layer = layer(("blocks",), lambda: init_attn_block(generator, cfg))
    ssm_layer = layer(("blocks",), lambda: init_ssm_block(generator, cfg))
    if cfg.family in ATTN_FAMILIES:
        params["blocks"] = _init_stacked(cfg.n_layers, attn_layer)
    elif cfg.family == "ssm":
        params["blocks"] = _init_stacked(cfg.n_layers, ssm_layer)
    elif cfg.family == "hybrid":
        groups, rem = divmod(cfg.n_layers, cfg.attn_every)
        flat = _init_stacked(groups * cfg.attn_every,
                             layer(("blocks",), lambda: init_ssm_block(generator, cfg), "hybrid"))
        params["blocks"] = map_tree(
            lambda _, t: t.view((groups, cfg.attn_every) + tuple(t.shape[1:])), flat)
        params["shared"] = map_tree(top(("shared",)), init_attn_block(generator, cfg))
        if rem:
            params["tail"] = _init_stacked(
                rem, layer(("tail",), lambda: init_ssm_block(generator, cfg)))
    else:
        raise ValueError(cfg.family)
    return params


def _sinusoidal_pe(positions: torch.Tensor, d: int, dtype) -> torch.Tensor:
    half = d // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32, device=positions.device)
                     * (math.log(10000.0) / half))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _vocab_parallel_lookup(table: torch.Tensor, ids: torch.Tensor, dtype, plan) -> torch.Tensor:
    """A dense table's rows when each model rank holds a slice of the
    vocabulary: the rank's rows looked up, the others zero, the slices'
    rows added over ``model``."""
    from repro_torch.core.embedding import table_rows
    rows = table.shape[0]
    local = ids - plan.tp_index * rows
    mine = (local >= 0) & (local < rows)
    x = table_rows(table.to(dtype), local.clamp(0, rows - 1)) * mine[..., None].to(dtype)
    return plan.exit(x)


def _embed_tokens(params: Params, tokens: torch.Tensor, cfg: LMConfig,
                  positions: torch.Tensor, plan=None) -> torch.Tensor:
    """Decode in f32 (the backend's sum), MLP tail and output in the compute
    dtype.  Audio ids (B, S, nq) are offset by ``codebook * vocab_padded``,
    looked up in one call and summed over the codebooks."""
    dtype = torch_dtype(cfg.compute_dtype)
    if plan is not None:
        params = {"embed": plan.view_tree(params["embed"], plan.specs["embed"])}
        table = params["embed"].get("table")
        if table is not None and table.shape[0] != _table_config(cfg).n_entities:
            edtype = torch_dtype(cfg.embedding_config().compute_dtype)
            if cfg.input_mode == "audio_tokens":
                x = _vocab_parallel_lookup(table, tokens + _audio_offsets(cfg, tokens),
                                           edtype, plan).sum(dim=2)
            else:
                x = _vocab_parallel_lookup(table, tokens, edtype, plan)
            return _add_positions(x.to(dtype), cfg, positions, dtype)
        # each rank decodes its own tokens: outside the mesh, which the
        # GNN's frontier decode backends would read as one stacked frontier
        from repro_torch.parallel.sharding import use_sharding
        with use_sharding(None):
            return _embed_tokens(params, tokens, cfg, positions)
    if cfg.input_mode == "audio_tokens":
        x = emb_lib.embed_lookup(params["embed"], tokens + _audio_offsets(cfg, tokens),
                                 _table_config(cfg)).sum(dim=2)
    else:
        x = emb_lib.embed_lookup(params["embed"], tokens, cfg.embedding_config())
    return _add_positions(x.to(dtype), cfg, positions, dtype)


def _audio_offsets(cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Codebook q's ids start at row ``q * vocab_padded`` of the table."""
    return torch.arange(tokens.shape[2], dtype=tokens.dtype,
                        device=tokens.device) * cfg.vocab_padded


def _add_positions(x, cfg: LMConfig, positions, dtype):
    if cfg.rope_variant == "none":
        pos = positions if positions.dim() == 2 else positions[0]
        x = x + _sinusoidal_pe(pos, cfg.d_model, dtype)
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


def _viewed(lp, plan, lspec):
    """A layer's params as it computes with them: under a plan, its blocks
    gathered on their FSDP dim (inside the checkpoint, so the recompute
    gathers them again rather than keeping them)."""
    return lp if plan is None else plan.view_tree(lp, lspec)


def _attn_layer(lp, x, cfg, cos, sin, plan=None, lspec=None):
    return attn_block(_viewed(lp, plan, lspec), x, cfg, cos, sin, plan=plan)[0]


def _ssm_layer(lp, x, cfg, plan=None, lspec=None):
    return ssm_block(_viewed(lp, plan, lspec), x, cfg, plan=plan)[0]


def _hybrid_group(gp, shared, x, cfg, cos, sin, plan=None, gspec=None, sspec=None):
    """One hybrid group without a cache: its mamba layers (each
    checkpointed under ``cfg.remat``: the group's checkpoint alone would
    keep all its layers' SSD internals live in its backward), then the
    shared block."""
    lspec = layer_specs(gspec) if plan is not None else None
    for lp in _unstack(gp, cfg.attn_every):
        x = _layer(_ssm_layer, cfg, lp, x, cfg, plan, lspec)
    return attn_block(_viewed(shared, plan, sspec), x, cfg, cos, sin, plan=plan)[0]


def _ssm_layers_cached(layers, x, cfg, cache: LMCache, first: int, plan=None, lspec=None):
    """SSM layers ``first``, ``first + 1``, ... against the cache's state,
    each layer's new state written back in place."""
    for i, lp in enumerate(layers):
        x, sc = ssm_block(_viewed(lp, plan, lspec), x, cfg, cache=cache.ssm_layer(first + i),
                          plan=plan)
        cache.put_ssm_layer(first + i, sc)
    return x


def _attn_cached(lp, x, cfg, cos, sin, cache: LMCache, site: int, plan=None, lspec=None):
    """One attention block against site ``site`` of the cache."""
    mesh = plan.mesh if plan is not None else None
    return attn_block(_viewed(lp, plan, lspec), x, cfg, cos, sin,
                      kv=cache.kv_site(site, mesh), plan=plan, kv_axes=cache.kv_seq)[0]


def _blocks(params: Params, x: torch.Tensor, cfg: LMConfig, cos, sin,
            cache: Optional[LMCache], plan=None) -> torch.Tensor:
    """The family's layer stack; with a cache, its buffers are written.
    ``plan``: the params are this rank's blocks (and the cache's buffers,
    under ``init_cache(mesh=)``)."""
    specs, lspec = {}, None
    if plan is not None:
        specs, lspec = plan.specs, layer_specs(plan.specs["blocks"])
    if cfg.family in ATTN_FAMILIES:
        for i, lp in enumerate(_unstack(params["blocks"], cfg.n_layers)):
            if cache is None:
                x = _layer(_attn_layer, cfg, lp, x, cfg, cos, sin, plan, lspec)
            else:
                x = _attn_cached(lp, x, cfg, cos, sin, cache, i, plan, lspec)
    elif cfg.family == "ssm":
        layers = _unstack(params["blocks"], cfg.n_layers)
        if cache is None:
            for lp in layers:
                x = _layer(_ssm_layer, cfg, lp, x, cfg, plan, lspec)
        else:
            x = _ssm_layers_cached(layers, x, cfg, cache, 0, plan, lspec)
    else:                                   # hybrid
        every = cfg.attn_every
        groups, rem = divmod(cfg.n_layers, every)
        shared = params["shared"]
        gspec = layer_specs(lspec) if plan is not None else None
        for g, gp in enumerate(_unstack(params["blocks"], groups)):
            if cache is None:
                x = _layer(_hybrid_group, cfg, gp, shared, x, cfg, cos, sin, plan,
                           lspec, specs.get("shared"))
            else:
                x = _ssm_layers_cached(_unstack(gp, every), x, cfg, cache, g * every, plan, gspec)
                x = _attn_cached(shared, x, cfg, cos, sin, cache, g, plan, specs.get("shared"))
        if rem:
            tail = _unstack(params["tail"], rem)
            tspec = layer_specs(specs["tail"]) if plan is not None else None
            if cache is None:
                for lp in tail:
                    x = _layer(_ssm_layer, cfg, lp, x, cfg, plan, tspec)
            else:
                x = _ssm_layers_cached(tail, x, cfg, cache, groups * every, plan, tspec)
    return x


def lm_forward(params: Params, tokens: torch.Tensor, cfg: LMConfig,
               cache: Optional[LMCache] = None, positions: Optional[torch.Tensor] = None,
               return_hidden: bool = False, plan=None) -> Tuple[torch.Tensor, Optional[LMCache]]:
    """tokens (B, S) int, audio (B, S, nq) -> (logits (B, S, Vpad) f32,
    audio (B, S, nq, Vpad); cache).

    ``cache=None``: train / prefill from zero, causal over S.  With a
    cache: decode or chunked prefill at ``cache.pos``; the cache's buffers
    are written in place and the returned cache has ``pos`` advanced by S.
    ``return_hidden``: the final-norm hidden states (B, S, D) in place of
    the logits.  ``plan``: ``params`` are this rank's blocks and ``tokens``
    its rows (a ``parallel.tensor.ShardPlan``; with a cache, its blocks
    from ``init_cache(mesh=)``); a vocab-parallel head's logits are
    stacked over ``model``, the same bits on every model rank."""
    B, S = tokens.shape[:2]
    offset = cache.pos if cache is not None else 0
    if positions is None:
        positions = default_positions(B, S, cfg.rope_variant, tokens.device) + offset
    cos, sin = _rope(cfg, positions)
    with stage("embed"):
        x = _embed_tokens(params, tokens, cfg, positions, plan)
    with stage("blocks"):
        x = _blocks(params, x, cfg, cos, sin, cache, plan)
    new_cache = None if cache is None else dataclasses.replace(cache, pos=cache.pos + S)
    with stage("head"):
        final_norm = params["final_norm"]
        if plan is not None:
            final_norm = plan.view_tree(final_norm, plan.specs["final_norm"])
        x = norm(final_norm, x, cfg.norm)
        if return_hidden:
            return x, new_cache
        logits = lm_logits(params, x, cfg, plan)
    return logits, new_cache


def lm_logits(params: Params, x: torch.Tensor, cfg: LMConfig, plan=None) -> torch.Tensor:
    """The head over final-norm hidden states x (B, S, D): f32 (B, S, Vpad),
    audio (B, S, nq, Vpad).  Under a plan whose head is vocab-parallel, the
    model ranks' column blocks stacked (``plan.stack``) and put side by
    side."""
    B, S = x.shape[:2]
    head = _head(params, cfg, plan, x.dtype)
    logits = (x @ head.to(x.dtype)).float()
    if head.shape[1] != _head_cols(cfg):
        logits = torch.cat(plan.stack(logits).unbind(0), dim=-1)
    if cfg.input_mode == "audio_tokens":
        logits = logits.reshape(B, S, cfg.n_codebooks, cfg.vocab_padded)
    return logits


def _head_cols(cfg: LMConfig) -> int:
    return cfg.vocab_padded * _n_streams(cfg)


def _head(params: Params, cfg: LMConfig, plan, dtype) -> torch.Tensor:
    """The head as the rank computes with it (its vocabulary slice under a
    vocab-parallel plan)."""
    if plan is None:
        return params["head"]
    return plan.view(params["head"], plan.specs["head"], dtype)


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


def _vocab_parallel_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                       cfg: LMConfig, plan) -> torch.Tensor:
    """Cross-entropy when each model rank holds a block of the head's
    columns: for each token stream (audio's codebooks; text has one) whose
    vocabulary meets the block, each rank folds its columns (in
    ``loss_vocab_chunk`` columns where they divide them, each chunk
    checkpointed) into a running max, sum of exponentials and gold logit
    (zero off the label's owner; a stream the block misses keeps -1e30, 0,
    0), the model ranks' statistics are stacked, and each stream's
    log-sum-exp takes the max over them, then the sum of their
    exponentials, in rank order."""
    B, S, D = x.shape
    T = B * S
    nq, vp = _n_streams(cfg), cfg.vocab_padded
    xf = plan.enter(x.reshape(T, D))
    lab = labels.reshape(T, nq).to(torch.int64)
    cols = head.shape[1]
    base = plan.tp_index * cols
    stats = []
    for q in range(nq):
        m = torch.full((T,), NEG_INF, dtype=torch.float32, device=x.device)
        s_sum = torch.zeros(T, dtype=torch.float32, device=x.device)
        gold = torch.zeros(T, dtype=torch.float32, device=x.device)
        lo, hi = max(base, q * vp), min(base + cols, (q + 1) * vp)
        if lo < hi:
            width = hi - lo
            chunk = cfg.loss_vocab_chunk if (nq == 1 and cfg.loss_vocab_chunk
                                             and width % cfg.loss_vocab_chunk == 0) else width
            for i, head_c in enumerate(head[:, lo - base:hi - base].split(chunk, dim=1)):
                m, s_sum, gold = checkpoint(_ce_chunk, xf, head_c, lab[:, q], m, s_sum, gold,
                                            lo - q * vp + i * chunk, cfg.vocab_size,
                                            use_reentrant=False)
        stats.append(torch.stack([m, s_sum, gold]))
    st = plan.stack(torch.stack(stats))                      # (model ranks, nq, 3, T)
    top = st[:, :, 0].amax(dim=0).detach()
    total = ordered_sum([r[:, 1] * torch.exp(r[:, 0] - top) for r in st.unbind(0)])
    gold_all = ordered_sum([r[:, 2] for r in st.unbind(0)])
    return (top + torch.log(total) - gold_all).mean()


def _sharded_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig,
                  plan) -> torch.Tensor:
    """This rank's share of the global loss: the mean over its tokens over
    the number of batch shards (each rank's share is its tokens' sum over
    the global token count)."""
    x, _ = lm_forward(params, batch["tokens"], cfg, positions=batch.get("positions"),
                      return_hidden=True, plan=plan)
    head = _head(params, cfg, plan, x.dtype)
    with stage("loss"):
        if head.shape[1] != _head_cols(cfg):
            loss = _vocab_parallel_ce(x, head, batch["labels"], cfg, plan)
        else:
            loss = _loss_from_hidden(x, head, batch["labels"], cfg)
        return loss / torch.tensor(float(plan.dp), device=loss.device)


def _loss_from_hidden(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                      cfg: LMConfig) -> torch.Tensor:
    if _chunked(cfg):
        return _chunked_ce(x, head, labels, cfg)
    B, S = x.shape[:2]
    logits = (x @ head.to(x.dtype)).float()
    if cfg.input_mode == "audio_tokens":
        logits = logits.reshape(B, S, cfg.n_codebooks, cfg.vocab_padded)
    return _plain_ce(logits, labels, cfg)


def _chunked(cfg: LMConfig) -> bool:
    return bool(cfg.loss_vocab_chunk and cfg.input_mode != "audio_tokens"
                and cfg.vocab_padded % cfg.loss_vocab_chunk == 0)


def _plain_ce(logits: torch.Tensor, labels: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    if cfg.vocab_size != cfg.vocab_padded:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return (logz - gold).mean()


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: LMConfig) -> torch.Tensor:
    """Next-token cross-entropy; the vocabulary padding is masked out of the
    softmax at -1e30 (for audio, in every codebook).  With
    ``loss_vocab_chunk`` dividing the padded vocabulary, the chunked form
    (``_chunked_ce``); never for audio, as in JAX.  Under an active
    ``ShardPlan`` (``parallel.tensor.use_plan``), this rank's share of the
    global loss over its blocks and rows."""
    plan = active_plan()
    if plan is not None:
        return _sharded_loss(params, batch, cfg, plan)
    if _chunked(cfg):
        x, _ = lm_forward(params, batch["tokens"], cfg, positions=batch.get("positions"),
                          return_hidden=True)
        with stage("loss"):
            return _chunked_ce(x, params["head"], batch["labels"], cfg)
    logits, _ = lm_forward(params, batch["tokens"], cfg,
                           positions=batch.get("positions"))
    with stage("loss"):
        return _plain_ce(logits, batch["labels"], cfg)
