"""Sharding policies (counterpart of ``repro/parallel/policy.py``): the LM's
params (TP ⊗ FSDP), optimizer state, batches and caches, and where a
stacked frontier batch's arrays live across the GNN's ranks.

LM policy, as the JAX package's:
  * 2-D weights (stacked (L, D_in, D_out) or flat): the "parallel" dim over
    ``model`` (column-parallel for w_gate / w_up / wq / wk / wv / head,
    row-parallel for w_down / wo), the other dim over the data axes (FSDP);
  * attention weights split only whole heads: a leaf is FSDP-only where
    its head count does not divide the model axis;
  * MoE experts: E over ``model`` (EP), D over the data axes;
  * the embedding: a dense table vocab-parallel; codes and decoder
    replicated;
  * KV caches: kv heads over ``model`` when they divide it, else the cache's
    sequence dim takes it; batch over (pod, data); a batch of 1 gives the
    sequence dim the data axis too.
A spec is a tuple with one entry a dim: ``None``, an axis name or a tuple
of names, as a JAX ``PartitionSpec`` holds them.  The functions take any
mesh with a ``shape`` dict: a ``MeshSpec`` or a live ``Mesh``.
``shard_tree`` cuts a whole tree into a rank's blocks and ``gather_tree``
puts the blocks back together on every rank.

The GNN part:

A ``ShardedSageBatchSource`` batch stacks the N shards' frontiers along
its rows.  A rank keeps its own block of the frontier's row leaves
(``unique``, ``valid``, ``codes`` under host placement, and the
``OwnerPlan`` leaves, whose leading dim is the shard), and every other
array whole: the index maps, ``n_unique`` and the labels feed the combine
after the decode's ``all_gather``, which every rank runs on the full batch.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.graph.engine import batch_to
from repro_torch.graph.sampler import FrontierBatch, OwnerPlan
from repro_torch.nn.module import map_tree
from repro_torch.parallel.sharding import (DEFAULT_RULES, DataMesh, ShardingRules, Spec,
                                           _axes_tuple)

ROWS, WHOLE = "rows", "whole"


def frontier_batch_shardings(batch: Dict[str, Any], mesh: DataMesh) -> Dict[str, Any]:
    """The batch's structure with ``"rows"`` on each array a rank keeps its
    block of (dim 0 split into ``mesh.size`` blocks, when it divides) and
    ``"whole"`` on the rest."""
    k = mesh.size

    def rows(leaf):
        shape = np.shape(leaf)
        return ROWS if shape and shape[0] % k == 0 else WHOLE

    def fn(v):
        if isinstance(v, FrontierBatch):
            return FrontierBatch(
                unique=rows(v.unique), index_maps=tuple(WHOLE for _ in v.index_maps),
                n_unique=WHOLE, valid=None if v.valid is None else rows(v.valid),
                n_decode=v.n_decode, codes=None if v.codes is None else rows(v.codes),
                plan=None if v.plan is None else OwnerPlan(
                    *(rows(a) for a in v.plan.leaves())))
        if isinstance(v, (tuple, list)):
            return type(v)(WHOLE for _ in v)
        return WHOLE

    return {key: fn(v) for key, v in batch.items()}


class FrontierPlacement:
    """``device`` for a ``PrefetchIterator`` (and the step's placement
    without prefetch): ``select`` cuts this rank's blocks out of a host
    batch, following ``frontier_batch_shardings``; calling it also moves
    the result to the rank's device."""

    def __init__(self, mesh: DataMesh):
        self.mesh = mesh
        self.device = mesh.device

    def _block(self, leaf, spec):
        if spec != ROWS:
            return leaf
        n = np.shape(leaf)[0] // self.mesh.size
        return leaf[self.mesh.rank * n:(self.mesh.rank + 1) * n]

    def select(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        specs = frontier_batch_shardings(batch, self.mesh)
        out = {}
        for key, v in batch.items():
            s = specs[key]
            if isinstance(v, FrontierBatch):
                v = FrontierBatch(
                    self._block(v.unique, s.unique), v.index_maps, v.n_unique,
                    valid=None if v.valid is None else self._block(v.valid, s.valid),
                    n_decode=v.n_decode,
                    codes=None if v.codes is None else self._block(v.codes, s.codes),
                    plan=None if v.plan is None else OwnerPlan(
                        *(self._block(a, sa) for a, sa in zip(v.plan.leaves(),
                                                              s.plan.leaves()))))
            out[key] = v
        return out

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return batch_to(self.select(batch), self.device)


def make_frontier_placement(mesh: DataMesh) -> FrontierPlacement:
    """The producer's placement: each batch goes to the rank's device as
    its blocks, so another rank's frontier rows never reach it."""
    return FrontierPlacement(mesh)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Strategy:
    """Distribution knobs, as the JAX package's.

    tp_attn / tp_ffn / tp_vocab: Megatron tensor parallelism over ``model``
      for those weights and their activations.
    dp_over_model: fold the model axis into data parallelism (the batch
      splits over pod x data x model).
    fsdp: ZeRO-style parameter and optimizer sharding over the data axes.
    seq_shard_activations: the residual stream's sequence over ``model``
      between blocks (a rule only: the port's step does not run it).
    """
    tp_attn: bool = True
    tp_ffn: bool = True
    tp_vocab: bool = True
    dp_over_model: bool = False
    fsdp: bool = True
    seq_shard_activations: bool = False

    def batch_mesh_axes(self, mesh) -> Tuple[str, ...]:
        axes = [a for a in ("pod", "data") if a in mesh.shape]
        if self.dp_over_model and "model" in mesh.shape:
            axes.append("model")
        return tuple(axes)


DEFAULT_STRATEGY = Strategy()


def rules_for(strategy: Strategy, mesh) -> ShardingRules:
    """The activation rules that match ``strategy``."""
    rules = dict(DEFAULT_RULES.rules)
    rules["batch"] = strategy.batch_mesh_axes(mesh)
    if not strategy.tp_attn or strategy.dp_over_model:
        rules["heads"] = None
        rules["kv_heads"] = None
    if not strategy.tp_ffn or strategy.dp_over_model:
        rules["d_ff"] = None
        rules["experts"] = None
        rules["ssm_heads"] = None
        rules["ssm_inner"] = None
    if not strategy.tp_vocab or strategy.dp_over_model:
        rules["vocab"] = None
    if strategy.seq_shard_activations:
        rules["seq"] = "model" if not strategy.dp_over_model else None
    return ShardingRules(rules=rules)


def _axsize(mesh, axes) -> int:
    s = 1
    for a in _axes_tuple(axes):
        s *= mesh.shape.get(a, 1)
    return s


def _fits(dim: int, mesh, axes) -> bool:
    axes = _axes_tuple(axes)
    if not all(a in mesh.shape for a in axes):
        return False
    return dim % _axsize(mesh, axes) == 0


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


_COL_PAR = re.compile(r"(w_gate|w_up|wq|wk|wv|head)$")
_ROW_PAR = re.compile(r"(w_down|wo)$")


def _leaf_spec(path_keys, shape, cfg: LMConfig, mesh,
               strategy: Strategy = DEFAULT_STRATEGY) -> Spec:
    """The spec of one param leaf at ``path_keys`` (its dict keys) of
    ``shape``: the JAX package's rule for rule."""
    path = "/".join(path_keys)
    shape = tuple(shape)
    ndim = len(shape)
    model_sz = mesh.shape.get("model", 1)
    tp_attn = strategy.tp_attn and not strategy.dp_over_model
    tp_ffn = strategy.tp_ffn and not strategy.dp_over_model
    tp_vocab = strategy.tp_vocab and not strategy.dp_over_model
    if strategy.dp_over_model:
        fsdp_axes = (("pod", "data"), ("data",), ("model",))
    else:
        fsdp_axes = (("pod", "data"), ("data",))

    def fsdp_axis(dim):
        if not strategy.fsdp:
            return None
        for ax in fsdp_axes:
            if all(a in mesh.shape for a in ax) and _fits(dim, mesh, ax):
                return ax[0] if len(ax) == 1 else ax
        return None

    # ---- embedding subtree ----
    if "embed/" in path or path.startswith("embed"):
        if path.endswith("table"):      # dense table: vocab-parallel + FSDP
            spec = [None] * ndim
            if tp_vocab and _fits(shape[0], mesh, "model"):
                spec[0] = "model"
            if ndim > 1 and strategy.fsdp and _fits(shape[1], mesh, "data"):
                spec[1] = "data"
            return tuple(spec)
        return (None,) * ndim           # codes + decoder: replicated

    # ---- attention projections: only split whole heads ----
    is_attn = "/attn/" in path or path.endswith("attn")
    leafname = path_keys[-2] if path_keys[-1] in ("w", "b") else path_keys[-1]
    if is_attn and path_keys[-1] == "w":
        n_heads = cfg.n_heads if leafname in ("wq", "wo") else cfg.n_kv_heads
        heads_ok = tp_attn and n_heads and n_heads % model_sz == 0
        spec = [None] * ndim
        if leafname in ("wq", "wk", "wv"):
            if heads_ok and _fits(shape[-1], mesh, "model"):
                spec[-1] = "model"
            spec[-2] = fsdp_axis(shape[-2])
        else:                           # wo: row-parallel
            if heads_ok and _fits(shape[-2], mesh, "model"):
                spec[-2] = "model"
            spec[-1] = fsdp_axis(shape[-1])
        if spec[-1] == spec[-2] and spec[-1] is not None:
            spec[-2] = None
        return tuple(spec)
    if is_attn and path_keys[-1] == "b":
        return (None,) * ndim

    # ---- MoE experts: (L, E, D, F) / (L, E, F, D); router (L, D, E) ----
    if "/moe/" in path:
        spec = [None] * ndim
        if leafname in ("w_gate", "w_up", "w_down") and ndim >= 3:
            e_dim = ndim - 3
            if tp_ffn and _fits(shape[e_dim], mesh, "model"):
                spec[e_dim] = "model"
            d_dim = ndim - 2 if leafname != "w_down" else ndim - 1
            ax = fsdp_axis(shape[d_dim])
            if ax is not None and ax != spec[e_dim]:
                spec[d_dim] = ax
        elif leafname == "router":
            spec[-2] = fsdp_axis(shape[-2])
        return tuple(spec)

    # ---- generic 2D+ weights ----
    if leafname in ("w_b", "w_c"):      # SSD B/C projections: N stays whole
        spec = [None] * ndim
        spec[-2] = fsdp_axis(shape[-2])
        return tuple(spec)
    if ndim >= 2 and path_keys[-1].startswith("w") or leafname in ("head",):
        spec = [None] * ndim
        if _COL_PAR.search(leafname or "") or leafname in ("w_in", "head"):
            col, row = ndim - 1, ndim - 2
        elif _ROW_PAR.search(leafname or "") or leafname == "w_out":
            col, row = ndim - 2, ndim - 1
        else:
            col, row = ndim - 1, ndim - 2
        if ndim >= 2:
            tp_here = tp_vocab if leafname == "head" else tp_ffn
            if tp_here and _fits(shape[col], mesh, "model"):
                spec[col] = "model"
            ax = fsdp_axis(shape[row])
            if ax is not None and ax != spec[col]:
                spec[row] = ax
            return tuple(spec)

    # ---- everything else (norms, biases, scalars, conv) ----
    return (None,) * ndim


_ABSTRACT: Dict[LMConfig, Any] = {}


def abstract_params(cfg: LMConfig):
    """``init_lm``'s tree as tensors without storage (shapes and dtypes),
    drawn once a config."""
    if cfg not in _ABSTRACT:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.models.lm import init_lm
        with FakeTensorMode():
            _ABSTRACT[cfg] = init_lm(torch.Generator(), cfg)
    return _ABSTRACT[cfg]


def params_shardings(cfg: LMConfig, params_tree, mesh,
                     strategy: Strategy = DEFAULT_STRATEGY):
    """The param tree's structure with each leaf's spec (``params_tree``'s
    leaves need only a ``shape``: tensors, fake tensors)."""
    return map_tree(lambda path, leaf: None if leaf is None
                    else _leaf_spec(list(path), leaf.shape, cfg, mesh, strategy),
                    params_tree)


def state_shardings(cfg: LMConfig, state_tree, mesh,
                    strategy: Strategy = DEFAULT_STRATEGY):
    """Specs of {"params", "opt": {"step", "mu", "nu"}, "step"}: the Adam
    moments take their param's spec (ZeRO)."""
    pshard = params_shardings(cfg, state_tree["params"], mesh, strategy)
    return {
        "params": pshard,
        "opt": {"step": (),
                "mu": params_shardings(cfg, state_tree["opt"]["mu"], mesh, strategy),
                "nu": params_shardings(cfg, state_tree["opt"]["nu"], mesh, strategy)},
        "step": (),
    }


def batch_shardings(batch_tree, mesh, strategy: Strategy = DEFAULT_STRATEGY):
    """Token batches: the batch dim over the DP axes (leading axes shed until
    they divide it), dim 1 of (3, B, S) ``positions``, else dim 0."""
    baxes = strategy.batch_mesh_axes(mesh)

    def fn(path, leaf):
        shape = tuple(leaf.shape)
        b_dim = 1 if path[-1] == "positions" and len(shape) == 3 else 0
        spec = [None] * len(shape)
        ax = tuple(baxes)
        while ax and not _fits(shape[b_dim] if shape else 0, mesh, ax):
            ax = ax[1:]
        if shape and ax:
            spec[b_dim] = ax if len(ax) > 1 else ax[0]
        return tuple(spec)
    return map_tree(fn, batch_tree)


def kv_seq_mesh_axis(cfg: LMConfig, mesh, strategy: Strategy = DEFAULT_STRATEGY,
                     batch: int = 0):
    """The mesh axis of the KV cache's sequence dim (None if kv heads take
    the model axis and the batch takes data), as ``cache_shardings_policy``
    lays it out."""
    model_sz = mesh.shape.get("model", 1)
    kv_model_ok = bool(cfg.n_kv_heads and cfg.n_kv_heads % model_sz == 0
                       and not strategy.dp_over_model)
    baxes = strategy.batch_mesh_axes(mesh)
    batch_shardable = batch > 1 and _fits(batch, mesh, baxes)
    if kv_model_ok:
        return None if batch_shardable else "data"
    return "model" if batch_shardable else tuple(
        a for a in ("data", "model") if a in mesh.shape)


def cache_batch_axes(batch: int, mesh, strategy: Strategy = DEFAULT_STRATEGY) -> Tuple[str, ...]:
    """The axes a serving batch of ``batch`` rows splits over: the cache's
    batch dim under ``cache_shardings_policy`` (the strategy's batch axes
    where their product divides it and it holds more than one row, else
    none)."""
    baxes = strategy.batch_mesh_axes(mesh)
    return tuple(baxes) if batch > 1 and _fits(batch, mesh, baxes) else ()


def _one_dim_each(spec: Spec) -> Spec:
    """``spec``, which must map each mesh axis to one dim at most (a JAX
    ``NamedSharding`` refuses it otherwise: a cache batch split over
    (data, model) under ``dp_over_model`` with its sequence on ``model``)."""
    axes = [a for entry in spec for a in _axes_tuple(entry)]
    if len(axes) != len(set(axes)):
        raise ValueError(f"spec {spec} maps a mesh axis to more than one dim")
    return spec


def cache_shardings_policy(cfg: LMConfig, cache_tree, mesh,
                           strategy: Strategy = DEFAULT_STRATEGY):
    """An ``LMCache`` of specs for ``cache_tree``'s buffers (``pos`` gets
    ``()``; an absent buffer None)."""
    from repro_torch.models.lm import LMCache
    baxes = strategy.batch_mesh_axes(mesh)
    bspec = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)
    model_sz = mesh.shape.get("model", 1)
    kv_model_ok = bool(cfg.n_kv_heads and cfg.n_kv_heads % model_sz == 0
                       and not strategy.dp_over_model)

    def kv_spec(shape):
        sites, B, S, K, Dh = shape
        spec = [None] * 5
        used_data = False
        if _fits(B, mesh, baxes) and B > 1:
            spec[1] = bspec
            used_data = True
        if kv_model_ok:
            spec[3] = "model"
            if not used_data and _fits(S, mesh, "data"):
                spec[2] = "data"
        else:
            seq_axes = ("model",) if used_data else tuple(
                a for a in ("data", "model") if a in mesh.shape)
            seq_axes = tuple(a for a in seq_axes if a in mesh.shape)
            if seq_axes and _fits(S, mesh, seq_axes):
                spec[2] = seq_axes if len(seq_axes) > 1 else seq_axes[0]
        return tuple(spec)

    def ssm_spec(shape):
        L, B, H, N, Pd = shape
        spec = [None] * 5
        if _fits(B, mesh, baxes) and B > 1:
            spec[1] = bspec
        if _fits(H, mesh, "model"):
            spec[2] = "model"
        return tuple(spec)

    def conv_spec(shape):
        L, B, W, C = shape
        spec = [None] * 4
        if _fits(B, mesh, baxes) and B > 1:
            spec[1] = bspec
        return tuple(spec)

    def of(buf, fn):
        return None if buf is None else _one_dim_each(fn(tuple(buf.shape)))

    return LMCache(pos=(), kv_k=of(cache_tree.kv_k, kv_spec), kv_v=of(cache_tree.kv_v, kv_spec),
                   ssm_state=of(cache_tree.ssm_state, ssm_spec),
                   conv=of(cache_tree.conv, conv_spec))


# ---------------------------------------------------------------------------
# a rank's blocks of a tree
# ---------------------------------------------------------------------------

def block_slices(shape, spec: Optional[Spec], mesh, coords: Dict[str, int]):
    """The slices of ``shape`` that the rank at ``coords`` holds under
    ``spec`` (block index row-major over a dim's axes)."""
    out = []
    for d, dim in enumerate(shape):
        axes = _axes_tuple(spec[d]) if spec is not None and d < len(spec) else ()
        n, i = 1, 0
        for a in axes:
            n *= mesh.shape[a]
            i = i * mesh.shape[a] + coords[a]
        size = dim // n
        out.append(slice(i * size, (i + 1) * size))
    return tuple(out)


def shard_leaf(t, spec: Optional[Spec], mesh, coords: Optional[Dict[str, int]] = None):
    """The block of ``t`` the rank at ``coords`` (this rank's by default)
    holds, as a contiguous copy (``t`` itself where it is whole)."""
    if t is None or spec is None or not any(spec):
        return t
    coords = mesh.coords if coords is None else coords
    return t[block_slices(t.shape, spec, mesh, coords)].contiguous()


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` cut to this rank's block under ``specs`` (the
    same structure; None specs keep a leaf whole)."""
    return map_tree(lambda _, t, spec: shard_leaf(t, spec, mesh)
                    if isinstance(t, torch.Tensor) else t, tree, specs)


def gather_leaf(t, spec: Optional[Spec], mesh):
    """The whole leaf from every rank's block, on every rank (the blocks
    are all-gathered on each sharded dim in turn)."""
    if t is None or spec is None or not any(spec):
        return t
    for d, axes in enumerate(spec):
        if axes is not None:
            t = torch.cat(mesh.all_gather(t, axes), dim=d)
    return t


def gather_tree(tree, specs, mesh):
    """``shard_tree``'s inverse: every leaf whole on every rank."""
    return map_tree(lambda _, t, spec: gather_leaf(t, spec, mesh)
                    if isinstance(t, torch.Tensor) else t, tree, specs)
