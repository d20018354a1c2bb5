"""Exact shard-count changes: an N-shard run continued at M shards;
counterpart of ``repro/elastic/rescale.py``.

Why this is exact: the hashed sampler draws one *global* batch per
``(seed, step)`` (every neighbour slot is a pure function of ``(seed,
step, global position, path)``) and the shards only slice it, so a run
rescaled from N to M shards consumes, step for step, the global batches a
native M-shard run draws; the codes are a pure function of the node id, so
the owner partition ``node_id % n_shards`` remaps without recomputation.
Carry ``(seed, step)`` over, build the mesh and owner plan at the new count,
and the continuation is bit for bit a native M-shard run's from the same
state.  The global ``batch_size`` stays and must divide by the new count;
pinned owner caps are derived again at it (``rederive_owner_caps``);
``ckpt_dir`` does not carry over (the old directory's checkpoints carry the
old topology: pass a new one).

The port runs one process a shard (``parallel.sharding``), so a rescale
changes the process group.  ``rescale_runtime`` is called by every rank of
the ``torch.distributed`` world, in the same order as its other group
builds (``parallel.sharding.group_mesh``):

  * shrink, M <= N: the new group is the first M ranks of the old one (the
    JAX package's ``data_mesh(M)`` takes the first M devices), and each of
    them installs its own copy of the state;
  * grow, M > N: the old group's ranks plus the lowest world ranks outside
    it; a rank outside the old group passes ``rt=None`` (and the graph, or
    builds it from the spec), and the old group's rank 0 broadcasts the
    spec and the ``pack_state`` payload over the new group
    (``parallel.sharding.broadcast_bytes``), which every rank installs.

A rank outside the new group gets ``None``.  The caller closes the old
runtime.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch.distributed as dist

from repro_torch.train.checkpoint import _flatten, _unflatten_into


def rescale_spec(spec, n_shards: int, ckpt_dir: Optional[str] = None):
    """The same run's ``RuntimeSpec`` at another shard count."""
    n = int(n_shards)
    if n < 1:
        raise ValueError(f"n_shards must be >= 1, got {n}")
    if spec.batch_size % n:
        raise ValueError(
            f"cannot rescale to n_shards={n}: global batch_size "
            f"{spec.batch_size} is not divisible by it (the global batch is "
            f"the determinism anchor and never changes across a rescale)")
    from repro_torch.core.backend import rederive_owner_caps
    cap = spec.frontier_cap
    if cap is None and (spec.owner_cap is not None or spec.owner_unique_cap is not None):
        from repro_torch.graph.engine import default_frontier_cap
        cap = default_frontier_cap(spec.batch_size // n, spec.model.fanouts, spec.pad_to,
                                   spec.model.n_nodes)
    oc, ou = rederive_owner_caps(cap if cap is not None else 0, n,
                                 explicit=(spec.owner_cap, spec.owner_unique_cap))
    return dataclasses.replace(spec, n_shards=n, owner_cap=oc, owner_unique_cap=ou,
                               ckpt_dir=ckpt_dir)


def install_state(rt, state: Any, source_state: Optional[dict] = None) -> None:
    """Install a carried-over or transferred train state (and the batch
    source's state) into a freshly built runtime: the state goes through the
    checkpoint's flatten / unflatten pair (a restore's leaf and shape
    checks, the runtime's devices and dtypes); the source state is remapped
    onto the runtime's shard count (``remap_shard_state``) and loaded; a
    miss-planning source re-anchors its cache shadow, as ``resume`` does."""
    rt.state = _unflatten_into(rt.state, _flatten(state))
    if source_state is None:
        return
    from repro_torch.graph.sampler import remap_shard_state
    if hasattr(rt.data_iter, "load_state_dict"):
        rt.data_iter.load_state_dict(remap_shard_state(source_state, rt.spec.n_shards))
    src = getattr(rt.data_iter, "source", rt.data_iter)
    if hasattr(src, "sync_shadow") and "cache" in rt.state:
        src.sync_shadow(rt.state["cache"])


def rebuild(rt, spec, group=None, graph=None, device=None):
    """A runtime of ``spec`` continuing ``rt``'s graph on ``rt``'s device,
    its params (and host codes) the template that ``install_state`` then
    overwrites, which saves drawing an init; without ``rt``, a seeded init
    on ``device`` over ``graph`` (or the spec's own)."""
    from repro_torch.graph.runtime import GraphRuntime
    if rt is None:
        return GraphRuntime.from_spec(spec, graph=graph, device=device, group=group)
    return GraphRuntime.from_spec(spec, graph=(rt.adj, rt.labels), device=rt.device,
                                  group=group, params=rt.params,
                                  codes=rt.host_codes if rt.codes_on_host else None)


def _old_group(rt, n_shards: int):
    """The world ranks of the runtime's group, agreed by every world rank
    (an all-gather over the world: a rank without a runtime learns them)."""
    from repro_torch.parallel.sharding import group_ranks
    mine = None
    if rt is not None:
        mine = group_ranks(rt.mesh.group) if rt.mesh is not None else [dist.get_rank()]
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, (mine, int(n_shards)))
    groups = {tuple(m) for m, _ in seen if m is not None}
    targets = {n for _, n in seen}
    if len(groups) != 1 or len(targets) != 1:
        raise ValueError(f"ranks disagree on the rescale: old groups {sorted(groups)}, "
                         f"targets {sorted(targets)}")
    return list(groups.pop())


def rescale_runtime(rt, n_shards: int, state: Any = None,
                    source_state: Optional[dict] = None,
                    ckpt_dir: Optional[str] = None, graph=None, device=None):
    """A new ``GraphRuntime`` at ``n_shards`` continuing ``rt``'s run, or
    ``None`` on a rank outside the new group.  ``state`` / ``source_state``
    default to ``rt``'s train state and batch source state.  Under
    ``torch.distributed`` every world rank calls it (``rt=None`` outside the
    old group; ``graph`` and ``device`` are then its graph and device), as
    the module describes; without a process group it rebuilds ``rt`` at
    ``n_shards`` (1: a rank count needs ranks)."""
    spec2 = None if rt is None else rescale_spec(rt.spec, n_shards, ckpt_dir=ckpt_dir)
    if state is None and rt is not None:
        state = rt.state
    if source_state is None and rt is not None and hasattr(rt.data_iter, "state_dict"):
        source_state = rt.data_iter.state_dict()
    from repro_torch.parallel.sharding import broadcast_bytes, distributed, group_mesh
    if not distributed():
        if rt is None:
            raise ValueError("rescale_runtime without a process group needs a runtime")
        new_rt = rebuild(rt, spec2)
        install_state(new_rt, state, source_state)
        return new_rt
    n = int(n_shards)
    old = _old_group(rt, n)
    if n <= len(old):
        target = old[:n]
    else:
        spare = [r for r in range(dist.get_world_size()) if r not in old]
        if len(spare) < n - len(old):
            raise ValueError(f"cannot grow to {n} ranks: the world has "
                             f"{dist.get_world_size()}")
        target = sorted(old + spare[:n - len(old)])
    mesh = group_mesh(target, device=device if rt is None else rt.device)
    if mesh is None:
        return None
    if n <= len(old):
        new_rt = rebuild(rt, spec2, group=mesh.group)
        install_state(new_rt, state, source_state)
        return new_rt
    # grow: the old group's rank 0 hands the spec and the state to the rest
    from repro_torch.elastic.transfer import pack_state, unpack_state
    from repro_torch.graph.runtime import RuntimeSpec
    src = target.index(old[0])
    spec_bytes, _ = broadcast_bytes(
        spec2.to_json().encode() if mesh.rank == src else None, mesh, src=src)
    spec2 = RuntimeSpec.from_json(spec_bytes.decode())
    payload, _ = broadcast_bytes(
        pack_state(state, {"source": source_state}) if mesh.rank == src else None,
        mesh, src=src, chunk_bytes=(spec2.elastic.chunk_bytes if spec2.elastic else 1 << 20))
    new_rt = rebuild(rt, spec2, group=mesh.group, graph=graph, device=mesh.device)
    state, extra = unpack_state(payload, new_rt.state)
    install_state(new_rt, state, extra.get("source"))
    return new_rt
