"""Where a stacked frontier batch's arrays live across the ranks; counterpart
of ``frontier_batch_shardings`` and ``make_frontier_placement`` in
``repro/parallel/policy.py`` (its LM rules wait for ROADMAP A.18).

A ``ShardedSageBatchSource`` batch stacks the N shards' frontiers along
its rows.  A rank keeps its own block of the frontier's row leaves
(``unique``, ``valid``, ``codes`` under host placement, and the
``OwnerPlan`` leaves, whose leading dim is the shard), and every other
array whole: the index maps, ``n_unique`` and the labels feed the combine
after the decode's ``all_gather``, which every rank runs on the full batch.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from repro_torch.graph.engine import batch_to
from repro_torch.graph.sampler import FrontierBatch, OwnerPlan
from repro_torch.parallel.sharding import DataMesh

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
