"""Uniform neighbour sampling (GraphSAGE, paper §4 / Fig. 4); counterpart of
``repro/graph/sampler.py``.

Sampling runs on the host (numpy) against the padded neighbour table, with
the same generators and draws as the JAX package, so one seed gives the
same levels bit for bit:

  step 0: batch of target nodes                     (B,)
  step 1: fanout[0] first neighbours per target     (B, f1)
  step 2: fanout[1] second neighbours per first     (B, f1, f2)

Isolated nodes self-sample.  ``FrontierBatch`` carries the *unique* node
frontier plus int64 index maps per level, so the embedding decoder runs
once per unique node (``unique[index_maps[i]] == levels[i]``); ``to``
moves it to the device as tensors.  ``attach_codes`` gathers a frontier's
packed code rows on the host (codes kept on the host, the batch's
``codes``).  ``OwnerPlan`` and ``build_owner_plan`` route a stacked
N-shard frontier's rows to their owners for the owner-computes decode;
``remap_shard_state`` carries a batch source's state to another shard
count.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.graph.csr import CSRMatrix

Array = Union[np.ndarray, torch.Tensor]

# k-th neighbour from counter p*_PATH_STRIDE + k + 1 (the +1 keeps child path
# ids nonzero); a fanout must stay below the stride
_PATH_STRIDE = np.uint64(1024)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finaliser — a bijective avalanche mix on uint64."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def stream_key(seed: int, step: int) -> np.uint64:
    """Per-(seed, step) key for counter-based sampling."""
    with np.errstate(over="ignore"):
        k = np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15) + np.uint64(step)
    return np.uint64(_mix64(k))


@dataclasses.dataclass(frozen=True)
class OwnerPlan:
    """Host-built routing plan for the owner-computes cross-shard decode
    (``lookup_impl="owner"``, ``core.backend.OwnerBackend``); the JAX
    package's leaves, int32, bit for bit.

    Frontier rows are hash-partitioned by ``owner = node_id % n_shards``.
    Every array is stacked along the shard axis (leading dim ``n_shards``),
    so the placement that gives a rank its block of the frontier rows gives
    it its slice of the plan too (leading dim 1).  Shapes are static:
    ``owner_cap`` request slots per (requester, owner) pair,
    ``owner_unique_cap`` decode rows per owner.

    ``req_rows``   (n, n, owner_cap) — [requester s][owner o][slot] = row of
                   s's ``cap``-row frontier block, or the sentinel ``cap``
                   for an unused slot.
    ``owned_src``  (n, owner_unique_cap) — [owner o][j] = position in o's
                   received (n·owner_cap,) request buffer of the first
                   occurrence of its j-th owned id (0 past ``n_owned[o]``).
    ``ret_idx``    (n, n, owner_cap) — [owner o][requester s][slot] = row of
                   o's decoded (owner_unique_cap,) rows answering that slot
                   (0 for an unused slot).
    ``n_owned``    (n,) — distinct ids each owner decodes.
    """

    req_rows: Array
    owned_src: Array
    ret_idx: Array
    n_owned: Array

    def leaves(self) -> Tuple[Array, Array, Array, Array]:
        return (self.req_rows, self.owned_src, self.ret_idx, self.n_owned)

    @property
    def n_shards(self) -> int:
        """The shard count (also of one rank's slice, leading dim 1)."""
        return int(self.req_rows.shape[1])

    @property
    def owner_cap(self) -> int:
        return int(self.req_rows.shape[2])

    @property
    def owner_unique_cap(self) -> int:
        return int(self.owned_src.shape[1])


# Headroom of the per-(requester, owner) request buckets over their
# expected fill ``cap / n_shards``: absorbs hash skew across the residue
# classes.
OWNER_SAFETY = 1.25


def default_owner_caps(cap: int, n_shards: int,
                       safety: float = OWNER_SAFETY) -> Tuple[int, int]:
    """``(owner_cap, owner_unique_cap)`` sized from the per-shard frontier
    ``cap``: the expected bucket fill ``cap / n_shards`` times ``safety``,
    and ``cap / 2`` decode rows an owner (the owner decode is chosen only
    past a duplication of 2, which bounds an owner's distinct ids by
    ``cap / 2``); both rounded up to a multiple of 8 and clipped to the
    trivially safe ``cap`` and ``n_shards * owner_cap``."""
    def up8(x: int) -> int:
        return -(-int(x) // 8) * 8
    oc = min(up8(-(-cap * safety // n_shards)), cap)
    ou = min(up8(-(-cap // 2)), n_shards * oc)
    return int(oc), int(ou)


def remap_shard_state(state: dict, n_shards: int, shard: int = 0) -> dict:
    """A batch source's ``state_dict`` on another shard count, the sampler's
    half of an exact rescale (``elastic.rescale``).  Exact because every
    draw is a pure function of ``(seed, step, global position, path)``: the
    global batch at ``(seed, step)`` does not depend on the shard count,
    which only slices it, so carrying ``(seed, step)`` over and stamping the
    new layout gives, bit for bit, the stream a run at ``n_shards`` draws
    from the start (the global batch size must stay and divide by the new
    count, which ``rescale_spec`` checks).  ``miss_shadow``, the
    single-shard cache-miss replay, depends on the layout and is dropped:
    the rescaled run plans its misses against its own cache."""
    return {"step": int(state["step"]), "seed": int(state["seed"]),
            "shard": int(shard), "n_shards": int(n_shards)}


def build_owner_plan(uniques: Sequence[np.ndarray], n_uniques: Sequence[int],
                     n_shards: int, owner_cap: int,
                     owner_unique_cap: int) -> Optional[OwnerPlan]:
    """The owner-computes exchange plan of one stacked frontier:
    ``uniques`` are the n per-shard blocks (each (cap,), valid prefix of
    ``n_uniques[s]`` rows).  Rows go to owner ``id % n``, and each owner
    dedups the requests it receives from every requester, so each distinct
    id is decoded exactly once.  ``None`` when a (requester, owner) bucket
    exceeds ``owner_cap`` or an owner's distinct ids exceed
    ``owner_unique_cap``: the caller falls back loudly, never truncates."""
    n = int(n_shards)
    cap = int(np.asarray(uniques[0]).shape[0])
    req_rows = np.full((n, n, owner_cap), cap, np.int32)
    requests = [[None] * n for _ in range(n)]
    for s in range(n):
        ids = np.asarray(uniques[s])[:int(n_uniques[s])]
        own = ids % n
        for o in range(n):
            rows = np.nonzero(own == o)[0]
            if rows.shape[0] > owner_cap:
                return None
            req_rows[s, o, :rows.shape[0]] = rows
            requests[s][o] = ids[rows]
    owned_src = np.zeros((n, owner_unique_cap), np.int32)
    ret_idx = np.zeros((n, n, owner_cap), np.int32)
    n_owned = np.zeros((n,), np.int32)
    for o in range(n):
        # owner o's received buffer: requester s's segment at s*owner_cap
        flat = np.full((n * owner_cap,), -1, np.int64)
        for s in range(n):
            k = requests[s][o].shape[0]
            flat[s * owner_cap:s * owner_cap + k] = requests[s][o]
        pos = np.nonzero(flat >= 0)[0]
        uniq, first, inv = np.unique(flat[pos], return_index=True, return_inverse=True)
        if uniq.shape[0] > owner_unique_cap:
            return None
        owned_src[o, :uniq.shape[0]] = pos[first]
        n_owned[o] = uniq.shape[0]
        ridx = np.zeros((n * owner_cap,), np.int32)
        ridx[pos] = inv.astype(np.int32)
        ret_idx[o] = ridx.reshape(n, owner_cap)
    return OwnerPlan(req_rows, owned_src, ret_idx, n_owned)


def as_int64(a, device) -> torch.Tensor:
    """An array as an int64 tensor on ``device``.  A numpy array widens on
    the host, so a uint32 code word at or above 2**31 keeps its bit
    pattern whatever the device's support for ``torch.uint32``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, torch.int64)
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


@dataclasses.dataclass(frozen=True)
class FrontierBatch:
    """Deduplicated sampled minibatch (numpy on the host, tensors after
    ``to(device)``).

    ``unique``     (U_pad,) node ids, padded by repeating ``unique[0]``
                   (padding rows decode to valid embeddings that no index
                   map points at).
    ``index_maps`` per level, indices into ``unique`` with the naive level
                   shapes: (B,), (B, f1), (B, f1, f2), ...
    ``n_unique``   true unique count before padding.
    ``valid``      optional (U_pad,) bool: the non-padding rows.  ``None``
                   means the prefix mask ``arange(U_pad) < n_unique``; a
                   miss-first permuted frontier carries it explicitly.
    ``n_decode``   optional int: set by ``graph.engine.MissPlanningSource``
                   (and the serving engine's cache), the frontier is
                   permuted so rows [0, n_decode) are the planned cache
                   misses and every valid row past it a predicted hit
                   (``CachedDecodeBackend.lookup_missonly``).
    ``codes``      optional (U_pad, n_words) packed code rows of the
                   frontier, row-aligned with ``unique`` (``attach_codes``;
                   uint32 on the host, int64 bit patterns after ``to``).
    ``plan``       optional ``OwnerPlan``: the owner-computes routing of a
                   stacked sharded frontier whose source plans it.  Its
                   padding rows decode to zeros (no index map points at
                   them).
    """

    unique: Array
    index_maps: Tuple[Array, ...]
    n_unique: int
    valid: Optional[Array] = None
    n_decode: Optional[int] = None
    codes: Optional[Array] = None
    plan: Optional[OwnerPlan] = None

    @classmethod
    def from_levels(cls, levels: Sequence[np.ndarray], pad_to: int = 256,
                    cap: Optional[int] = None) -> "FrontierBatch":
        """Dedup a naive level list into a frontier + per-level index maps.
        ``cap`` pads the frontier to exactly that many rows instead of the
        next ``pad_to`` multiple; raises when the unique count exceeds it."""
        levels = [np.asarray(l) for l in levels]
        flat = np.concatenate([l.ravel() for l in levels])
        uniq, inv = np.unique(flat, return_inverse=True)
        n_unique = uniq.shape[0]
        if cap is None:
            cap = -(-n_unique // max(pad_to, 1)) * max(pad_to, 1)
        elif n_unique > cap:
            raise ValueError(
                f"frontier has {n_unique} unique nodes > cap={cap}; raise "
                f"frontier_cap (or shrink batch/fanout)")
        if cap > n_unique:
            uniq = np.concatenate(
                [uniq, np.full(cap - n_unique, uniq[0], uniq.dtype)])
        maps, off = [], 0
        for l in levels:
            maps.append(inv[off:off + l.size].reshape(l.shape).astype(np.int32))
            off += l.size
        return cls(uniq.astype(np.int32), tuple(maps), int(n_unique))

    def to(self, device) -> "FrontierBatch":
        """Tensors on ``device`` (ids, maps, code words and plan leaves as
        int64, ``valid`` as bool, ``n_decode`` a plain int); a batch already
        there is returned as it is."""
        def t(a):
            return as_int64(a, device)
        return FrontierBatch(
            t(self.unique), tuple(t(m) for m in self.index_maps), int(self.n_unique),
            valid=(None if self.valid is None
                   else torch.as_tensor(self.valid).to(device, torch.bool)),
            n_decode=self.n_decode,
            codes=None if self.codes is None else t(self.codes),
            plan=None if self.plan is None else OwnerPlan(*(t(a) for a in self.plan.leaves())))

    def valid_mask(self):
        """(U_pad,) bool: True on the genuine (non-padding) frontier rows; a
        tensor on ``unique``'s device for a tensor batch."""
        if isinstance(self.unique, torch.Tensor):
            if self.valid is not None:
                return torch.as_tensor(self.valid).to(self.unique.device, torch.bool)
            return torch.arange(self.unique.shape[0], device=self.unique.device) < self.n_unique
        if self.valid is not None:
            return np.asarray(self.valid, bool)
        return np.arange(self.unique.shape[0]) < self.n_unique

    @property
    def targets(self):
        """Level-0 (target) node ids, rebuilt from the frontier."""
        return self.unique[self.index_maps[0]]

    def levels(self) -> List[Array]:
        """Rebuild the naive level list."""
        return [self.unique[m] for m in self.index_maps]


def attach_codes(fb: FrontierBatch, host_codes: np.ndarray) -> FrontierBatch:
    """Gather the frontier's packed code rows (``host_codes[fb.unique]``,
    the bits of the ``codes_buf[ids]`` gather it replaces) into the batch's
    ``codes`` field.  It keys off the final ``unique``, so it runs after any
    permutation of the frontier (the miss planner's, the serving plan's); a
    batch that has its rows already is returned as it is."""
    if fb.codes is not None:
        return fb
    # np.take copies whole rows: 4-10x the 2-D fancy index's speed, its bits
    rows = np.take(np.asarray(host_codes, np.uint32), np.asarray(fb.unique), axis=0)
    return dataclasses.replace(fb, codes=rows)


class NeighborSampler:
    def __init__(self, adj: CSRMatrix, fanouts: Sequence[int], max_deg: int = 64,
                 seed: int = 0):
        self.fanouts = tuple(fanouts)
        self.table, self.deg = adj.neighbor_padded(max_deg)
        self.max_deg = max_deg
        self.rng = np.random.default_rng(seed)

    def _sample_level(self, nodes: np.ndarray, fanout: int,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """nodes: (...,) -> (..., fanout) sampled neighbour ids."""
        rng = rng if rng is not None else self.rng
        flat = nodes.reshape(-1)
        deg = np.minimum(self.deg[flat], self.max_deg)
        idx = rng.integers(0, np.maximum(deg, 1)[:, None], (flat.shape[0], fanout))
        nbr = self.table[flat[:, None], idx]
        nbr = np.where(nbr < 0, flat[:, None], nbr)   # isolated: self-sample
        return nbr.reshape(*nodes.shape, fanout).astype(np.int32)

    def sample(self, batch_nodes: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> List[np.ndarray]:
        """Returns [targets (B,), level1 (B,f1), level2 (B,f1,f2), ...].
        ``rng`` overrides the sampler's stateful generator."""
        levels = [batch_nodes.astype(np.int32)]
        cur = batch_nodes
        for f in self.fanouts:
            cur = self._sample_level(cur, f, rng=rng)
            levels.append(cur)
        return levels

    def sample_frontier(self, batch_nodes: np.ndarray, pad_to: int = 256,
                        rng: Optional[np.random.Generator] = None) -> FrontierBatch:
        """Sample and dedup in one call."""
        return FrontierBatch.from_levels(self.sample(batch_nodes, rng=rng),
                                         pad_to=pad_to)

    # -- counter-based (shard-sliceable) sampling ------------------------
    def _sample_level_hashed(self, nodes: np.ndarray, path_ids: np.ndarray,
                             fanout: int, key: np.uint64):
        """Neighbour slot k of the subtree node at path id p draws
        ``mix64(key ^ (p*STRIDE + k + 1)) % deg``: no generator state, so
        any slice of the batch reproduces exactly.  Returns (neighbours,
        child path ids)."""
        if fanout >= int(_PATH_STRIDE):
            raise ValueError(f"fanout {fanout} >= path stride {_PATH_STRIDE}")
        flat = nodes.reshape(-1)
        pids = path_ids.reshape(-1).astype(np.uint64)
        deg = np.minimum(self.deg[flat], self.max_deg)
        with np.errstate(over="ignore"):
            counters = (pids[:, None] * _PATH_STRIDE
                        + np.arange(1, fanout + 1, dtype=np.uint64))
            u = _mix64(counters ^ key)
        idx = (u % np.maximum(deg, 1)[:, None].astype(np.uint64)).astype(np.int64)
        nbr = self.table[flat[:, None], idx]
        nbr = np.where(nbr < 0, flat[:, None], nbr)   # isolated: self-sample
        return (nbr.reshape(*nodes.shape, fanout).astype(np.int32),
                counters.reshape(*nodes.shape, fanout))

    def sample_hashed(self, batch_nodes: np.ndarray, gpos: np.ndarray,
                      key: np.uint64) -> List[np.ndarray]:
        """The subtree below the target at global batch position
        ``gpos[i]`` is a pure function of ``(key, gpos[i])`` (``key =
        stream_key(seed, step)``), so shards sampling disjoint slices of one
        global batch draw exactly the levels one host draws for all of it."""
        levels = [np.asarray(batch_nodes).astype(np.int32)]
        cur = levels[0]
        pids = np.asarray(gpos, np.uint64) + np.uint64(1)   # 0 is never a path
        for lvl, f in enumerate(self.fanouts):
            # a subkey per level: counters are unique only within a level
            lkey = np.uint64(_mix64(key + np.uint64(lvl) + np.uint64(1)))
            cur, pids = self._sample_level_hashed(cur, pids, f, lkey)
            levels.append(cur)
        return levels

    # -- epoch iteration (the paper's Table 3 protocol) ------------------
    def minibatches(self, nodes: np.ndarray, batch_size: int, shuffle: bool = True):
        """Yield (levels, batch_node_ids); the short last batch is wrapped
        (padded from the start of the order) so every batch has
        ``batch_size`` targets."""
        for batch in self._batch_ids(nodes, batch_size, shuffle):
            yield self.sample(batch), batch

    def frontier_minibatches(self, nodes: np.ndarray, batch_size: int,
                             shuffle: bool = True, pad_to: int = 256):
        """Dedup-decode twin of ``minibatches``: yields (FrontierBatch, ids)."""
        for batch in self._batch_ids(nodes, batch_size, shuffle):
            yield self.sample_frontier(batch, pad_to=pad_to), batch

    def _batch_ids(self, nodes: np.ndarray, batch_size: int, shuffle: bool):
        order = self.rng.permutation(nodes) if shuffle else np.asarray(nodes)
        n = order.shape[0]
        for s in range(0, n, batch_size):
            batch = order[s: s + batch_size]
            if batch.shape[0] < batch_size:
                batch = np.concatenate([batch, order[: batch_size - batch.shape[0]]])
            yield batch
