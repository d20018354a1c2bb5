"""Streaming graph-training engine (sample -> lookup -> decode -> train);
counterpart of ``repro/graph/engine.py``.

* ``GNNModel.apply(params, batch)`` accepts a ``FrontierBatch`` (dedup-decode
  GraphSAGE), a naive level list, a ``FullGraphBatch`` (or a
  ``CSRMatrix``: full-graph GCN / SGC / GIN) or a batch dict, with the
  decode backend resolved once from the config's ``lookup_impl`` for the
  model's device.  It carries gradients; the serving and evaluation call
  sites run it under ``torch.no_grad``.
* ``SageBatchSource`` draws one batch per step, a pure function of
  ``(seed, shard, step)``: the targets from a generator seeded by the step,
  the neighbours counter-based (``NeighborSampler.sample_hashed``), so
  prefetching and resuming replay the same sequence bit for bit.
  ``ShardedSageBatchSource`` stacks N shards' frontiers into one batch
  (and plans the owner-computes exchange), so an N-shard run is a spec
  change (``n_shards``, ``lookup_impl``), not new code.
* ``MissPlanningSource`` wraps a source for cached training: it permutes
  each frontier miss-first against a host replica of the cache's
  bookkeeping, so the step decodes only the planned misses.
* ``PrefetchIterator`` runs a source in a producer thread, ``depth`` batches
  ahead.  On a CUDA device each batch is copied from pinned host memory on a
  side stream; the consumer's stream waits on the copy's event before it
  uses the batch, and the moved tensors are recorded on the consumer's
  stream so the caching allocator does not hand their memory out early.
  With codes kept on the host its ``code_gather`` attaches each frontier's
  packed code rows in the producer, before the copy.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core.backend import CachedDecodeBackend, HostCacheShadow, get_backend
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.csr import CSRMatrix, DeviceCSR
from repro_torch.graph.sampler import (FrontierBatch, NeighborSampler, OwnerPlan, as_int64,
                                      build_owner_plan, default_owner_caps, stream_key)
from repro_torch.models import gnn
from repro_torch.stages import stage


@dataclasses.dataclass(frozen=True)
class FullGraphBatch:
    """Full-graph "batch": a handle on the normalised adjacency, already on
    the device (``CSRMatrix.on``).  ``apply`` returns hidden states for ALL
    nodes (the paper trains GCN/SGC/GIN without minibatches, §C.1)."""

    adj: DeviceCSR


Batch = Union[FrontierBatch, FullGraphBatch, CSRMatrix, Sequence[Any], Dict[str, Any]]


class GNNModel:
    """Single entry point over the paper's GNN family.

    ``apply`` moves host batches to the model's device: a ``FrontierBatch``
    runs the dedup-decode forward, a list of levels the naive one, a
    ``FullGraphBatch`` the full-graph GCN / SGC / GIN (a ``CSRMatrix`` is
    uploaded for the call).  ``duplication`` is the measured frontier
    duplication ``auto`` reads under a mesh (``core.backend.resolve_auto``);
    the backend is resolved, under the mesh active then, when the model is
    built."""

    def __init__(self, cfg: GNNConfig, device: DeviceLike = None,
                 backend: Optional[str] = None, duplication: Optional[float] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        policy = cfg.embedding_config().decoder_config().precision_policy()
        self.backend = get_backend(backend or cfg.embedding.lookup_impl,
                                   device=self.device, policy=policy,
                                   duplication=duplication)

    def init(self, generator: torch.Generator, codes=None, aux=None):
        return gnn.init_gnn(generator, self.cfg, codes=codes, aux=aux)

    def apply(self, params, batch: Batch) -> torch.Tensor:
        if isinstance(batch, dict):
            batch = batch_view(batch)
        if isinstance(batch, FrontierBatch):
            with stage("h2d"):
                batch = batch.to(self.device)
            return gnn.sage_forward_frontier(params, batch, self.cfg,
                                             backend=self.backend)
        if isinstance(batch, (list, tuple)):
            with stage("h2d"):
                levels = [torch.as_tensor(l).to(self.device, torch.int64) for l in batch]
            return gnn.sage_forward(params, levels, self.cfg, backend=self.backend)
        if isinstance(batch, CSRMatrix):
            batch = FullGraphBatch(batch.on(self.device))
        if isinstance(batch, FullGraphBatch):
            return gnn.fullgraph_forward(params, batch.adj, self.cfg, backend=self.backend)
        raise TypeError(f"GNNModel.apply: unsupported batch type {type(batch)!r}")

    def apply_cached(self, params, batch: Batch, cache_state, buffers=None):
        """``(hidden, new_cache_state)``: a frontier decodes through the
        hot-node cache (only its planned-miss prefix when it carries
        ``n_decode``, then in place when given ``buffers``; see
        ``CachedDecodeBackend.lookup_missonly``); any other batch falls
        back to ``apply`` with the state passed through."""
        if isinstance(batch, dict):
            batch = batch_view(batch)
        if not isinstance(batch, FrontierBatch):
            return self.apply(params, batch), cache_state
        with stage("h2d"):
            batch = batch.to(self.device)
        if batch.n_decode is not None:
            return gnn.sage_forward_frontier_missonly(
                params, batch, self.cfg, cache_state, batch.n_decode, backend=self.backend,
                buffers=buffers)
        return gnn.sage_forward_frontier_cached(params, batch, self.cfg, cache_state,
                                                backend=self.backend)

    def logits(self, params, hidden):
        return gnn.node_logits(params, hidden, self.cfg)


def batch_view(batch: Dict[str, Any]) -> Batch:
    """The model-facing view of a source's batch dict ({"frontier": ...},
    {"levels": ...}, or the runtime's full-graph {"full": FullGraphBatch,
    "ids": ..., "labels": ...})."""
    for key in ("frontier", "levels", "full"):
        if key in batch:
            return batch[key]
    raise KeyError("batch dict has none of 'frontier' / 'levels' / 'full'")


def map_arrays(batch, fn: Callable):
    """``fn`` over every array of a batch (dicts, tuples, lists and
    ``FrontierBatch``es keep their structure; a frontier's ``valid`` mask
    is an array too, and so is each ``OwnerPlan`` leaf; its ``n_unique`` and
    ``n_decode`` stay plain ints; a
    ``FullGraphBatch`` is already on its device and passes as it is)."""
    if isinstance(batch, FullGraphBatch):
        return batch
    if isinstance(batch, FrontierBatch):
        return FrontierBatch(fn(batch.unique), tuple(fn(m) for m in batch.index_maps),
                             batch.n_unique,
                             valid=None if batch.valid is None else fn(batch.valid),
                             n_decode=batch.n_decode,
                             codes=None if batch.codes is None else fn(batch.codes),
                             plan=None if batch.plan is None else OwnerPlan(
                                 *(fn(a) for a in batch.plan.leaves())))
    if isinstance(batch, dict):
        return {k: map_arrays(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(map_arrays(v, fn) for v in batch)
    return fn(batch)


def batch_to(batch, device: torch.device):
    """Every array of ``batch`` as an int64 tensor on ``device`` (a
    frontier's ``valid`` mask as 0/1, ``FrontierBatch.to`` makes it bool;
    uint32 code words keep their bit patterns)."""
    return map_arrays(batch, lambda a: as_int64(a, device))


# ---------------------------------------------------------------------------
# batch sources (host side, deterministic per step)
# ---------------------------------------------------------------------------

def _step_rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng((seed * 1_000_003 + 12_582_917) + step)


def default_frontier_cap(batch_size: int, fanouts, pad_to: int,
                         n_nodes: int) -> int:
    """Worst-case unique count of one frontier (every sampled position
    distinct, bounded by the graph), rounded up to the padding multiple."""
    worst = batch_size
    per_target = 1
    for f in fanouts:
        per_target *= f
        worst += batch_size * per_target
    cap = min(worst, int(n_nodes))
    return -(-cap // max(pad_to, 1)) * max(pad_to, 1)


class SageBatchSource:
    """Per-step GraphSAGE batch source over a node pool with labels.

    Each step draws one global batch of ``batch_size * n_shards`` nodes
    from a generator seeded by ``(seed, step)``, keeps the shard's
    contiguous slice and samples its neighbourhoods counter-based, keyed by
    each target's global batch position, so the union of the shards'
    batches is the batch one ``n_shards=1`` source of the global size
    draws, and the state is the step alone.

    ``dedup=True`` emits {"frontier": FrontierBatch, "labels": y};
    ``dedup=False`` emits {"levels": tuple, "labels": y}.
    ``frontier_cap`` pads every frontier to exactly that many rows.
    """

    def __init__(self, sampler: NeighborSampler, nodes, labels, batch_size: int,
                 seed: int = 0, dedup: bool = True, pad_to: int = 256,
                 shard: int = 0, n_shards: int = 1,
                 frontier_cap: Optional[int] = None):
        if not 0 <= shard < n_shards:
            raise ValueError(f"shard {shard} out of range for {n_shards} shards")
        self.sampler = sampler
        self.nodes = np.asarray(nodes)
        self.labels = np.asarray(labels)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.dedup = dedup
        self.pad_to = pad_to
        self.shard = int(shard)
        self.n_shards = int(n_shards)
        self.frontier_cap = frontier_cap
        self.step = 0

    def next_batch(self) -> Dict[str, Any]:
        with stage("sample"):
            rng = _step_rng(self.seed, self.step)
            key = stream_key(self.seed, self.step)
            self.step += 1
            global_b = self.batch_size * self.n_shards
            replace = global_b > self.nodes.shape[0]
            # every shard draws the same global batch and keeps its slice
            ids_g = rng.choice(self.nodes, global_b, replace=replace).astype(np.int32)
            lo = self.shard * self.batch_size
            ids = ids_g[lo:lo + self.batch_size]
            gpos = np.arange(lo, lo + self.batch_size, dtype=np.uint64)
            y = self.labels[ids].astype(np.int32)
            levels = self.sampler.sample_hashed(ids, gpos, key)
        if not self.dedup:
            return {"levels": tuple(levels), "labels": y}
        with stage("dedup"):
            fb = FrontierBatch.from_levels(levels, pad_to=self.pad_to,
                                           cap=self.frontier_cap)
        return {"frontier": fb, "labels": y}

    # -- checkpointable state -------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "seed": self.seed,
                "shard": self.shard, "n_shards": self.n_shards}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError("restoring a sage batch source from a different run")
        if (int(state.get("shard", 0)) != self.shard
                or int(state.get("n_shards", 1)) != self.n_shards):
            raise ValueError("restoring a sage batch source onto a different "
                             "shard layout")
        self.step = int(state["step"])


class ShardedSageBatchSource:
    """All shards of the sharded stream: N per-shard ``SageBatchSource``s
    advanced in lockstep, their frontiers stacked into one global batch
    (the JAX package's, bit for bit).

    Row block ``s`` is shard ``s``'s frontier, padded to exactly
    ``frontier_cap`` rows, so the placement (``parallel.policy``) hands
    each rank its own block and the ``sharded`` decode backend decodes it
    there.  Index maps are offset into the owning shard's block; a node in
    several shards' frontiers decodes once per shard.  ``valid`` marks each
    block's genuine prefix.  Every rank runs this source whole (the
    single-process stand-in of the JAX package, where each host would run
    only its own shard), so each holds every block's index maps, which the
    combine after the decode's ``all_gather`` reads.

    ``owner_plan`` attaches a host-built ``OwnerPlan`` to every batch (in
    the prefetch producer, beside the sampling) for the ``owner`` decode
    backend: ``True`` always, ``"auto"`` when the duplication measured at
    the first step (``measure_duplication``) beats
    ``core.backend.OWNER_DUP_THRESHOLD``, the rule ``auto`` backend
    selection applies.  A batch whose buckets overflow ``owner_cap`` or
    ``owner_unique_cap`` is emitted without a plan after a warning (the
    owner backend then decodes the sharded way), and ``plan_overflows``
    counts them: rows are never truncated.
    """

    def __init__(self, sampler: NeighborSampler, nodes, labels,
                 batch_size: int, n_shards: int, seed: int = 0,
                 pad_to: int = 256, frontier_cap: Optional[int] = None,
                 owner_plan: Union[bool, str] = False,
                 owner_cap: Optional[int] = None,
                 owner_unique_cap: Optional[int] = None):
        if frontier_cap is None:
            frontier_cap = default_frontier_cap(
                batch_size, sampler.fanouts, pad_to, sampler.table.shape[0])
        self.n_shards = int(n_shards)
        self.frontier_cap = int(frontier_cap)
        self.seed = int(seed)
        self.shards = [
            SageBatchSource(sampler, nodes, labels, batch_size, seed=seed,
                            pad_to=pad_to, shard=s, n_shards=n_shards,
                            frontier_cap=self.frontier_cap)
            for s in range(self.n_shards)]
        self._peek = None   # (step, parts): a measured step is not sampled again
        self.plan_overflows = 0
        self.duplication_measured: Optional[float] = None
        if owner_plan == "auto":
            from repro_torch.core.backend import OWNER_DUP_THRESHOLD
            self.duplication_measured = self.measure_duplication()
            owner_plan = self.duplication_measured > OWNER_DUP_THRESHOLD
        self.owner_plan = bool(owner_plan)
        oc, ou = default_owner_caps(self.frontier_cap, self.n_shards)
        for name, cap_ in (("owner_cap", owner_cap), ("owner_unique_cap", owner_unique_cap)):
            if cap_ is not None and int(cap_) <= 0:
                raise ValueError(f"{name} must be positive, got {cap_} "
                                 f"(None = sized from frontier_cap)")
        self.owner_cap = oc if owner_cap is None else int(owner_cap)
        self.owner_unique_cap = ou if owner_unique_cap is None else int(owner_unique_cap)

    def measure_duplication(self) -> float:
        """Decode duplication of the next batch, ``frontier_rows /
        unique_rows``: the rows a rank decodes (``frontier_cap``, padding
        included) over the mean unique count of a shard.  It peeks without
        consuming: the shards' steps are restored and the sampled parts
        kept for the next ``next_batch``."""
        step0 = self.shards[0].step
        parts = [s.next_batch() for s in self.shards]
        for s in self.shards:
            s.step = step0
        self._peek = (step0, parts)
        total_unique = sum(int(p["frontier"].n_unique) for p in parts)
        return self.frontier_cap * self.n_shards / max(total_unique, 1)

    def next_batch(self) -> Dict[str, Any]:
        if self._peek is not None and self._peek[0] == self.shards[0].step:
            parts = self._peek[1]
            for s in self.shards:
                s.step += 1
        else:
            parts = [s.next_batch() for s in self.shards]
        self._peek = None
        cap = self.frontier_cap
        fbs = [p["frontier"] for p in parts]
        with stage("stack"):
            unique = np.concatenate([np.asarray(fb.unique) for fb in fbs])
            maps = tuple(
                np.concatenate([np.asarray(fb.index_maps[i]) + s * cap
                                for s, fb in enumerate(fbs)], axis=0)
                for i in range(len(fbs[0].index_maps)))
            valid = np.concatenate([np.arange(cap, dtype=np.int32) < int(fb.n_unique)
                                    for fb in fbs])
            n_unique = sum(int(fb.n_unique) for fb in fbs)
            labels = np.concatenate([p["labels"] for p in parts])
        plan = None
        if self.owner_plan:
            with stage("owner_plan"):
                plan = build_owner_plan([np.asarray(fb.unique) for fb in fbs],
                                        [int(fb.n_unique) for fb in fbs],
                                        self.n_shards, self.owner_cap, self.owner_unique_cap)
            if plan is None:
                import warnings
                self.plan_overflows += 1
                warnings.warn(
                    f"owner plan overflow: a (requester, owner) bucket exceeded "
                    f"owner_cap={self.owner_cap} or an owner's unique set exceeded "
                    f"owner_unique_cap={self.owner_unique_cap}; emitting the batch "
                    f"without a plan (decode falls back to the sharded row partition "
                    f"— correct, but no cross-shard dedup).  Raise the caps "
                    f"(RuntimeSpec.owner_cap / owner_unique_cap) if this recurs.",
                    stacklevel=2)
        return {"frontier": FrontierBatch(unique, maps, n_unique, valid=valid, plan=plan),
                "labels": labels}

    # -- checkpointable state -------------------------------------------
    def state_dict(self) -> Dict[str, int]:
        return {"step": self.shards[0].step, "seed": self.seed, "n_shards": self.n_shards}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError("restoring a sharded sage batch source from a different run")
        if int(state.get("n_shards", 1)) != self.n_shards:
            raise ValueError("restoring a sharded sage batch source onto a different "
                             "shard count")
        for sh in self.shards:
            sh.step = int(state["step"])
        self._peek = None


class MissPlanningSource:
    """Plan-ahead miss partition for training with the hot-node cache.

    Wraps a batch source and advances a ``core.backend.HostCacheShadow`` (an
    exact numpy replica of the cache bookkeeping, which depends only on the
    id sequence) one step per produced batch, so a prefetch producer can
    partition batch k+1's misses while step k runs.  Each emitted frontier
    is permuted miss-first, its index maps remapped through the inverse
    permutation, with an explicit ``valid`` mask and a bucketed
    ``n_decode`` (``pad_to`` doubling, capped at the frontier's rows); the
    train step then takes the ``lookup_missonly`` path.  On resume the
    runtime re-anchors the shadow from the restored ``CacheState``
    (``sync_shadow``)."""

    def __init__(self, source, capacity: int, staleness: int = 0, pad_to: int = 256):
        self.source = source
        self.pad_to = max(1, int(pad_to))
        self.shadow = HostCacheShadow(capacity, staleness)

    def next_batch(self) -> Dict[str, Any]:
        batch = dict(self.source.next_batch())
        fb = batch["frontier"]
        with stage("plan"):
            ids = np.asarray(fb.unique)
            U = ids.shape[0]
            valid = fb.valid_mask()
            perm, n_miss = self.shadow.plan(ids, valid)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(U, dtype=np.int32)
            n_dec = CachedDecodeBackend.miss_bucket(n_miss, self.pad_to, U)
            ids_p, valid_p = ids[perm], valid[perm]
            batch["frontier"] = FrontierBatch(
                ids_p, tuple(inv[np.asarray(m)] for m in fb.index_maps), fb.n_unique,
                valid=valid_p, n_decode=n_dec)
            self.shadow.update(ids_p, valid_p, n_dec)
        return batch

    # -- checkpointable state -------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        sd = dict(self.source.state_dict())
        sd["miss_shadow"] = self.shadow.snapshot()
        return sd

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.source.load_state_dict(state)
        if "miss_shadow" in state:
            self.shadow.restore(state["miss_shadow"])
        else:
            # an empty shadow plans everything as a miss (safe); the
            # runtime's resume re-syncs it from the device cache
            self.shadow.clear()

    def sync_shadow(self, cache_state) -> None:
        """Re-anchor the shadow to a restored device ``CacheState``."""
        self.shadow.sync_from_cache_state(cache_state)


# ---------------------------------------------------------------------------
# async prefetch
# ---------------------------------------------------------------------------

def _code_words(batch) -> int:
    """Packed code words a (host) batch carries: its frontier's ``codes``."""
    fb = batch.get("frontier") if isinstance(batch, dict) else batch
    codes = getattr(fb, "codes", None)
    return 0 if codes is None else int(np.size(codes))


class _OnCard:
    """A batch copied to the card on the producer's side stream, and the
    event that copy recorded."""

    def __init__(self, batch, event: torch.cuda.Event):
        self.batch = batch
        self.event = event


def _used_on(t: torch.Tensor, stream: torch.cuda.Stream) -> torch.Tensor:
    t.record_stream(stream)
    return t


class PrefetchIterator:
    """Host-to-device pipeline around a batch source: a producer thread
    calls ``source.next_batch()`` and moves the batch to ``device``,
    keeping up to ``depth`` batches in flight, so sampling and the copy
    overlap with the step consuming the previous batch.  ``device=None``
    hands the host batches over as they are.

    On a CUDA device the producer gathers each batch's arrays (a frontier's
    ``valid`` mask as 0/1; ``n_decode`` rides along as a plain int) into one
    pinned buffer, copies it with ``non_blocking=True`` on a side stream,
    records an event and waits for it (so ``put_us`` is the real
    transfer); ``next_batch`` makes the consumer's current stream wait on
    that event and records the moved tensors on it.

    Resume semantics: each queued batch carries the source state captured
    after producing it, and ``state_dict()`` is that of the last batch the
    consumer took, so a checkpoint restores to exactly the next batch
    however far ahead the producer ran.  ``close()`` is a pause: it drops
    the batches in flight and rewinds the source, and a later
    ``next_batch`` restarts the producer.  A producer's error is raised on
    the consumer's side.

    ``code_gather`` (``codes_placement="host"``) is a host ``batch -> batch``
    callable, the runtime's ``attach_codes`` of its buffer: the producer
    runs it on each batch after ``source.next_batch()`` (so after a miss
    planner's permutation) and before the copy, so a frontier's code rows
    are gathered and copied while the card runs the previous step, in the
    batch's one pinned buffer.  ``stats()`` accounts its time and the code
    bytes it adds.

    ``device`` may be a frontier placement (``parallel.policy``) in place of
    a device: the producer then keeps only this rank's blocks of each
    stacked batch (before the code gather, so only the block's code rows
    are gathered) and copies them to the placement's device.
    """

    def __init__(self, source, depth: int = 2, device: DeviceLike = None,
                 code_gather: Optional[Callable[[Any], Any]] = None):
        self.source = source
        self._code_gather = code_gather
        self.depth = max(1, int(depth))
        # a frontier placement (parallel.policy) cuts the rank's blocks out
        # of each batch before the copy to its device
        self._select = getattr(device, "select", None)
        if self._select is not None:
            device = device.device
        self.device = None if device is None else torch.device(device)
        self._stream = None
        if self.device is not None and self.device.type == "cuda":
            if self.device.index is None:   # the producer thread needs the index
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=self.device)
        self._lock = threading.Lock()     # serialises (re)starts vs producer
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._last_state = self._snapshot()
        self._n_produced = 0
        self._sample_us = 0.0
        self._code_gather_us = 0.0
        self._put_us = 0.0
        self._code_words = 0
        self._start()

    # -- internals -------------------------------------------------------
    def _snapshot(self):
        if hasattr(self.source, "state_dict"):
            return self.source.state_dict()
        return None

    def _start(self):
        self._stop = threading.Event()
        self._err = None
        self._q = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="engine-prefetch")
        self._thread.start()

    def _put(self, batch):
        if self.device is None:
            return batch
        if self._stream is None:
            return batch_to(batch, self.device)
        # one pinned buffer and one copy for all of the batch's arrays
        arrays = []
        map_arrays(batch, lambda a: arrays.append(np.asarray(a, np.int64).ravel()))
        pinned = torch.from_numpy(np.concatenate(arrays)).pin_memory()
        with torch.cuda.stream(self._stream):
            on_card = pinned.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        event.synchronize()
        offset = 0

        def view(a):
            nonlocal offset
            shape = np.shape(a)
            n = int(np.prod(shape))
            offset += n
            return on_card[offset - n:offset].view(shape)

        return _OnCard(map_arrays(batch, view), event)

    def _produce(self):
        stop, q = self._stop, self._q
        try:
            if self._stream is not None:
                torch.cuda.set_device(self.device)
            while not stop.is_set():
                t0 = time.perf_counter()
                with self._lock:
                    if stop.is_set():
                        return
                    batch = self.source.next_batch()
                    state = self._snapshot()
                t1 = time.perf_counter()
                if self._select is not None:
                    batch = self._select(batch)
                if self._code_gather is not None:
                    batch = self._code_gather(batch)
                words = _code_words(batch)
                t2 = time.perf_counter()
                batch = self._put(batch)
                t3 = time.perf_counter()
                self._sample_us += (t1 - t0) * 1e6
                self._code_gather_us += (t2 - t1) * 1e6
                self._put_us += (t3 - t2) * 1e6
                self._code_words += words
                self._n_produced += 1
                item = (batch, state)
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001  (raised on the consumer side)
            self._err = e

    # -- consumer API ----------------------------------------------------
    def next_batch(self):
        if self._thread is None:    # closed (e.g. by run_training): restart
            self._start()
        thread, q = self._thread, self._q
        while True:
            try:
                batch, state = q.get(timeout=0.1)
            except queue.Empty:
                if self._err is not None:
                    raise self._err
                if thread is None or not thread.is_alive():
                    raise RuntimeError("prefetch producer exited without a batch")
                continue
            self._last_state = state
            if isinstance(batch, _OnCard):
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(batch.event)
                batch = map_arrays(batch.batch, lambda t: _used_on(t, consumer))
            return batch

    def close(self):
        """Stop the producer and drop the batches in flight; the source is
        rewound to the last consumed batch, so a later ``next_batch``
        continues the exact sequence."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._last_state is not None and hasattr(self.source, "load_state_dict"):
            self.source.load_state_dict(self._last_state)

    def stats(self) -> Dict[str, float]:
        """Producer-side accounting since construction: the number of
        batches produced; wall clock of ``sample_us`` (the source's
        ``next_batch``), ``code_gather_us`` (``code_gather``) and ``put_us``
        (the device copy, waited for); and the batches' code rows.  The
        port moves each code word as an int64, so
        ``transferred_code_bytes`` counts 8 bytes a word; the ``uint32``
        keys count the JAX package's 4."""
        n = self._n_produced
        moved, packed = 8 * self._code_words, 4 * self._code_words
        return {"n_produced": n, "sample_us": self._sample_us,
                "code_gather_us": self._code_gather_us, "put_us": self._put_us,
                "transferred_code_bytes": moved,
                "transferred_code_bytes_per_batch": moved / n if n else 0.0,
                "uint32_code_bytes": packed,
                "uint32_code_bytes_per_batch": packed / n if n else 0.0}

    # -- checkpointable state -------------------------------------------
    def state_dict(self):
        return self._last_state

    def load_state_dict(self, state) -> None:
        self.close()
        if hasattr(self.source, "load_state_dict"):
            self.source.load_state_dict(state)
        self._last_state = self._snapshot()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
