"""Batched GNN inference engine (the §5.3 merchant-system serving shape);
counterpart of ``repro/serving/gnn.py``.

Per request:  sample frontier  →  miss-only cached decode  →  forward  →
(h, logits).  Frontiers are content-keyed (a pure function of the engine
seed and the requested ids, not of arrival order) and padded to a fixed
cap, exactly as in the JAX package, so the same request gives the same
frontier in both packages.

The engine keeps a device-resident hot-node ``CacheState`` across
requests (on by default: ``min(4·frontier_cap, n_nodes)`` slots; params
are frozen, so a decoded embedding never goes stale), which it owns alone
and updates in place.  Each frontier is partitioned on the host (the
``plan`` stage) into a miss prefix padded to a geometric bucket, against
a host table of the ids the cache holds, and only that prefix enters the
decoder; ``rows_decoded`` counts it.  ``cache_capacity=0`` decodes every
frontier row (the uncached reference).

``serve_many`` coalesces a microbatch: all requests' sampled levels
concatenate into ONE ``FrontierBatch``, so a node requested by several
requests decodes once; the request count pads to a power-of-two bucket
with filler requests that repeat request 0 (zero extra unique rows).

Params built with ``codes_placement="host"`` carry no ``codes_buf``: the
engine takes the packed buffer (``host_codes``) and gathers each planned
frontier's rows on the host, after the miss-first permutation, so the rows
stay aligned with the permuted frontier and the card holds only the
microbatch's code rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import backend as backend_mod
from repro_torch.core.backend import CachedDecodeBackend, CacheState
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.engine import GNNModel, default_frontier_cap
from repro_torch.graph.sampler import FrontierBatch, NeighborSampler, _mix64, attach_codes
from repro_torch.stages import stage


@dataclasses.dataclass
class GraphServeResult:
    """One served request batch."""
    embeddings: np.ndarray              # (B, H) final hidden per node
    logits: Optional[np.ndarray]        # (B, n_classes) when task == "node"
    predictions: Optional[np.ndarray]   # (B,) argmax labels (node task)
    rows_decoded: int                   # decoder rows the microbatch paid
    rows_total: int                     # frontier rows (padded cap × requests)
    batch_requests: int = 1             # requests coalesced in the microbatch


class GraphInferenceEngine:
    """Frozen-params GNN serving over the minibatched GraphSAGE path.

    ``decode_backend`` pins the decode path (``None`` keeps the config's
    ``lookup_impl``; ``"auto"`` resolves for ``device``); unknown names fail
    at construction.  ``cache_capacity`` sizes the cross-request hot-node
    cache (``None``: ~4 frontiers' worth of rows, the JAX default; 0 turns
    it off).  ``host_codes`` is the packed uint32 buffer of params built
    with ``codes_placement="host"`` (required there)."""

    def __init__(self, cfg: GNNConfig, params, sampler: NeighborSampler, *,
                 decode_backend: Optional[str] = None, serve_batch: int = 256,
                 frontier_cap: Optional[int] = None, pad_to: int = 256,
                 cache_capacity: Optional[int] = None, seed: int = 0,
                 max_coalesce: int = 8, device: DeviceLike = None,
                 host_codes: Optional[np.ndarray] = None):
        if cfg.model != "sage":
            raise ValueError(
                f"GraphInferenceEngine serves minibatched GraphSAGE; got "
                f"model={cfg.model!r}")
        self.device = resolve_device(device)
        if decode_backend is not None:
            resolved = (backend_mod.resolve_auto(self.device)
                        if decode_backend == "auto" else decode_backend)
            have = backend_mod.family_of(cfg.embedding.lookup_impl)
            want = backend_mod.family_of(resolved)
            if want != have:
                raise ValueError(
                    f"decode_backend={decode_backend!r} selects compression "
                    f"family {want!r} but the params were trained as {have!r}")
            cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
                cfg.embedding, lookup_impl=resolved))
        self.cfg = cfg
        self.params = params
        self.sampler = sampler
        self.host_codes = None if host_codes is None else np.asarray(host_codes, np.uint32)
        if cfg.embedding_config().codes_on_host and self.host_codes is None:
            raise ValueError(
                "codes_placement='host' params carry no codes_buf — pass "
                "host_codes (the full packed buffer) to the engine")
        self.model = GNNModel(cfg, self.device)
        self.serve_batch = int(serve_batch)
        self.pad_to = int(pad_to)
        self.seed = int(seed)
        self.max_coalesce = int(max_coalesce)
        if self.max_coalesce < 1:
            raise ValueError(f"max_coalesce must be >= 1, got {max_coalesce}")
        self.frontier_cap = int(
            frontier_cap if frontier_cap is not None
            else default_frontier_cap(self.serve_batch, cfg.fanouts,
                                      self.pad_to, cfg.n_nodes))
        compressed = cfg.embedding_config().is_compressed
        if cache_capacity is None:
            cache_capacity = min(4 * self.frontier_cap, cfg.n_nodes) if compressed else 0
        self.cache_capacity = int(cache_capacity)
        self.cached = compressed and self.cache_capacity > 0
        # params are frozen: the version counter never moves, so every
        # cached row stays fresh whatever the config's staleness.  The
        # slots live in buffers with one spare row, written in place.
        self._cache_state = self._cache_buffers = None
        if self.cached:
            self._cache_buffers = CacheState.create(
                self.cache_capacity + 1, cfg.d_e,
                backend_mod.torch_dtype(cfg.compute_dtype), device=self.device)
            self._cache_state = self._cache_buffers.head(self.cache_capacity)
            self._read_held()
        self.reset()

    # -- internals -------------------------------------------------------
    def _request_rng(self, padded_ids: np.ndarray) -> np.random.Generator:
        """Content-keyed request PRNG: the neighbour draws for a request are
        a pure function of ``(engine seed, requested ids)``."""
        with np.errstate(over="ignore"):
            h = _mix64(padded_ids.astype(np.uint64)
                       + (np.arange(padded_ids.shape[0], dtype=np.uint64)
                          + np.uint64(1))
                       * np.uint64(0x9E3779B97F4A7C15))
            key = _mix64(np.bitwise_xor.reduce(h)
                         ^ np.uint64(self.seed * 1_000_003 + 777_767_777))
        return np.random.default_rng(int(key))

    def _sample_levels(self, padded_ids: np.ndarray) -> List[np.ndarray]:
        return self.sampler.sample(padded_ids, rng=self._request_rng(padded_ids))

    def _pad_request(self, ids: np.ndarray) -> np.ndarray:
        if ids.shape[0] > self.serve_batch:
            raise ValueError(
                f"request batch {ids.shape[0]} > serve_batch "
                f"{self.serve_batch}; chunk requests host-side")
        if ids.shape[0] < self.serve_batch:
            ids = np.concatenate(
                [ids, np.full(self.serve_batch - ids.shape[0], ids[0], ids.dtype)])
        return ids

    def _request_bucket(self, k: int) -> int:
        b = 1
        while b < k:
            b *= 2
        return min(b, self.max_coalesce)

    def decode_buckets(self, max_requests: int = 1) -> Tuple[int, ...]:
        """Every decode-row count a microbatch of at most ``max_requests``
        can pad its decode to: the whole coalesced frontier uncached; with
        the cache, 0, the frontier, and ``pad_to`` doubled below it (the
        miss buckets, ``CachedDecodeBackend.miss_bucket``)."""
        cap = self._request_bucket(max_requests) * self.frontier_cap
        if not self.cached:
            return (cap,)
        out, b = [0, cap], self.pad_to
        while b < cap:
            out.append(b)
            b *= 2
        return tuple(sorted(set(out)))

    # -- the host's table of cached ids ------------------------------------
    def _read_held(self) -> None:
        """Build ``_held`` (a bool per node id: does the cache hold it) and
        the count of empty slots from the slot ids on the card."""
        node_ids = self._cache_state.node_ids.cpu().numpy()
        self._held = np.zeros(self.cfg.n_nodes, bool)
        self._held[node_ids[node_ids >= 0]] = True
        self._n_empty = int((node_ids < 0).sum())
        self._held_stale = False

    def _note_writes(self, unique: np.ndarray, n_miss: int, n_valid: int) -> None:
        """Track the writes of a planned lookup in ``_held``.  The valid rows
        are distinct ids, the ``n_valid - n_miss`` held ones each protect
        their slot, and the planned misses (the first ``n_miss`` rows) take
        the free slots in order, the empty ones first (their LRU stamp is
        the lowest): so the first ``min(n_miss, n_free)`` rows are written.
        Which ids an eviction removes depends on the LRU order on the card,
        so after one the table is read again before the next plan."""
        n_write = min(n_miss, self.cache_capacity - (n_valid - n_miss))
        self._held[unique[:n_write]] = True
        self._held_stale = n_write > self._n_empty
        self._n_empty = max(self._n_empty - n_write, 0)

    def frontier_for(self, node_ids) -> FrontierBatch:
        """The exact (padded, fixed-cap) frontier ``serve`` samples for a
        request, with its code rows under host codes.  Deterministic in
        ``(seed, node_ids)``."""
        return self._attach_codes(self.coalesced_frontier([node_ids]))

    def _attach_codes(self, fb: FrontierBatch) -> FrontierBatch:
        return fb if self.host_codes is None else attach_codes(fb, self.host_codes)

    def coalesced_frontier(self, requests: Sequence) -> FrontierBatch:
        """The ONE frontier ``serve_many(requests)`` decodes: every request's
        sampled levels concatenated (filler requests repeat request 0 up to
        the power-of-two bucket), padded to bucket × ``frontier_cap`` rows."""
        reqs = [np.asarray(r, np.int32) for r in requests]
        k = len(reqs)
        if not 1 <= k <= self.max_coalesce:
            raise ValueError(
                f"microbatch of {k} requests outside [1, max_coalesce="
                f"{self.max_coalesce}]")
        with stage("sample"):
            per_levels = [self._sample_levels(self._pad_request(r)) for r in reqs]
        kb = self._request_bucket(k)
        per_levels += [per_levels[0]] * (kb - k)
        with stage("dedup"):
            levels = [np.concatenate([pl[i] for pl in per_levels], axis=0)
                      for i in range(len(per_levels[0]))]
            return FrontierBatch.from_levels(levels, pad_to=self.pad_to,
                                             cap=kb * self.frontier_cap)

    def planned_frontier(self, requests: Sequence) -> FrontierBatch:
        """The frontier ``serve_many(requests)`` decodes next: the coalesced
        frontier and, with the cache on, permuted miss-first against the
        cache as it stands, with its ``valid`` mask and ``n_decode`` (the
        miss count's bucket), then with its code rows under host codes.  A
        pure function of the requests and the cache state."""
        return self._plan(requests)[0]

    def _plan(self, requests: Sequence) -> Tuple[FrontierBatch, int]:
        """``(planned_frontier(requests), n_miss)``: the partition is
        ``CachedDecodeBackend.plan_missonly``'s, with membership read from
        the host's table of cached ids.  Host code rows attach last, to the
        permuted frontier."""
        fb = self.coalesced_frontier(requests)
        if not self.cached:
            return self._attach_codes(fb), fb.n_unique
        with stage("plan"):
            if self._held_stale:
                self._read_held()
            cap = fb.unique.shape[0]
            valid = np.arange(cap) < fb.n_unique
            perm, n_miss = CachedDecodeBackend.partition(valid & ~self._held[fb.unique])
            inv = np.empty_like(perm)
            inv[perm] = np.arange(cap, dtype=np.int32)
            fb = FrontierBatch(fb.unique[perm], tuple(np.take(inv, m) for m in fb.index_maps),
                               fb.n_unique, valid=valid[perm],
                               n_decode=CachedDecodeBackend.miss_bucket(n_miss, self.pad_to, cap))
        return self._attach_codes(fb), n_miss

    # -- request API -----------------------------------------------------
    def serve(self, node_ids) -> GraphServeResult:
        """Serve one request batch of node ids (≤ ``serve_batch``)."""
        return self.serve_many([node_ids])[0]

    @torch.no_grad()
    def serve_many(self, requests: Sequence) -> List[GraphServeResult]:
        """Serve a microbatch with cross-request frontier dedup (and the
        cache's miss-only decode); responses equal what sequential
        ``serve`` calls return."""
        if len(requests) == 0:
            return []
        k = len(requests)
        sizes = [np.asarray(r).shape[0] for r in requests]
        fb, n_miss = self._plan(requests)
        if self.cached:
            h, self._cache_state = self.model.apply_cached(
                self.params, fb, self._cache_state, buffers=self._cache_buffers)
            self._note_writes(fb.unique, n_miss, fb.n_unique)
            n_dec = fb.n_decode
        else:
            h = self.model.apply(self.params, fb)
            n_dec = fb.unique.shape[0]
        logits = None
        if self.cfg.task == "node":
            with stage("logits"):
                logits = self.model.logits(self.params, h)

        rows_total = k * self.frontier_cap
        self._requests += k
        self._microbatches += 1
        self._rows_decoded += n_dec
        self._rows_total += rows_total

        with stage("d2h"):
            h = h.cpu().numpy()
            logits = None if logits is None else logits.cpu().numpy()
        out = []
        for i, B in enumerate(sizes):
            lo = i * self.serve_batch
            lg = None if logits is None else logits[lo:lo + B]
            out.append(GraphServeResult(
                embeddings=h[lo:lo + B], logits=lg,
                predictions=None if lg is None else lg.argmax(-1).astype(np.int32),
                rows_decoded=n_dec, rows_total=rows_total, batch_requests=k))
        return out

    def embed(self, node_ids) -> np.ndarray:
        """Final hidden representations (B, H)."""
        return self.serve(node_ids).embeddings

    def predict(self, node_ids) -> np.ndarray:
        """Argmax class per requested node (node-classification task)."""
        res = self.serve(node_ids)
        if res.predictions is None:
            raise ValueError("predict() needs a node-classification config")
        return res.predictions

    def stats(self) -> Dict[str, float]:
        """Cumulative serving counters since construction or ``reset()``,
        with the cache's ``hits``, ``misses`` and ``hit_rate`` when it is
        on."""
        out = {"requests": self._requests,
               "microbatches": self._microbatches,
               "rows_decoded": self._rows_decoded,
               "rows_total": self._rows_total,
               "rows_decoded_per_request": self._rows_decoded / max(self._requests, 1)}
        if self.cached:
            hits, misses = int(self._cache_state.hits), int(self._cache_state.misses)
            out.update(hits=hits, misses=misses, hit_rate=hits / max(hits + misses, 1))
        return out

    def reset(self) -> None:
        """Zero the cumulative request, row and hit counters without
        touching the cache's contents."""
        self._requests = 0
        self._microbatches = 0
        self._rows_decoded = 0
        self._rows_total = 0
        if self._cache_state is not None:
            self._cache_state = dataclasses.replace(
                self._cache_state, hits=torch.zeros_like(self._cache_state.hits),
                misses=torch.zeros_like(self._cache_state.misses))
