"""Batched GNN inference engine (the §5.3 merchant-system serving shape);
counterpart of ``repro/serving/gnn.py`` with the hot-node cache off.

Per request:  sample frontier  →  decode every frontier row  →  forward  →
(h, logits).  Frontiers are content-keyed (a pure function of the engine
seed and the requested ids, not of arrival order) and padded to a fixed
cap, exactly as in the JAX package, so the same request gives the same
frontier in both packages.

``serve_many`` coalesces a microbatch: all requests' sampled levels
concatenate into ONE ``FrontierBatch``, so a node requested by several
requests decodes once; the request count pads to a power-of-two bucket
with filler requests that repeat request 0 (zero extra unique rows).

The cross-request hot-node cache (``cache_capacity > 0``, the JAX
package's default) is a later slice of the port: any capacity other than
0 raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core import backend as backend_mod
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graph.engine import GNNModel, default_frontier_cap
from repro_torch.graph.sampler import FrontierBatch, NeighborSampler, _mix64
from repro_torch.stages import stage

CACHE_SLICE = "the hot-node cache slice (ROADMAP A.11)"


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
    at construction.  ``cache_capacity`` must be 0 until the cache slice
    lands."""

    def __init__(self, cfg: GNNConfig, params, sampler: NeighborSampler, *,
                 decode_backend: Optional[str] = None, serve_batch: int = 256,
                 frontier_cap: Optional[int] = None, pad_to: int = 256,
                 cache_capacity: int = 0, seed: int = 0,
                 max_coalesce: int = 8, device: DeviceLike = None):
        if cfg.model != "sage":
            raise ValueError(
                f"GraphInferenceEngine serves minibatched GraphSAGE; got "
                f"model={cfg.model!r}")
        if cache_capacity != 0:
            raise NotImplementedError(
                f"cache_capacity={cache_capacity!r}: the hot-node decode cache "
                f"is not ported yet; it comes with {CACHE_SLICE}. Pass "
                f"cache_capacity=0")
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

    def frontier_for(self, node_ids) -> FrontierBatch:
        """The exact (padded, fixed-cap) frontier ``serve`` samples for a
        request.  Deterministic in ``(seed, node_ids)``."""
        return self.coalesced_frontier([node_ids])

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

    # -- request API -----------------------------------------------------
    def serve(self, node_ids) -> GraphServeResult:
        """Serve one request batch of node ids (≤ ``serve_batch``)."""
        return self.serve_many([node_ids])[0]

    @torch.no_grad()
    def serve_many(self, requests: Sequence) -> List[GraphServeResult]:
        """Serve a microbatch with cross-request frontier dedup; responses
        equal what sequential ``serve`` calls return."""
        if len(requests) == 0:
            return []
        k = len(requests)
        sizes = [np.asarray(r).shape[0] for r in requests]
        fb = self.coalesced_frontier(requests)
        cap = fb.unique.shape[0]
        h = self.model.apply(self.params, fb)
        logits = None
        if self.cfg.task == "node":
            with stage("logits"):
                logits = self.model.logits(self.params, h)

        rows_total = k * self.frontier_cap
        self._requests += k
        self._microbatches += 1
        self._rows_decoded += cap
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
                rows_decoded=cap, rows_total=rows_total, batch_requests=k))
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
        """Cumulative serving counters since construction or ``reset()``."""
        return {"requests": self._requests,
                "microbatches": self._microbatches,
                "rows_decoded": self._rows_decoded,
                "rows_total": self._rows_total,
                "rows_decoded_per_request": self._rows_decoded / max(self._requests, 1)}

    def reset(self) -> None:
        """Zero the cumulative request/row counters."""
        self._requests = 0
        self._microbatches = 0
        self._rows_decoded = 0
        self._rows_total = 0
