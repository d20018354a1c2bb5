"""Continuous-batching serving tier (counterpart of
``repro/serving/batcher.py``).

``ServingBatcher`` puts an admission-controlled request queue in front of
an engine.  Clients ``submit()`` a request and get a
``concurrent.futures.Future`` back (or call the synchronous ``serve()``,
which is submit-and-wait, so the batcher drops in wherever an engine
does).  One worker thread coalesces queued requests into microbatches,
flushing when ``max_batch`` requests are waiting OR ``max_delay_ms`` has
elapsed since the oldest one arrived, and serves each microbatch in one
engine call.

Engines exposing ``serve_many`` (``serving.gnn.GraphInferenceEngine``)
get cross-request frontier dedup: the whole microbatch dedups into one
unique-node frontier, so a hub node requested by many concurrent users
samples and decodes once per microbatch, on top of the shared hot-node
cache.  Engines without it are served request by request behind the same
queue.

Backpressure is a bounded queue: past ``queue_depth`` waiting requests,
``submit`` raises ``Overloaded`` carrying a ``retry_after_s`` estimate
instead of growing an unbounded backlog.  Shed requests are counted in
``stats()``.

Threading contract: every engine call runs on the batcher's one worker
thread (on the engine's device; a CUDA engine's tensors stay on its
card), so the engine needs no locking; once an engine is wrapped, drive
it only through the batcher.  ``close()`` drains every admitted request
before returning: an accepted request is never dropped.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional, Tuple

__all__ = ["BatchingSpec", "Overloaded", "ServingBatcher"]


@dataclasses.dataclass(frozen=True)
class BatchingSpec:
    """Declarative continuous-batching knobs.

    Lives on ``RuntimeSpec.batching`` (``graph.runtime``), so turning the
    serving tier on is a spec field change that JSON/checkpoint
    round-trips like every other pipeline knob.

    ``max_batch``     requests coalesced per microbatch (size flush); also
                      sizes the engine's request-count jit buckets.
    ``max_delay_ms``  deadline flush: the longest a queued request waits
                      for company before the microbatch goes anyway — the
                      latency the tail of a quiet period pays for
                      coalescing.
    ``queue_depth``   admission bound: waiting requests beyond this are
                      shed with ``Overloaded`` (retry-after) instead of
                      queuing unboundedly.
    """

    max_batch: int = 8
    max_delay_ms: float = 2.0
    queue_depth: int = 64

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_delay_ms < 0:
            raise ValueError(
                f"max_delay_ms must be >= 0, got {self.max_delay_ms}")
        if self.queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self.queue_depth}")


class Overloaded(RuntimeError):
    """Admission control shed: the serving queue is full.

    ``retry_after_s`` estimates when a slot frees up (queue depth over the
    flush cadence) — a hint for client backoff, not a reservation."""

    def __init__(self, queued: int, retry_after_s: float):
        super().__init__(
            f"serving queue full ({queued} requests waiting); retry in "
            f"~{retry_after_s * 1e3:.0f} ms")
        self.queued = queued
        self.retry_after_s = retry_after_s


class ServingBatcher:
    """Async microbatching front end over a ``serving.Engine``.

    ``serve_kwargs`` are forwarded to every engine call (e.g.
    ``max_new_tokens`` for the LM engine) — per-batcher, not per-request,
    so one microbatch is always one engine configuration."""

    def __init__(self, engine, spec: Optional[BatchingSpec] = None,
                 serve_kwargs: Optional[Dict[str, Any]] = None):
        self.spec = spec if spec is not None else BatchingSpec()
        max_coalesce = getattr(engine, "max_coalesce", None)
        if max_coalesce is not None and self.spec.max_batch > max_coalesce:
            raise ValueError(
                f"BatchingSpec.max_batch={self.spec.max_batch} exceeds the "
                f"engine's max_coalesce={max_coalesce}; build the engine "
                f"with max_coalesce >= max_batch")
        self.engine = engine
        self._serve_kwargs = dict(serve_kwargs or {})
        self._serve_many = getattr(engine, "serve_many", None)
        self._q: Deque[Tuple[Any, Future]] = deque()
        self._lock = threading.Lock()
        self._wakeup = threading.Condition(self._lock)
        self._closed = False
        self._submitted = 0
        self._completed = 0
        self._shed = 0
        self._microbatches = 0
        self._max_coalesced = 0
        self._worker = threading.Thread(
            target=self._run, name="serving-batcher", daemon=True)
        self._worker.start()

    # -- client API ------------------------------------------------------
    def submit(self, request) -> Future:
        """Enqueue one request; resolves to the engine's result for it.
        Raises ``Overloaded`` (with ``retry_after_s``) when the queue is
        at ``queue_depth`` — admission control happens HERE, at the edge,
        so an accepted request is never silently dropped later."""
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingBatcher is closed")
            if len(self._q) >= self.spec.queue_depth:
                self._shed += 1
                raise Overloaded(len(self._q), self._retry_after_locked())
            fut: Future = Future()
            self._q.append((request, fut))
            self._submitted += 1
            self._wakeup.notify_all()
        return fut

    def serve(self, request, **_ignored):
        """``Engine``-protocol entry point: submit and wait."""
        return self.submit(request).result()

    def stats(self) -> Dict[str, Any]:
        """Batcher counters plus (when available) the engine's own."""
        with self._lock:
            out: Dict[str, Any] = {
                "submitted": self._submitted,
                "completed": self._completed,
                "shed": self._shed,
                "queued": len(self._q),
                "microbatches": self._microbatches,
                "max_coalesced": self._max_coalesced,
                "mean_coalesced": (self._completed
                                   / max(self._microbatches, 1)),
            }
        engine_stats = getattr(self.engine, "stats", None)
        if callable(engine_stats):
            out["engine"] = engine_stats()
        return out

    def close(self) -> None:
        """Stop admitting, drain every already-admitted request, join the
        worker.  Idempotent."""
        with self._lock:
            self._closed = True
            self._wakeup.notify_all()
        self._worker.join()

    def __enter__(self) -> "ServingBatcher":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- worker ----------------------------------------------------------
    def _retry_after_locked(self) -> float:
        # drain-rate estimate: one flush cycle clears up to max_batch
        # requests per max_delay_ms (service time comes on top — this is a
        # backoff hint, not a promise)
        per_batch_s = max(self.spec.max_delay_ms, 1.0) / 1e3
        batches_ahead = len(self._q) // self.spec.max_batch + 1
        return batches_ahead * per_batch_s

    def _run(self) -> None:
        spec = self.spec
        while True:
            with self._wakeup:
                while not self._q and not self._closed:
                    self._wakeup.wait()
                if not self._q:          # closed AND drained
                    return
                if not self._closed and len(self._q) < spec.max_batch:
                    # deadline flush: wait (briefly) for company
                    deadline = time.monotonic() + spec.max_delay_ms / 1e3
                    while len(self._q) < spec.max_batch and not self._closed:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._wakeup.wait(timeout=remaining)
                batch = [self._q.popleft()
                         for _ in range(min(len(self._q), spec.max_batch))]
            self._serve_batch(batch)

    def _serve_batch(self, batch: List[Tuple[Any, Future]]) -> None:
        requests = [r for r, _ in batch]
        futures = [f for _, f in batch]
        try:
            if self._serve_many is not None:
                results = self._serve_many(requests, **self._serve_kwargs)
            else:
                results = [self.engine.serve(r, **self._serve_kwargs)
                           for r in requests]
            if len(results) != len(requests):
                raise RuntimeError(
                    f"engine returned {len(results)} results for "
                    f"{len(requests)} requests")
        except BaseException as exc:          # noqa: BLE001 — futures carry it
            for fut in futures:
                if not fut.cancelled():
                    fut.set_exception(exc)
            return
        for fut, res in zip(futures, results):
            if not fut.cancelled():
                fut.set_result(res)
        with self._lock:
            self._completed += len(batch)
            self._microbatches += 1
            self._max_coalesced = max(self._max_coalesced, len(batch))
