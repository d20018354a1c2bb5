"""The continuous-batching serving tier (``repro_torch.serving.batcher``)
against the JAX package's, on the CPU: the contracts of the JAX package's
``tests/test_serving.py`` (concurrent equals sequential, backpressure,
drain, error propagation, ``max_batch`` validation, the spec's JSON round
trip and ``GraphRuntime.serve`` returning a batcher when the spec asks).

Reference run: a 1,200-node power-law graph and the paper's GraphSAGE
narrowed to c=16, m=8, d_c=d_m=64, fanout 5, ``lookup_impl="gather"``,
``serve_batch=64``, built by the JAX package; the port loads its spec JSON
and its init through ``params_from_jax``.

Tolerances: concurrent batched responses are bitwise the port's sequential
ones (content-keyed frontiers, row-pure decode, the CPU's row-invariant
MLP); against the JAX package's sequential responses rtol = atol = 1e-5
(matmuls summed in other orders by torch's and XLA's CPU backends).
"""

import dataclasses
import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro.serving import BatchingSpec as JBatchingSpec
from repro_torch.graph.runtime import GraphRuntime, RuntimeSpec
from repro_torch.interop import params_from_jax
from repro_torch.serving import (BatchingSpec, GraphInferenceEngine, Overloaded,
                                 ServingBatcher)

N = 1200
TOL = dict(rtol=1e-5, atol=1e-5)


def _jspec(**kw):
    cfg = j_paper_cfg("sage", n_nodes=N, n_classes=8, fanout=5)
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, c=16, m=8, d_c=64, d_m=64, lookup_impl="gather"))
    return JSpec(graph=JSource(kind="powerlaw", seed=0, n_nodes=N, n_classes=8,
                               avg_degree=8, homophily=0.9),
                 model=cfg, batch_size=64, prefetch_depth=0, serve_batch=64, **kw)


@pytest.fixture(scope="module")
def pair():
    jrt = JRuntime.from_spec(_jspec())
    init = jax.tree.map(np.array, jrt.params)
    rt = GraphRuntime.from_spec(RuntimeSpec.from_json(jrt.spec.to_json()), device="cpu",
                                params=params_from_jax(init, device="cpu"))
    yield jrt, rt
    jrt.close()
    rt.close()


def _requests(rng, n, overlap):
    """n requests of 8–64 nodes, each sharing ``overlap`` hub ids."""
    hubs = rng.choice(N, overlap, replace=False)
    return [np.concatenate([hubs, rng.choice(N, int(rng.integers(8, 64)) - overlap,
                                             replace=False)]).astype(np.int32)
            for _ in range(n)]


def test_concurrent_batched_equals_sequential_and_jax(pair):
    jrt, rt = pair
    rng = np.random.default_rng(7)
    reqs = _requests(rng, 12, overlap=3)
    jseq = jrt.serve()
    seq_engine = rt.serve()
    seq = [seq_engine.serve(r) for r in reqs]
    with rt.serve(batching=BatchingSpec(max_batch=4, max_delay_ms=20.0)) as sb:
        assert isinstance(sb, ServingBatcher) and sb.engine.cached
        order = rng.permutation(len(reqs))
        with ThreadPoolExecutor(8) as ex:
            futs = {int(i): ex.submit(sb.serve, reqs[i]) for i in order}
        for i, s in enumerate(seq):
            b = futs[i].result()
            np.testing.assert_array_equal(b.embeddings, s.embeddings)
            np.testing.assert_array_equal(b.logits, s.logits)
            np.testing.assert_array_equal(b.predictions, s.predictions)
            j = jseq.serve(reqs[i])
            np.testing.assert_allclose(b.embeddings, j.embeddings, **TOL)
            np.testing.assert_allclose(b.logits, j.logits, **TOL)
        st = sb.stats()
        assert st["completed"] == len(reqs) and st["shed"] == 0
        assert st["max_coalesced"] > 1, "concurrent submits should coalesce"
        assert st["engine"]["requests"] == len(reqs)


def test_serve_many_dedups_across_requests(pair):
    _, rt = pair
    reqs = _requests(np.random.default_rng(11), 8, overlap=4)
    seq_engine = rt.serve()
    for r in reqs:
        seq_engine.serve(r)
    bat_engine = rt.serve(max_coalesce=4)
    results = bat_engine.serve_many(reqs[:4]) + bat_engine.serve_many(reqs[4:])
    st = bat_engine.stats()
    assert st["rows_decoded"] < seq_engine.stats()["rows_decoded"]
    assert all(r.batch_requests == 4 for r in results)
    assert st["rows_total"] == len(reqs) * bat_engine.frontier_cap
    with pytest.raises(ValueError, match="max_coalesce"):
        rt.serve(max_coalesce=2).serve_many([np.arange(4, dtype=np.int32)] * 3)


class _SlowEngine:
    """An engine whose serves block until released: makes the queue's
    occupancy deterministic."""

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()
        self.served = []

    def serve(self, request, **_ignored):
        self.started.set()
        self.release.wait(timeout=10)
        self.served.append(np.asarray(request))
        return len(self.served)


def test_backpressure_sheds_loudly():
    eng = _SlowEngine()
    sb = ServingBatcher(eng, BatchingSpec(max_batch=1, max_delay_ms=0.0, queue_depth=2))
    try:
        first = sb.submit(0)              # the worker takes it and blocks
        assert eng.started.wait(timeout=10)
        admitted = [sb.submit(1), sb.submit(2)]
        with pytest.raises(Overloaded) as ei:
            sb.submit(3)
        assert ei.value.queued == 2 and ei.value.retry_after_s > 0
        eng.release.set()
        assert first.result(timeout=10) == 1
        assert [f.result(timeout=10) for f in admitted] == [2, 3]
        st = sb.stats()
        assert st["shed"] == 1 and st["completed"] == 3
    finally:
        eng.release.set()
        sb.close()


def test_close_drains_admitted_requests():
    eng = _SlowEngine()
    eng.release.set()
    sb = ServingBatcher(eng, BatchingSpec(max_batch=4, max_delay_ms=1.0))
    futs = [sb.submit(i) for i in range(10)]
    sb.close()
    assert sorted(f.result(timeout=0) for f in futs) == list(range(1, 11))
    with pytest.raises(RuntimeError, match="closed"):
        sb.submit(99)


def test_engine_error_propagates_to_futures():
    class _Boom:
        def serve(self, request, **_ignored):
            raise RuntimeError("boom")
    with ServingBatcher(_Boom(), BatchingSpec(max_batch=2)) as sb:
        with pytest.raises(RuntimeError, match="boom"):
            sb.serve(0)


def test_batcher_validates_max_batch_against_engine(pair):
    eng = pair[1].serve(max_coalesce=2)
    with pytest.raises(ValueError, match="max_coalesce"):
        ServingBatcher(eng, BatchingSpec(max_batch=4))
    for bad in (dict(max_batch=0), dict(queue_depth=0), dict(max_delay_ms=-1.0)):
        with pytest.raises(ValueError):
            BatchingSpec(**bad)


def test_batching_spec_json_round_trip_with_jax():
    jspec = _jspec(batching=JBatchingSpec(max_batch=4, max_delay_ms=5.0, queue_depth=32))
    spec = RuntimeSpec.from_json(jspec.to_json())
    assert spec.batching == BatchingSpec(4, 5.0, 32)
    assert spec.to_dict() == jspec.to_dict()
    assert RuntimeSpec.from_json(spec.to_json()) == spec
    assert RuntimeSpec.from_json(_jspec().to_json()).batching is None


def test_runtime_serve_returns_a_batcher_when_the_spec_asks(pair):
    jrt, rt = pair
    spec = dataclasses.replace(rt.spec, batching=BatchingSpec(max_batch=4))
    batched = GraphRuntime.from_spec(spec, graph=(rt.adj, rt.labels), device="cpu",
                                     params=rt.params)
    with batched.serve() as tier:
        assert isinstance(tier, ServingBatcher)
        assert tier.engine.max_coalesce == 4           # sized from the spec
        res = tier.serve(np.arange(8, dtype=np.int32))
        assert res.embeddings.shape == (8, rt.cfg.hidden)
        np.testing.assert_array_equal(res.embeddings,
                                      rt.serve().serve(np.arange(8)).embeddings)
    assert isinstance(batched.serve(batching=False), GraphInferenceEngine)
    with rt.serve(batching=True) as tier:
        assert tier.spec == BatchingSpec()
    batched.close()


def test_many_threads_each_get_their_own_result():
    """32 client threads (more than this machine's cores) submit 256
    requests with the interpreter switching threads every microsecond: every
    admitted request resolves to its own result, once, and the counters add
    up (a lost update in the queue or the counters would break one)."""
    import sys

    class _Echo:
        max_coalesce = 8

        def serve_many(self, requests, **_ignored):
            return [int(r) * 2 for r in requests]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ServingBatcher(_Echo(), BatchingSpec(max_batch=8, max_delay_ms=0.5,
                                                  queue_depth=256)) as sb:
            with ThreadPoolExecutor(32) as ex:
                futs = [ex.submit(sb.serve, i) for i in range(256)]
                got = [f.result(timeout=30) for f in futs]
            st = sb.stats()
    finally:
        sys.setswitchinterval(interval)
    assert got == [2 * i for i in range(256)]
    assert st["submitted"] == st["completed"] == 256 and st["shed"] == 0
    assert st["queued"] == 0 and st["max_coalesced"] <= 8
