"""The ported serving slice as a whole against the JAX package.

Reference run: a small spec built with the JAX package (500 nodes, c=16,
m=4, d_c=d_m=32, d_e=16, hidden 32, fanouts (3, 3), ``lookup_impl=
"pallas"``, ``serve_batch=32``) through ``repro.graph.runtime.GraphRuntime``
and its ``GraphInferenceEngine`` with the cache off and the Pallas kernel in
interpret mode.  The port loads the same spec from ``to_json()`` on the CPU
and the JAX init through ``params_from_jax``, then serves the same requests.

The cached engines (``serve()`` with the JAX default capacity,
``min(4·frontier_cap, n_nodes)``) serve a sequence with repeats in both
packages: the rows each request decodes and the cache's hit and miss
counts must be equal, and the port's cached engine must give its uncached
engine's embeddings and logits bitwise (on the CPU the decoder MLP's rows
do not depend on how many rows it runs).

Tolerances: frontiers and decoded rows are integer work and the in-order
gather-sum, so they must be bitwise.  Embeddings and logits go through
matmuls that torch's and XLA's CPU backends sum in different orders:
rtol = atol = 1e-5.  Predictions must match wherever the reference's top-2
logit margin exceeds 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.core import codes as jcodes
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro_torch.core import codes as tcodes
from repro_torch.core import embedding as temb
from repro_torch.core.backend import CachedDecodeBackend
from repro_torch.graph.runtime import ElasticSpec, GraphRuntime, RuntimeSpec
from repro_torch.interop import params_from_jax
from repro_torch.serving.gnn import GraphInferenceEngine

TOL = dict(rtol=1e-5, atol=1e-5)
N = 500
REQUESTS = [np.arange(32), np.array([5, 17, 499, 250, 5, 0, 3]),
            np.random.default_rng(0).choice(N, 32, replace=False)]


@pytest.fixture(scope="module")
def slice_pair():
    cfg = j_paper_cfg("sage", n_nodes=N, n_classes=6)
    cfg = dataclasses.replace(
        cfg, d_e=16, hidden=32, fanouts=(3, 3),
        embedding=dataclasses.replace(cfg.embedding, c=16, m=4, d_c=32, d_m=32,
                                      lookup_impl="pallas"))
    jspec = JSpec(graph=JSource(n_nodes=N, n_classes=6), model=cfg,
                  serve_batch=32, prefetch_depth=0)
    jrt = JRuntime.from_spec(jspec)
    np_params = jax.tree.map(lambda x: np.array(x), jrt.params)
    trt = GraphRuntime.from_spec(RuntimeSpec.from_json(jspec.to_json()), device="cpu",
                                 params=params_from_jax(np_params, device="cpu"))
    jeng = jrt.serve(cache_capacity=0)
    teng = trt.serve(cache_capacity=0)
    yield jspec, jrt, trt, jeng, teng
    jrt.close()


def _same_predictions(ref_logits, got_pred):
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(got_pred[sure], ref_logits.argmax(-1)[sure])


def test_spec_json_round_trips_unchanged(slice_pair):
    jspec, _, trt, _, _ = slice_pair
    assert trt.spec.to_dict() == jspec.to_dict()
    assert RuntimeSpec.from_json(trt.spec.to_json()) == trt.spec
    assert trt.device == torch.device("cpu")


def test_codes_and_graph_carry_over(slice_pair):
    _, jrt, trt, _, _ = slice_pair
    np.testing.assert_array_equal(np.asarray(jrt.params["embed"]["codes_buf"]),
                                  tcodes.to_uint32(trt.codes))
    np.testing.assert_array_equal(np.asarray(jrt.adj.indices), trt.adj.indices)
    np.testing.assert_array_equal(jrt.labels, trt.labels)


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_serve_matches_jax(slice_pair, i):
    _, jrt, trt, jeng, teng = slice_pair
    ids = REQUESTS[i]
    jf, tf = jeng.frontier_for(ids), teng.frontier_for(ids)
    np.testing.assert_array_equal(np.asarray(jf.unique), tf.unique)
    for a, b in zip(jf.index_maps, tf.index_maps):
        np.testing.assert_array_equal(np.asarray(a), b)

    # decoded rows: the JAX Pallas kernel (interpret) vs the port's kernel
    # backend, which on CPU tensors runs the kernel's plain version
    c, m = trt.cfg.embedding.c, trt.cfg.embedding.m
    jcodes_u = jcodes.unpack_codes(
        jnp.take(jrt.params["embed"]["codes_buf"], jnp.asarray(jf.unique), axis=0), c, m)
    jdec = np.asarray(jrt.model.backend.decode(
        jcodes_u, jrt.params["embed"]["decoder"]["codebooks"]))
    tcodes_u = temb.lookup_codes(trt.params["embed"], torch.as_tensor(tf.unique),
                                 trt.cfg.embedding_config())
    tdec = teng.model.backend.decode(tcodes_u, trt.params["embed"]["decoder"]["codebooks"])
    assert teng.model.backend.name == "pallas"
    np.testing.assert_array_equal(tdec.numpy(), jdec)

    jr, tr = jeng.serve(ids), teng.serve(ids)
    np.testing.assert_allclose(tr.embeddings, jr.embeddings, **TOL)
    np.testing.assert_allclose(tr.logits, jr.logits, **TOL)
    _same_predictions(jr.logits, tr.predictions)
    assert (tr.rows_decoded, tr.rows_total) == (jr.rows_decoded, jr.rows_total)


def test_serve_many_matches_jax_and_sequential(slice_pair):
    _, _, _, jeng, teng = slice_pair
    jres, tres = jeng.serve_many(REQUESTS), teng.serve_many(REQUESTS)
    for ids, j, t in zip(REQUESTS, jres, tres):
        assert t.embeddings.shape == (len(ids), 32) and t.batch_requests == 3
        np.testing.assert_allclose(t.embeddings, j.embeddings, **TOL)
        np.testing.assert_allclose(t.logits, j.logits, **TOL)
        _same_predictions(j.logits, t.predictions)
        np.testing.assert_allclose(t.embeddings, teng.serve(ids).embeddings, **TOL)
        assert t.rows_decoded == j.rows_decoded
    np.testing.assert_array_equal(teng.predict(REQUESTS[0]), teng.serve(REQUESTS[0]).predictions)


def test_embed_and_stats_match_jax(slice_pair):
    _, jrt, trt, _, _ = slice_pair
    ids = np.arange(3, 60, 3)
    np.testing.assert_allclose(trt.embed(ids), np.asarray(jrt.embed(ids)), **TOL)
    eng = trt.serve(cache_capacity=0)
    eng.serve(REQUESTS[0])
    eng.serve_many(REQUESTS[:2])
    st = eng.stats()
    assert st["requests"] == 3 and st["microbatches"] == 2
    assert st["rows_decoded"] == eng.frontier_cap * 3      # 1 + bucket of 2
    eng.reset()
    assert eng.stats()["requests"] == 0
    np.testing.assert_array_equal(eng.embed(REQUESTS[1]), eng.serve(REQUESTS[1]).embeddings)


def test_coalesced_frontier_is_what_serve_many_decodes(slice_pair):
    _, _, _, jeng, teng = slice_pair
    fb = teng.coalesced_frontier(REQUESTS)
    assert fb.unique.shape[0] == 4 * teng.frontier_cap      # 3 requests -> bucket of 4
    assert fb.unique.shape[0] == teng.serve_many(REQUESTS)[0].rows_decoded
    one = teng.coalesced_frontier(REQUESTS[2:])
    jf = jeng.frontier_for(REQUESTS[2])
    np.testing.assert_array_equal(one.unique, np.asarray(jf.unique))
    for a, b in zip(one.index_maps, jf.index_maps):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="max_coalesce"):
        teng.coalesced_frontier([REQUESTS[0]] * (teng.max_coalesce + 1))
    with pytest.raises(ValueError, match="max_coalesce"):
        teng.coalesced_frontier([])


def test_stage_timer_marks_the_serving_path(slice_pair):
    from repro_torch.stages import StageTimer
    teng = slice_pair[4]
    plain = teng.serve_many(REQUESTS[:2])
    with StageTimer() as t:
        timed = teng.serve_many(REQUESTS[:2])
    assert set(t.ms) == {"sample", "dedup", "h2d", "unpack", "decode", "mlp",
                         "sage", "logits", "d2h"}
    assert all(len(v) == 1 and v[0] >= 0.0 for v in t.ms.values())
    for a, b in zip(plain, timed):                          # timing changes no bit
        np.testing.assert_array_equal(a.embeddings, b.embeddings)
        np.testing.assert_array_equal(a.logits, b.logits)
    teng.serve(REQUESTS[0])                                 # inactive again
    assert all(len(v) == 1 for v in t.ms.values())


def test_from_spec_without_device_needs_cuda(slice_pair):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    spec = slice_pair[2].spec
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphRuntime.from_spec(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({"w": np.zeros(2, np.float32)})


def test_later_slices_raise(slice_pair):
    _, _, trt, _, _ = slice_pair
    spec = trt.spec
    # full-graph models, codes on the host, shards and elastic training are
    # ported (tests/test_torch_fullgraph.py, tests/test_torch_codes_offload.py,
    # tests/test_torch_sharded.py, tests/test_torch_elastic.py): an elastic
    # spec builds, and shards without a process group of that many ranks raise
    rt = GraphRuntime.from_spec(dataclasses.replace(spec, elastic=ElasticSpec()),
                                graph=(trt.adj, trt.labels), device="cpu", params=trt.params)
    assert rt.spec.elastic == ElasticSpec()
    rt.close()
    with pytest.raises(ValueError, match="process group"):
        GraphRuntime.from_spec(dataclasses.replace(spec, n_shards=2),
                               graph=(trt.adj, trt.labels), device="cpu", params=trt.params)
    with pytest.raises(ValueError, match="wrap itself"):
        trt.serve(decode_backend="sharded:owner")
    with pytest.raises(ValueError, match="family"):
        trt.serve(decode_backend="tt")
    with pytest.raises(ValueError, match="serve_batch"):
        trt.serve().serve(np.arange(33))


def test_seeded_init_is_deterministic(slice_pair):
    spec = slice_pair[2].spec
    a = GraphRuntime.from_spec(spec, device="cpu")
    b = GraphRuntime.from_spec(spec, graph=(a.adj, a.labels), device="cpu")
    assert torch.equal(a.codes, b.codes)
    assert torch.equal(a.params["w1"], b.params["w1"])
    assert isinstance(a.serve(cache_capacity=0), GraphInferenceEngine)


def test_cached_engine_matches_jax_and_the_uncached_engine(slice_pair):
    _, jrt, trt, _, teng = slice_pair
    jc, tc = jrt.serve(), trt.serve()
    assert tc.cached and tc.cache_capacity == jc.cache_capacity == N
    cap = 4 * tc.frontier_cap                                  # the miss buckets, as JAX's
    for n_miss in (0, 1, tc.pad_to, tc.pad_to + 1, cap - 1, cap):
        assert CachedDecodeBackend.miss_bucket(n_miss, tc.pad_to, cap) == jc._bucket(n_miss, cap)
    assert tc.frontier_for(REQUESTS[2]).n_decode is None      # the unpermuted frontier
    rng = np.random.default_rng(3)
    seq = [rng.choice(N, 32, replace=False) for _ in range(5)] + REQUESTS
    seq += seq[:4]                                             # warm repeats: all hits
    for ids in seq:
        j, t, u = jc.serve(ids), tc.serve(ids), teng.serve(ids)
        js, ts = jc.stats(), tc.stats()
        assert t.rows_decoded == j.rows_decoded
        assert (ts["hits"], ts["misses"]) == (js["hits"], js["misses"])
        np.testing.assert_allclose(t.embeddings, j.embeddings, **TOL)
        np.testing.assert_allclose(t.logits, j.logits, **TOL)
        np.testing.assert_array_equal(t.embeddings, u.embeddings)
        np.testing.assert_array_equal(t.logits, u.logits)
    assert t.rows_decoded == 0 and tc.stats()["hit_rate"] > 0.5
    jm, tm = jc.serve_many(seq[:3]), tc.serve_many(seq[:3])
    for j, t, ids in zip(jm, tm, seq[:3]):
        assert t.rows_decoded == j.rows_decoded and t.batch_requests == 3
        np.testing.assert_array_equal(t.embeddings, teng.serve(ids).embeddings)
    st, js = tc.stats(), jc.stats()
    for key in ("requests", "microbatches", "rows_decoded", "rows_total", "hits",
                "misses", "hit_rate"):
        assert st[key] == js[key], key
    tc.reset()
    after = tc.stats()
    assert (after["requests"], after["hits"], after["misses"]) == (0, 0, 0)
    assert tc.serve(seq[0]).rows_decoded == 0                  # the contents stay


@pytest.mark.parametrize("capacity", [64, 200])
def test_small_cache_evicts_as_jax_and_tracks_its_ids(slice_pair, capacity):
    """A cache smaller than the traffic (overflow at 64 slots, LRU eviction
    at both sizes): rows decoded and the hit and miss counters equal JAX's
    engine, the slot bookkeeping is JAX's bit for bit, outputs are within
    the file's tolerance of JAX's and bitwise the uncached engine's, and
    the host's table of cached ids is the slot ids' whenever it is not
    marked for a re-read."""
    _, jrt, trt, _, teng = slice_pair
    jc, tc = jrt.serve(cache_capacity=capacity), trt.serve(cache_capacity=capacity)
    rng = np.random.default_rng(capacity)
    seq = [rng.choice(N, 32, replace=False) for _ in range(6)] + REQUESTS
    seq += seq[:3]
    rereads = 0
    for ids in seq:
        j, t, u = jc.serve(ids), tc.serve(ids), teng.serve(ids)
        js, ts = jc.stats(), tc.stats()
        assert t.rows_decoded == j.rows_decoded
        assert (ts["hits"], ts["misses"]) == (js["hits"], js["misses"])
        np.testing.assert_allclose(t.embeddings, j.embeddings, **TOL)
        np.testing.assert_array_equal(t.embeddings, u.embeddings)
        np.testing.assert_array_equal(t.logits, u.logits)
        for f in ("node_ids", "version", "last_used", "clock"):
            np.testing.assert_array_equal(getattr(tc._cache_state, f).numpy(),
                                          np.asarray(getattr(jc._cache_state, f)), err_msg=f)
        node_ids = tc._cache_state.node_ids.numpy()
        if tc._held_stale:
            rereads += 1
        else:
            np.testing.assert_array_equal(np.flatnonzero(tc._held),
                                          np.sort(node_ids[node_ids >= 0]))
    assert rereads > 0 and ts["hits"] > 0


def test_cached_serving_marks_the_plan_and_cache_stages(slice_pair):
    from repro_torch.stages import StageTimer
    trt = slice_pair[2]
    eng = trt.serve()
    eng.serve(REQUESTS[0])
    with StageTimer() as t:
        eng.serve_many(REQUESTS)
    assert set(t.ms) == {"sample", "dedup", "plan", "h2d", "lookup", "unpack", "decode",
                         "mlp", "writeback", "sage", "logits", "d2h"}
    fb = eng.planned_frontier(REQUESTS[:1])
    assert fb.n_decode == 0 and fb.valid.sum() == fb.n_unique   # all cached now
