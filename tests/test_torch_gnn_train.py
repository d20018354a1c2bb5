"""The ported GNN training slice against the JAX package: the hashed
sampler, ``SageBatchSource``, ``PrefetchIterator``, the GNN train step,
``GraphRuntime.train`` / ``evaluate`` / ``resume`` and the ``hash_decode``
codebook gradient's plain version.

Reference runs: a 2,000-node power-law graph (identical in both packages),
the paper's GraphSAGE narrowed to c=16, m=4, d_c=d_m=32, d_e=16, hidden 32,
fanouts (3, 3), batch 64, ``lookup_impl="pallas"`` (the JAX Pallas kernel in
interpret mode; the port's kernel wrapper runs its plain version on CPU
tensors), AdamW lr 1e-2.  JAX's init is injected through ``params_from_jax``.

Tolerances: sampling, batches and the prefetch sequence are numpy, so
bitwise.  Losses over 5 steps within 1e-5 (f32 matmuls summed in other
orders by torch's and XLA's CPU backends); parameters after 5 steps within
1e-4 (Adam's first steps move a weight by about the learning rate whatever
its gradient's scale, so a rounding-level gradient difference moves it by
more than the forward error).  Measured: losses 8.3e-7, parameters 8.8e-6.  Evaluation: the same ``n``
and accuracy, loss within 1e-5.  Resuming on the CPU is bitwise.

Training with the hot-node cache (capacity 512): staleness 0 is the
uncached run bit for bit; staleness 4, plain and miss-planned, holds the
JAX runtime within the bounds above with bitwise hit and miss counters and
cache bookkeeping; planned batches and the shadow are bitwise JAX's; a
planned run resumes bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.graph import engine as j_engine
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro.graph.sampler import NeighborSampler as JSampler
from repro.graph.sampler import stream_key as j_stream_key
from repro.kernels.hash_decode import ops as j_hd_ops
from repro.optim import adamw as j_adamw
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import step as j_step
from repro_torch.graph import engine as t_engine
from repro_torch.graph.runtime import GraphRuntime, RuntimeSpec
from repro_torch.graph.sampler import NeighborSampler, stream_key
from repro_torch.interop import params_from_jax
from repro_torch.kernels.hash_decode import ops as hd_ops
from repro_torch.kernels.hash_decode.ref import hash_decode_backward_ref
from repro_torch.nn.module import leaves_with_path
from repro_torch.stages import StageTimer
from repro_torch.train import step as t_step

N, BATCH, STEPS = 2000, 64, 5
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4


def _jcfg():
    cfg = j_paper_cfg("sage", n_nodes=N, n_classes=6)
    return dataclasses.replace(
        cfg, d_e=16, hidden=32, fanouts=(3, 3),
        embedding=dataclasses.replace(cfg.embedding, c=16, m=4, d_c=32, d_m=32,
                                      lookup_impl="pallas"))


def _jspec(**kw):
    return JSpec(graph=JSource(n_nodes=N, n_classes=6), model=_jcfg(), batch_size=BATCH,
                 prefetch_depth=0, total_steps=STEPS, eval_batch=128, **kw)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def pair():
    """A JAX runtime and the port's runtime on the CPU from the same spec
    JSON, with the JAX init injected."""
    jrt = JRuntime.from_spec(_jspec())
    init = _np(jrt.state["params"])
    trt = GraphRuntime.from_spec(RuntimeSpec.from_json(jrt.spec.to_json()), device="cpu",
                                 params=params_from_jax(init, device="cpu"))
    yield jrt, trt, init
    jrt.close()
    trt.close()


def _assert_params_close(mine, ref_np, atol):
    ref = dict(leaves_with_path(params_from_jax(ref_np, device="cpu")))
    got = dict(leaves_with_path(mine))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        if r.dtype == torch.int64:
            assert torch.equal(got[path], r), "/".join(path)
        else:
            np.testing.assert_allclose(got[path].numpy(), r.numpy(), rtol=0, atol=atol,
                                       err_msg="/".join(path))


# ---------------- sampling and batch sources ----------------

@pytest.mark.parametrize("step,lo", [(0, 0), (7, 100), (123, 5000)])
def test_sample_hashed_bitwise(pair, step, lo):
    jrt, trt, _ = pair
    js = JSampler(jrt.adj, (3, 5), max_deg=8, seed=0)
    ts = NeighborSampler(trt.adj, (3, 5), max_deg=8, seed=0)
    ids = np.random.default_rng(step).integers(0, N, 40).astype(np.int32)
    gpos = np.arange(lo, lo + 40, dtype=np.uint64)
    assert stream_key(3, step) == j_stream_key(3, step)
    for a, b in zip(ts.sample_hashed(ids, gpos, stream_key(3, step)),
                    js.sample_hashed(ids, gpos, j_stream_key(3, step))):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32


def _sources(graph_pair, **kw):
    jrt, trt, _ = graph_pair
    tr = jrt.splits["train"]
    mk = dict(max_deg=32, seed=0)
    return (j_engine.SageBatchSource(JSampler(jrt.adj, (3, 3), **mk), tr, jrt.labels,
                                     BATCH, seed=7, **kw),
            t_engine.SageBatchSource(NeighborSampler(trt.adj, (3, 3), **mk), tr, trt.labels,
                                     BATCH, seed=7, **kw))


def _assert_batches_equal(a, b):
    np.testing.assert_array_equal(np.asarray(a["labels"]), np.asarray(b["labels"]))
    if "frontier" in a:
        fa, fb = a["frontier"], b["frontier"]
        np.testing.assert_array_equal(np.asarray(fa.unique), np.asarray(fb.unique))
        assert int(fa.n_unique) == int(fb.n_unique)
        assert len(fa.index_maps) == len(fb.index_maps)
        for ma, mb in zip(fa.index_maps, fb.index_maps):
            np.testing.assert_array_equal(np.asarray(ma), np.asarray(mb))
    else:
        for la, lb in zip(a["levels"], b["levels"]):
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


@pytest.mark.parametrize("dedup", [True, False])
def test_sage_batch_source_sequence_and_state_bitwise(pair, dedup):
    js, ts = _sources(pair, dedup=dedup, pad_to=32)
    for _ in range(4):
        _assert_batches_equal(js.next_batch(), ts.next_batch())
    assert ts.state_dict() == js.state_dict() == {"step": 4, "seed": 7, "shard": 0,
                                                  "n_shards": 1}
    _, fresh = _sources(pair, dedup=dedup, pad_to=32)
    fresh.load_state_dict(ts.state_dict())
    for _ in range(2):
        _assert_batches_equal(js.next_batch(), fresh.next_batch())
    with pytest.raises(ValueError, match="different run"):
        fresh.load_state_dict({"step": 1, "seed": 8})


def test_sharded_slices_union_to_one_global_batch(pair):
    jrt, trt, _ = pair
    sampler = NeighborSampler(trt.adj, (3, 3), max_deg=32)
    tr = trt.splits["train"]
    whole = t_engine.SageBatchSource(sampler, tr, trt.labels, 2 * BATCH, dedup=False)
    halves = [t_engine.SageBatchSource(sampler, tr, trt.labels, BATCH, dedup=False,
                                       shard=s, n_shards=2) for s in range(2)]
    w = whole.next_batch()
    h = [s.next_batch() for s in halves]
    for i, lvl in enumerate(w["levels"]):
        np.testing.assert_array_equal(lvl, np.concatenate([x["levels"][i] for x in h]))


# ---------------- PrefetchIterator (mirrors tests/test_engine.py) ----------------

def _tsource(pair):
    return _sources(pair, pad_to=32)[1]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetch_matches_sync_sequence(pair, device):
    sync = _tsource(pair)
    expect = [sync.next_batch() for _ in range(8)]
    with t_engine.PrefetchIterator(_tsource(pair), depth=3, device=device) as pf:
        got = [pf.next_batch() for _ in range(8)]
    for a, b in zip(expect, got):
        _assert_batches_equal(a, b)
        if device == "cpu":
            assert isinstance(b["labels"], torch.Tensor) and b["labels"].dtype == torch.int64


def test_prefetch_state_resume(pair):
    pf = t_engine.PrefetchIterator(_tsource(pair), depth=3)
    try:
        for _ in range(3):
            pf.next_batch()
        snap = pf.state_dict()
        expect = [pf.next_batch()["labels"] for _ in range(3)]
    finally:
        pf.close()
    assert snap == {"step": 3, "seed": 7, "shard": 0, "n_shards": 1}
    pf2 = t_engine.PrefetchIterator(_tsource(pair), depth=3)
    try:
        pf2.next_batch()          # run ahead, then rewind
        pf2.load_state_dict(snap)
        got = [pf2.next_batch()["labels"] for _ in range(3)]
    finally:
        pf2.close()
    np.testing.assert_array_equal(np.stack(expect), np.stack(got))


def test_prefetch_reusable_after_close(pair):
    sync = _tsource(pair)
    expect = [sync.next_batch()["labels"] for _ in range(6)]
    pf = t_engine.PrefetchIterator(_tsource(pair), depth=3)
    try:
        got = [pf.next_batch()["labels"] for _ in range(3)]
        pf.close()
        assert pf.stats()["n_produced"] >= 3
        got += [pf.next_batch()["labels"] for _ in range(3)]
    finally:
        pf.close()
    np.testing.assert_array_equal(np.stack(expect), np.stack(got))


def test_prefetch_propagates_source_errors_and_refuses_code_gather():
    class Boom:
        def next_batch(self):
            raise RuntimeError("boom")
    pf = t_engine.PrefetchIterator(Boom(), depth=1)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            pf.next_batch()
    finally:
        pf.close()
    # the code gather (codes on the host) runs in the producer too: its
    # errors reach the consumer the same way

    class One:
        def next_batch(self):
            return {"labels": np.zeros(1)}

    def bad_gather(batch):
        raise RuntimeError("gather")
    pf = t_engine.PrefetchIterator(One(), depth=1, code_gather=bad_gather)
    try:
        with pytest.raises(RuntimeError, match="gather"):
            pf.next_batch()
    finally:
        pf.close()


def test_stage_timer_marks_the_training_step_and_ignores_the_producer(pair):
    _, trt, init = pair
    spec = dataclasses.replace(trt.spec, prefetch_depth=2)
    rt = GraphRuntime.from_spec(spec, graph=(trt.adj, trt.labels), device="cpu",
                                params=params_from_jax(init, device="cpu"))
    try:
        with StageTimer() as t:
            rt.train_step(rt.state, _tsource(pair).next_batch())
            for _ in range(3):              # sampled in the producer thread
                rt.data_iter.next_batch()
    finally:
        rt.close()
    assert rt.data_iter.stats()["n_produced"] >= 3
    assert set(t.ms) == {"sample", "dedup", "h2d", "unpack", "decode", "mlp", "sage",
                         "logits", "loss", "backward", "optimizer"}
    assert len(t.ms["sample"]) == 1 and len(t.ms["dedup"]) == 1


# ---------------- the train step and the runtime ----------------

def test_five_train_steps_match_jax(pair):
    jrt, trt, init = pair
    jcfg, opt = _jcfg(), JAdamW(lr=1e-2, weight_decay=0.0)
    jparams = jax.tree.map(jnp.asarray, init)
    jstate = {"params": jparams, "opt": j_adamw.adamw_init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    jfn = jax.jit(j_step.make_gnn_train_step(jcfg, opt, interpret=True))
    tstate = t_step.init_gnn_train_state(None, trt.cfg,
                                         params=params_from_jax(init, device="cpu"))
    tfn = t_step.make_gnn_train_step(trt.cfg, trt.spec.optimizer, "cpu")
    js, ts = _sources(pair, pad_to=32)
    jl, tl = [], []
    for _ in range(STEPS):
        jstate, jm = jfn(jstate, js.next_batch())
        tstate, tm = tfn(tstate, ts.next_batch())
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    assert tstate["step"] == STEPS and tstate["opt"]["step"] == STEPS
    _assert_params_close(tstate["params"], _np(jstate["params"]), PARAM_TOL)


def test_runtime_train_and_evaluate_match_jax(pair):
    jrt, trt, _ = pair
    jres = jrt.train(STEPS)
    tres = trt.train(STEPS)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=0, atol=LOSS_TOL)
    _assert_params_close(trt.params, _np(jrt.params), PARAM_TOL)
    for split in ("val", "test"):
        je, te = jrt.evaluate(split), trt.evaluate(split)
        assert te["n"] == je["n"] == len(trt.splits[split])
        assert te["accuracy"] == je["accuracy"]
        assert abs(te["loss"] - je["loss"]) <= 1e-5
    assert trt.spec.to_dict() == jrt.spec.to_dict()


def test_naive_levels_step_matches_the_dedup_step(pair):
    _, trt, init = pair
    spec = dataclasses.replace(trt.spec, dedup=False)
    naive = GraphRuntime.from_spec(spec, graph=(trt.adj, trt.labels), device="cpu",
                                   params=params_from_jax(init, device="cpu"))
    dedup = GraphRuntime.from_spec(trt.spec, graph=(trt.adj, trt.labels), device="cpu",
                                   params=params_from_jax(init, device="cpu"))
    a, b = naive.train(2).losses, dedup.train(2).losses
    np.testing.assert_allclose(a, b, rtol=0, atol=LOSS_TOL)


def _assert_same_tree(a, b):
    a, b = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), "/".join(k)


def test_resume_continues_bitwise(pair, tmp_path):
    """6 straight steps equal 3 steps, ``GraphRuntime.resume`` and 3 more,
    bit for bit (mirrors tests/test_runtime.py's round trip)."""
    _, trt, init = pair
    graph = (trt.adj, trt.labels)

    def make(d):
        spec = dataclasses.replace(trt.spec, ckpt_dir=str(tmp_path / d), ckpt_every=3,
                                   prefetch_depth=2)
        return GraphRuntime.from_spec(spec, graph=graph, device="cpu",
                                      params=params_from_jax(init, device="cpu"))

    full = make("full")
    res_full = full.train(6)
    part = make("part")
    part.train(3)
    part.close()
    resumed = GraphRuntime.resume(str(tmp_path / "part"), graph=graph, device="cpu")
    assert resumed.spec == part.spec
    _assert_same_tree(part.params, resumed.params)     # live before any train
    assert resumed.state["step"] == 3 and resumed.state["opt"]["step"] == 3
    res_tail = resumed.train(6)
    assert res_tail.resumed_from == 3
    assert res_tail.losses == res_full.losses[3:]
    _assert_same_tree(full.params, resumed.params)
    engine = resumed.serve()
    resumed.close()
    assert torch.equal(engine.params["w1"], resumed.params["w1"])
    assert engine.params["w1"] is not resumed.params["w1"]   # frozen copy
    with pytest.raises(FileNotFoundError):
        GraphRuntime.resume(str(tmp_path / "nothing"), graph=graph, device="cpu")


def test_two_gradients_of_one_step_are_bitwise_equal(pair):
    _, trt, _ = pair
    from repro_torch.models import gnn
    from repro_torch.nn.module import value_and_grad
    batch = t_engine.batch_to(_tsource(pair).next_batch(), torch.device("cpu"))

    def loss_fn(p):
        h = trt.model.apply(p, batch)
        return gnn.node_loss(trt.model.logits(p, h), batch["labels"])

    _, ga = value_and_grad(loss_fn, trt.params)
    _, gb = value_and_grad(loss_fn, trt.params)
    for (pa, a), (_, b) in zip(leaves_with_path(ga), leaves_with_path(gb)):
        assert torch.equal(a, b), "/".join(pa)


# ---------------- the hash_decode codebook gradient ----------------

def _bwd_inputs(B, m, c, d_c, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, c, (B, m)).astype(np.int32)
    # a wide dynamic range, so another summation order changes the bits
    g = (rng.standard_normal((B, d_c)) * np.exp(3 * rng.standard_normal((B, 1))))
    return codes, g.astype(np.float32), rng.standard_normal(d_c).astype(np.float32)


@pytest.mark.parametrize("B,m,c,d_c", [(300, 3, 4, 33), (257, 4, 16, 130)])
def test_backward_plain_version_is_the_ascending_python_loop(B, m, c, d_c):
    codes, g, w0 = _bwd_inputs(B, m, c, d_c, seed=B)
    for w in (None, w0):
        gw = g * w[None, :] if w is not None else g
        loop = np.zeros((m, c, d_c), np.float32)
        for b in range(B):
            for j in range(m):
                loop[j, codes[b, j]] += gw[b]
        got = hash_decode_backward_ref(torch.from_numpy(codes), torch.from_numpy(g),
                                       None if w is None else torch.from_numpy(w), c,
                                       torch.float32)
        np.testing.assert_array_equal(got.numpy(), loop)
        reverse = hash_decode_backward_ref(torch.from_numpy(codes[::-1].copy()),
                                           torch.from_numpy(g[::-1].copy()),
                                           None if w is None else torch.from_numpy(w), c,
                                           torch.float32)
        assert not torch.equal(reverse, got)     # the order is what is tested


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_bwd_and_is_deterministic(dtype):
    B, m, c, d_c = 500, 8, 16, 64
    codes, g, w0 = _bwd_inputs(B, m, c, d_c, seed=3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cb = np.random.default_rng(4).standard_normal((m, c, d_c)).astype(np.float32)
    _, jd_cb, jd_w0 = j_hd_ops._bwd(None, None, True, True,
                                    (jnp.asarray(codes), jnp.asarray(cb).astype(jdt),
                                     jnp.asarray(w0)), jnp.asarray(g))
    tcb = torch.from_numpy(cb).to(tdt)
    a = hd_ops.hash_decode_backward(torch.from_numpy(codes), tcb, torch.from_numpy(w0),
                                    torch.from_numpy(g))
    b = hd_ops.hash_decode_backward(torch.from_numpy(codes), tcb, torch.from_numpy(w0),
                                    torch.from_numpy(g))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == tdt and a[1].dtype == torch.float32
    ref = np.asarray(jd_cb.astype(jnp.float32))
    scale = np.abs(ref).max()
    tol = 1e-5 if dtype == "float32" else 8e-3      # one bf16 rounding of other sums
    np.testing.assert_allclose(a[0].float().numpy(), ref, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(a[1].numpy(), np.asarray(jd_w0), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jd_w0)).max())
    before = hd_ops.hash_decode_backward.launches
    hd_ops.codebook_grad(torch.from_numpy(codes), torch.from_numpy(g), None, c, tdt)
    assert hd_ops.hash_decode_backward.launches == before     # CPU: the plain version


def test_backward_refuses_other_devices():
    codes = torch.zeros(4, 2, dtype=torch.int32, device="meta")
    g = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        hd_ops.codebook_grad(codes, g, None, 16, torch.float32)


# ---------------- training with the hot-node cache ----------------

CACHE = dict(cache_capacity=512)


def _cached_spec(spec, **emb):
    return dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, embedding=dataclasses.replace(spec.model.embedding, **emb)))


def _cached_run(pair, steps=STEPS, **emb):
    """The port's runtime with the cache options ``emb``, from the JAX init:
    (losses, per-step metrics, the runtime)."""
    _, trt, init = pair
    rt = GraphRuntime.from_spec(_cached_spec(trt.spec, **emb), graph=(trt.adj, trt.labels),
                                device="cpu", params=params_from_jax(init, device="cpu"))
    step, metrics = rt.train_step, []

    def recording(state, batch):
        state, m = step(state, batch)
        metrics.append({k: float(v) if k == "loss" else int(v) for k, v in m.items()})
        return state, m
    rt.train_step = recording
    res = rt.train(steps)
    rt.close()
    return res.losses, metrics, rt


def _assert_cache_is_shadow(cache, shadow):
    book = cache.bookkeeping()
    for f in ("node_ids", "version", "last_used"):
        np.testing.assert_array_equal(np.asarray(shadow[f]), book[f], err_msg=f)
    assert (shadow["clock"], shadow["version_counter"]) == (book["clock"],
                                                            book["version_counter"])


def test_cached_staleness0_training_is_the_uncached_run(pair):
    """At staleness 0 every entry is stale after the step's version bump, so
    each step decodes every row: the losses and params are the uncached
    run's bit for bit, with no hit (the port's counterpart of the JAX
    package's ``test_cached_staleness0_exact_on_streaming_engine``)."""
    plain, _, rt0 = _cached_run(pair)
    cached, metrics, rt = _cached_run(pair, cache_staleness=0, **CACHE)
    assert cached == plain
    _assert_same_tree(rt.params, rt0.params)
    assert metrics[-1]["cache_hits"] == 0 and metrics[-1]["cache_misses"] > 0
    assert "cache" in rt.state and "cache" not in rt0.state


@pytest.mark.parametrize("plan", [False, True])
def test_cached_training_matches_jax(pair, plan):
    """Staleness 4, plain and miss-planned, against the JAX runtime of the
    same spec: 5 losses within 1e-5 and params within 1e-4 (the file's
    bounds), the hit and miss counters and the cache's bookkeeping
    bitwise, its values within the params' bound."""
    emb = dict(CACHE, cache_staleness=4, cache_plan_misses=plan)
    jrt = JRuntime.from_spec(_cached_spec(_jspec(log_every=1), **emb))
    jl = []
    try:
        jrt.train(STEPS, on_metrics=lambda s, m: jl.append(float(m["loss"])))
    finally:
        jrt.close()
    tl, metrics, rt = _cached_run(pair, **emb)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=LOSS_TOL)
    _assert_params_close(rt.params, _np(jrt.params), PARAM_TOL)
    jc, tc = jrt.state["cache"], rt.state["cache"]
    assert metrics[-1]["cache_hits"] == int(jc.hits) > 0
    assert metrics[-1]["cache_misses"] == int(jc.misses)
    for f in ("node_ids", "version", "last_used", "version_counter", "clock"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)))
    np.testing.assert_allclose(tc.values.numpy(), np.asarray(jc.values), rtol=0,
                               atol=PARAM_TOL)


def test_planned_batches_match_jax(pair):
    """``MissPlanningSource`` over the same batch sequence in both packages:
    the miss-first permutation, remapped index maps, ``valid``, the
    bucketed ``n_decode`` and the shadow are bitwise JAX's (its update never
    reads a value, so no training is needed)."""
    js, ts = _sources(pair, pad_to=32)
    jp = j_engine.MissPlanningSource(js, 256, staleness=2, pad_to=32)
    tp = t_engine.MissPlanningSource(ts, 256, staleness=2, pad_to=32)
    decoded = []
    for _ in range(6):
        a, b = jp.next_batch(), tp.next_batch()
        _assert_batches_equal(a, b)
        fa, fb = a["frontier"], b["frontier"]
        np.testing.assert_array_equal(fb.valid, np.asarray(fa.valid))
        assert fb.n_decode == fa.n_decode
        assert fb.n_decode % 32 == 0 or fb.n_decode == fb.unique.shape[0]
        decoded.append(fb.n_decode)
    assert min(decoded) < max(decoded)          # the warm cache decodes fewer rows
    snap = tp.state_dict()["miss_shadow"]
    for f in ("node_ids", "version", "last_used"):
        np.testing.assert_array_equal(snap[f], getattr(jp.shadow, f), err_msg=f)
    assert (snap["clock"], snap["version_counter"]) == (jp.shadow.clock,
                                                        jp.shadow.version_counter)


def test_planned_run_against_the_plain_cached_run(pair):
    """Planned and plain cached training at staleness 4 count the same hits
    and misses in every step, and the shadow equals the cache's bookkeeping
    after the run.  The planned run decodes the same miss rows in another
    order (miss-first), so the decoder's weight-gradient sums run over
    other row counts: losses within 1e-5 and params within 1e-4 (measured
    on the CPU: bitwise for four steps, 1.2e-7 at the fifth)."""
    pl, pm, prt = _cached_run(pair, cache_staleness=4, cache_plan_misses=True, **CACHE)
    ql, qm, qrt = _cached_run(pair, cache_staleness=4, **CACHE)
    assert [(m["cache_hits"], m["cache_misses"]) for m in pm] == \
        [(m["cache_hits"], m["cache_misses"]) for m in qm]
    np.testing.assert_allclose(pl, ql, rtol=0, atol=LOSS_TOL)
    for (path, a), (_, b) in zip(leaves_with_path(prt.params), leaves_with_path(qrt.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=PARAM_TOL,
                                   err_msg="/".join(path))
    _assert_cache_is_shadow(prt.state["cache"], prt.data_iter.state_dict()["miss_shadow"])


def test_planned_resume_restores_the_shadow_and_the_sequence(pair, tmp_path):
    """6 straight planned steps equal 3, ``GraphRuntime.resume`` and 3 more,
    bit for bit: losses, params, the ``CacheState`` and the shadow."""
    _, trt, init = pair
    graph = (trt.adj, trt.labels)

    def make(d):
        spec = dataclasses.replace(
            _cached_spec(trt.spec, cache_staleness=4, cache_plan_misses=True, **CACHE),
            ckpt_dir=str(tmp_path / d), ckpt_every=3, prefetch_depth=2)
        return GraphRuntime.from_spec(spec, graph=graph, device="cpu",
                                      params=params_from_jax(init, device="cpu"))

    full = make("full")
    res_full = full.train(6)
    part = make("part")
    part.train(3)
    part.close()
    resumed = GraphRuntime.resume(str(tmp_path / "part"), graph=graph, device="cpu")
    _assert_cache_is_shadow(resumed.state["cache"],
                            resumed.data_iter.source.shadow.snapshot())
    res_tail = resumed.train(6)
    assert res_tail.resumed_from == 3 and res_tail.losses == res_full.losses[3:]
    _assert_same_tree(full.params, resumed.params)
    for f in ("node_ids", "values", "version", "last_used", "version_counter", "clock",
              "hits", "misses"):
        assert torch.equal(getattr(resumed.state["cache"], f),
                           getattr(full.state["cache"], f)), f
    a, b = (rt.data_iter.state_dict()["miss_shadow"] for rt in (full, resumed))
    _assert_cache_is_shadow(full.state["cache"], b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    resumed.close()


def test_plan_misses_spec_is_validated(pair):
    _, trt, _ = pair
    graph = (trt.adj, trt.labels)
    with pytest.raises(ValueError, match="cache_capacity"):
        GraphRuntime.from_spec(_cached_spec(trt.spec, cache_plan_misses=True), graph=graph,
                               device="cpu", params=trt.params)
    with pytest.raises(ValueError, match="single-shard dedup"):
        GraphRuntime.from_spec(dataclasses.replace(
            _cached_spec(trt.spec, cache_plan_misses=True, **CACHE), dedup=False),
            graph=graph, device="cpu", params=trt.params)
