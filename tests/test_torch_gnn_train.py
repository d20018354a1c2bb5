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
    with pytest.raises(NotImplementedError, match="A.15"):
        t_engine.PrefetchIterator(Boom(), code_gather=lambda b: b)


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
