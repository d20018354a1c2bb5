"""The ported full-graph slice against the JAX package: the normalised
adjacency and its device-resident product, the link-prediction split and
the consumer × merchant graph, epoch minibatches, the full-graph GCN / SGC
/ GIN forward, ``GraphRuntime`` over them (train, evaluate, embed, resume),
and the link and merchant metrics.

Reference runs: a 2,000-node power-law graph (identical in both packages),
the paper's models narrowed as ``tests/test_gnn.py`` narrows them (c=16,
m=8, d_c=d_m=64; d_e 64, hidden 128), JAX's decode through ``"gather"``
and the port's through its kernel wrapper (``"pallas"``: the plain version
on CPU tensors, bitwise the gather), AdamW lr 1e-2.  JAX's init is
injected through ``params_from_jax``.

Tolerances: the graph builders, the split and the minibatches are numpy,
so bitwise.  The device product's forward is ``CSRMatrix.matmat``'s ops,
so bitwise; its backward against a dense Aᵀ·G within 1e-6 (other
summation orders), and bitwise against itself.  The forward against JAX's
within 1e-5 (f32 matmuls summed in other orders by torch's and XLA's CPU
backends); over 5 ``GraphRuntime.train`` steps, each from JAX's state, the
loss within 1e-5 and the parameters within 1e-4, evaluation within 1e-5
(the GraphSAGE runtime tests' bounds).  Link loss and
scores within 1e-6; hits@K and hit@k exactly.  Resuming is bitwise.  The
port's own learning runs are in ``tests/test_torch_fullgraph_learn.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.graph.generate import bipartite_transaction_graph as j_bipartite
from repro.graph.generate import holdout_edges as j_holdout
from repro.graph.generate import powerlaw_graph as j_powerlaw
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro.graph.sampler import NeighborSampler as JSampler
from repro.models import gnn as jgnn
from repro_torch.configs.paper_gnn import paper_gnn_config
from repro_torch.core import lsh
from repro_torch.graph import engine as t_engine
from repro_torch.graph.csr import CSRMatrix
from repro_torch.graph.generate import bipartite_transaction_graph, holdout_edges, powerlaw_graph
from repro_torch.graph.runtime import GraphRuntime, RuntimeSpec
from repro_torch.graph.sampler import NeighborSampler
from repro_torch.interop import params_from_jax
from repro_torch.models import gnn as tgnn
from repro_torch.nn.module import is_trainable, leaves_with_path, value_and_grad
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import gnn_loss

N, N_CLASSES, STEPS = 2000, 8, 5
FWD_TOL, LOSS_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4
MODELS = ("gcn", "sgc", "gin")


def _narrow(cfg, **emb):
    return dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, c=16, m=8, d_c=64, d_m=64, **emb))


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _jspec(model, **opt):
    cfg = _narrow(j_paper_cfg(model, n_nodes=N, n_classes=N_CLASSES), lookup_impl="gather")
    spec = JSpec(graph=JSource(n_nodes=N, n_classes=N_CLASSES), model=cfg, total_steps=STEPS)
    return dataclasses.replace(spec, optimizer=dataclasses.replace(spec.optimizer, **opt))


def _tspec(jspec):
    """The JAX spec through its JSON, decoding through the port's kernel
    wrapper."""
    spec = RuntimeSpec.from_json(jspec.to_json())
    cfg = spec.model
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(cfg.embedding,
                                                                 lookup_impl="pallas"))
    return dataclasses.replace(spec, model=cfg)


@pytest.fixture(scope="module")
def graph():
    jadj, jlabels = j_powerlaw(0, N, avg_degree=8, n_classes=N_CLASSES, homophily=0.9)
    tadj, tlabels = powerlaw_graph(0, N, avg_degree=8, n_classes=N_CLASSES, homophily=0.9)
    np.testing.assert_array_equal(tlabels, jlabels)
    return jadj, tadj, tlabels


def _make_pair(model, **opt):
    """A JAX runtime and the port's on the CPU from one spec (``opt``
    overrides its AdamW config), JAX's init injected."""
    jrt = JRuntime.from_spec(_jspec(model, **opt))
    init = _np(jrt.state["params"])
    trt = GraphRuntime.from_spec(_tspec(jrt.spec), device="cpu",
                                 params=params_from_jax(init, device="cpu"))
    return jrt, trt, init


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    jrt, trt, init = _make_pair(request.param)
    yield jrt, trt, init
    jrt.close()
    trt.close()


def _same_csr(t: CSRMatrix, j) -> None:
    for a, b in ((t.data, j.data), (t.indices, j.indices), (t.indptr, j.indptr)):
        b = np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t.shape == j.shape


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


def _same_tree(a, b) -> None:
    a, b = dict(leaves_with_path(a)), dict(leaves_with_path(b))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), "/".join(k)


# ---------------- graphs, splits and batches: bitwise ----------------

@pytest.mark.parametrize("kind", ["sym", "row"])
def test_normalized_and_self_loops_bitwise(graph, kind):
    jadj, tadj, _ = graph
    _same_csr(tadj.with_self_loops(), jadj.with_self_loops())
    _same_csr(tadj.normalized(kind), jadj.normalized(kind))
    _same_csr(tadj.with_self_loops().normalized(kind),
              jadj.with_self_loops().normalized(kind))
    with pytest.raises(ValueError):
        tadj.normalized("col")


def test_transpose_is_the_dense_transpose(graph):
    _, tadj, _ = graph
    a = tadj.with_self_loops().normalized("row")
    dense = np.zeros(a.shape, np.float32)
    dense[a.row_ids(), a.indices] = a.data
    t = a.transpose()
    back = np.zeros(a.shape, np.float32)
    back[t.row_ids(), t.indices] = t.data
    np.testing.assert_array_equal(back, dense.T)
    rid = t.row_ids()
    for r in range(0, N, 97):              # each row's columns ascend
        cols = t.indices[rid == r]
        assert np.all(np.diff(cols) > 0)


@pytest.mark.parametrize("seed,frac", [(0, 0.1), (3, 0.15)])
def test_holdout_edges_bitwise(graph, seed, frac):
    jadj, tadj, _ = graph
    ttrain, tpos = holdout_edges(seed, tadj, frac)
    jtrain, jpos = j_holdout(seed, jadj, frac)
    _same_csr(ttrain, jtrain)
    assert tpos.dtype == np.asarray(jpos).dtype
    np.testing.assert_array_equal(tpos, jpos)
    assert ttrain.nnz == tadj.nnz - 2 * tpos.shape[0]


@pytest.mark.parametrize("args", [(0, 300, 200, 8), (5, 250, 120, 16, 6, 2)])
def test_bipartite_transaction_graph_bitwise(args):
    tadj, tcat, tn = bipartite_transaction_graph(*args)
    jadj, jcat, jn = j_bipartite(*args)
    _same_csr(tadj, jadj)
    np.testing.assert_array_equal(tcat, jcat)
    assert tcat.dtype == jcat.dtype and tn == jn == args[1]


@pytest.mark.parametrize("shuffle", [True, False])
def test_minibatches_bitwise(graph, shuffle):
    jadj, tadj, _ = graph
    nodes = np.arange(5, 1300, 3)
    ts = NeighborSampler(tadj, (5, 5), max_deg=32, seed=4)
    js = JSampler(jadj, (5, 5), max_deg=32, seed=4)
    tb = list(ts.minibatches(nodes, 96, shuffle=shuffle))
    jb = list(js.minibatches(nodes, 96, shuffle=shuffle))
    assert len(tb) == len(jb) == -(-nodes.shape[0] // 96)
    for (tl, tids), (jl, jids) in zip(tb, jb):
        np.testing.assert_array_equal(tids, jids)
        assert tids.shape == (96,)
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a, b)
    for (tf, tids), (jf, jids) in zip(ts.frontier_minibatches(nodes, 128, shuffle, pad_to=64),
                                      js.frontier_minibatches(nodes, 128, shuffle, pad_to=64)):
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_array_equal(tf.unique, jf.unique)
        for a, b in zip(tf.index_maps, jf.index_maps):
            np.testing.assert_array_equal(a, b)


# ---------------- the device-resident sparse product ----------------

class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("width", [1, 64, 128])
def test_device_csr_product(graph, width):
    _, tadj, _ = graph
    a = tadj.with_self_loops().normalized("sym")
    dev = a.on("cpu")
    rng = np.random.default_rng(width)
    X = torch.from_numpy(rng.standard_normal((N, width)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((N, width)).astype(np.float32))
    assert torch.equal(dev.matmat(X), a.matmat(X))          # the forward: matmat's bits
    assert dev._t_arrays is None                            # no transpose before a backward

    def grad():
        x = X.clone().requires_grad_(True)
        (gx,) = torch.autograd.grad(dev.matmat(x), x, G)
        return gx

    with _AtenOps() as ops:
        ga = grad()
    assert not [n for n in ops.names if "index_put" in n or "index_add" in n
                or "scatter" in n], ops.names
    transposed = dev.t_arrays
    assert torch.equal(ga, grad())                          # two calls, the same bits
    assert dev.t_arrays is transposed                       # uploaded once
    dense = np.zeros(a.shape, np.float64)
    dense[a.row_ids(), a.indices] = a.data
    np.testing.assert_allclose(ga.numpy(), dense.T @ G.numpy().astype(np.float64),
                               rtol=0, atol=1e-6)


def test_matmat_keeps_its_bits_and_an_lsh_graph_encode_runs_through_it(graph):
    """``CSRMatrix.matmat`` is unchanged: the gather and segment sum, the
    same bits as the device product's forward on a non-symmetric matrix."""
    _, tadj, _ = graph
    train, _ = holdout_edges(1, tadj, 0.3)
    a = CSRMatrix.from_coo(train.row_ids(), train.indices,
                           np.random.default_rng(0).standard_normal(train.nnz), train.shape)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((N, 7)).astype(np.float32))
    contrib = torch.from_numpy(a.data)[:, None] * X[torch.from_numpy(a.indices).long()]
    want = torch.segment_reduce(contrib, "sum", lengths=torch.from_numpy(a.degrees()).long())
    assert torch.equal(a.matmat(X), want)
    assert torch.equal(a.on("cpu").matmat(X), want)
    codes = lsh.encode_lsh(tadj, 16, 8, generator=torch.Generator().manual_seed(0), hops=2)
    assert codes.shape == (N, 1)


# ---------------- the full-graph forward against JAX ----------------

@pytest.mark.parametrize("task", ["node", "link"])
@pytest.mark.parametrize("model", MODELS)
def test_init_trees_match_jax_layout(graph, model, task):
    jadj, tadj, _ = graph
    jcfg = dataclasses.replace(_narrow(j_paper_cfg(model, n_nodes=N, n_classes=5)), task=task)
    tcfg = dataclasses.replace(_narrow(paper_gnn_config(model, n_nodes=N, n_classes=5)),
                               task=task)
    jp = dict(leaves_with_path(params_from_jax(_np(jgnn.init_gnn(
        jax.random.PRNGKey(0), jcfg, aux=jadj)), device="cpu")))
    tp = dict(leaves_with_path(tgnn.init_gnn(torch.Generator().manual_seed(0), tcfg, aux=tadj)))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tp[k].shape == jp[k].shape and tp[k].dtype == jp[k].dtype, k
    assert ("w_out",) in tp if task == "node" else ("w_out",) not in tp


@pytest.mark.parametrize("model", MODELS)
def test_fullgraph_forward_matches_jax(graph, model):
    jadj, tadj, _ = graph
    jcfg = _narrow(j_paper_cfg(model, n_nodes=N, n_classes=N_CLASSES), lookup_impl="gather")
    tcfg = _narrow(paper_gnn_config(model, n_nodes=N, n_classes=N_CLASSES),
                   lookup_impl="pallas")
    jp = jgnn.init_gnn(jax.random.PRNGKey(1), jcfg, aux=jadj)
    init = _np(jp)
    if model == "gin":                     # nonzero eps, so the (1 + eps) term counts
        init["eps1"], init["eps2"] = np.float32(0.25), np.float32(-0.5)
        jp = jax.tree.map(jnp.asarray, init)
    ref = np.asarray(jgnn.fullgraph_forward(jp, jadj.with_self_loops().normalized("sym"), jcfg))
    tp = params_from_jax(init, device="cpu")
    model_ = t_engine.GNNModel(tcfg, "cpu")
    adjn = tadj.with_self_loops().normalized("sym")
    got = model_.apply(tp, t_engine.FullGraphBatch(adjn.on("cpu")))
    assert got.shape == (N, tcfg.hidden)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=FWD_TOL)
    # a CSRMatrix is uploaded for the call: the same bits
    assert torch.equal(model_.apply(tp, adjn), got)
    # the hot-node cache's entry passes a full-graph batch through
    h, state = model_.apply_cached(tp, {"full": t_engine.FullGraphBatch(adjn.on("cpu"))},
                                   "untouched")
    assert torch.equal(h, got) and state == "untouched"


# ---------------- the runtime against JAX ----------------

def _state_from_jax(jstate):
    """A JAX train state (params, AdamW moments and counters) as the
    port's."""
    def moments(tree):
        return params_from_jax(jax.tree.map(np.array, tree), device="cpu")
    return {"params": params_from_jax(_np(jstate["params"]), device="cpu"),
            "opt": {"step": int(jstate["opt"]["step"]), "mu": moments(jstate["opt"]["mu"]),
                    "nu": moments(jstate["opt"]["nu"])},
            "step": int(jstate["step"])}


def test_runtime_train_evaluate_embed_match_jax(pair):
    """Five ``train`` steps, each from JAX's state before it: the loss
    within 1e-5 and the params after it within 1e-4.  Left to run free at
    Adam's eps of 1e-8, the two trajectories part by more: Adam moves an
    entry whose gradient is near eps by an O(lr) amount that rounding-level
    gradient differences change (GIN's ``mlp1/w1`` at step 1: 5.8e-6 on an
    entry with |g| = 1.3e-8 whose two gradients differ by 3.1e-11), and
    the next forward carries it on.  At eps = 1 (an update of about lr·g,
    nothing amplified) the same 5 steps run free within the bounds."""
    model = pair[1].spec.model.model
    jfree, tfree, _ = _make_pair(model, eps=1.0)
    jl, tl = jfree.train(STEPS).losses, tfree.train(STEPS).losses
    assert max(abs(a - b) for a, b in zip(jl, tl)) <= LOSS_TOL, (tl, jl)
    _assert_params_close(tfree.params, _np(jfree.params), PARAM_TOL)
    assert tl[-1] < tl[0]                                # and they do train
    jfree.close()
    tfree.close()
    jrt, trt, _ = pair
    assert trt.fullgraph and trt.sampler is None
    assert trt.data_iter is trt.source                   # no prefetch
    for k in range(STEPS):
        trt.state = _state_from_jax(jrt.state)
        jloss, tloss = jrt.train(1).losses[0], trt.train(1).losses[0]
        assert abs(tloss - jloss) <= LOSS_TOL, (k, tloss, jloss)
        _assert_params_close(trt.params, _np(jrt.params), PARAM_TOL)
    assert trt.state["step"] == trt.state["opt"]["step"] == trt.source.step == STEPS
    trt.state = _state_from_jax(jrt.state)
    for split in ("val", "test"):
        je, te = jrt.evaluate(split), trt.evaluate(split)
        assert te["n"] == je["n"] == len(trt.splits[split])
        assert abs(te["accuracy"] - je["accuracy"]) <= 1.0 / te["n"]
        assert abs(te["loss"] - je["loss"]) <= LOSS_TOL
    ids = np.arange(0, N, 37)
    np.testing.assert_allclose(trt.embed(ids), np.asarray(jrt.embed(ids)), rtol=0,
                               atol=FWD_TOL)


def test_the_adjacency_is_uploaded_once(pair):
    _, trt, _ = pair
    batches = [trt.data_iter.next_batch() for _ in range(3)]
    assert all(b["full"] is trt.full for b in batches)
    adj = trt.full.adj
    assert adj.nnz == trt.adj.nnz + N                    # self loops
    np.testing.assert_array_equal(adj.arrays[0].numpy(), trt.adj_norm.data)
    assert all(b["ids"] is batches[0]["ids"] for b in batches)


def test_two_gradients_of_one_step_are_bitwise_equal(pair):
    _, trt, _ = pair
    batch = trt.source.next_batch()
    (la, ga), (lb, gb) = (value_and_grad(lambda p: gnn_loss(trt.model, p, batch), trt.params)
                          for _ in range(2))
    assert torch.equal(la, lb)
    _same_tree(ga, gb)


def test_resume_continues_bitwise(pair, tmp_path):
    """6 straight steps equal 3 steps, ``GraphRuntime.resume`` and 3 more,
    bit for bit."""
    _, trt, init = pair
    graph = (trt.adj, trt.labels)

    def make(d):
        spec = dataclasses.replace(trt.spec, ckpt_dir=str(tmp_path / d), ckpt_every=3)
        return GraphRuntime.from_spec(spec, graph=graph, device="cpu",
                                      params=params_from_jax(init, device="cpu"))

    full = make("full")
    res_full = full.train(6)
    part = make("part")
    part.train(3)
    part.close()
    resumed = GraphRuntime.resume(str(tmp_path / "part"), graph=graph, device="cpu")
    assert resumed.state["step"] == 3 and resumed.source.step == 3
    _same_tree(part.params, resumed.params)
    res_tail = resumed.train(6)
    assert res_tail.resumed_from == 3
    assert res_tail.losses == res_full.losses[3:]
    _same_tree(full.params, resumed.params)


def test_gin_tree_carries_over_and_trains_eps(graph):
    jadj, _, _ = graph
    jcfg = _narrow(j_paper_cfg("gin", n_nodes=N, n_classes=N_CLASSES))
    init = _np(jgnn.init_gnn(jax.random.PRNGKey(2), jcfg, aux=jadj))
    tp = params_from_jax(init, device="cpu")
    assert tp["eps1"].shape == () and tp["eps1"].dtype == torch.float32
    assert set(tp["mlp1"]) == set(tp["mlp2"]) == {"w1", "b1", "w2", "b2"}
    assert is_trainable(("eps1",), tp["eps1"]) and is_trainable(("mlp2", "w2"), tp["mlp2"]["w2"])
    torch.testing.assert_close(tp["mlp2"]["w2"], torch.from_numpy(init["mlp2"]["w2"]),
                               rtol=0, atol=0)
    opt = adamw_init(tp)
    assert opt["mu"]["eps2"].shape == ()
    tcfg = _narrow(paper_gnn_config("gin", n_nodes=N, n_classes=N_CLASSES))
    model = t_engine.GNNModel(tcfg, "cpu")
    adjn = t_engine.FullGraphBatch(graph[1].with_self_loops().normalized("sym").on("cpu"))
    _, grads = value_and_grad(lambda p: model.logits(p, model.apply(p, adjn)).square().mean(),
                              tp)
    adamw_update(tp, grads, opt, AdamWConfig(lr=1e-2, weight_decay=0.0))
    assert float(tp["eps1"]) != 0.0 and float(tp["eps2"]) != 0.0


def test_serve_and_host_codes_raise_as_jax(pair):
    jrt, trt, _ = pair
    with pytest.raises(NotImplementedError, match="full-graph") as jerr:
        jrt.serve()
    with pytest.raises(NotImplementedError, match="full-graph") as terr:
        trt.serve()
    assert str(terr.value) == str(jerr.value)
    jbad = jrt.spec.with_updates(codes_placement="host")
    with pytest.raises(ValueError, match="codes_placement") as jerr:
        JRuntime.from_spec(jbad, graph=(jrt.adj, jrt.labels))
    with pytest.raises(ValueError, match="codes_placement") as terr:
        GraphRuntime.from_spec(RuntimeSpec.from_json(jbad.to_json()),
                               graph=(trt.adj, trt.labels), device="cpu")
    assert str(terr.value) == str(jerr.value)


# ---------------- link prediction and the merchant metrics ----------------

def test_link_loss_and_scores_match_jax():
    rng = np.random.default_rng(0)
    for scale in (0.5, 4.0):               # 4.0: scores past softplus's threshold of 20
        hidden = (scale * rng.standard_normal((60, 16))).astype(np.float32)
        pos = rng.integers(0, 60, (200, 2)).astype(np.int32)   # nodes repeat
        neg = rng.integers(0, 60, (200, 2)).astype(np.int32)
        jl, jg = jax.value_and_grad(jgnn.link_loss)(jnp.asarray(hidden), jnp.asarray(pos),
                                                    jnp.asarray(neg))
        h = torch.from_numpy(hidden).requires_grad_(True)
        tl = tgnn.link_loss(h, torch.from_numpy(pos), neg)
        (tg,) = torch.autograd.grad(tl, h)
        assert abs(float(tl.detach()) - float(jl)) <= 1e-6 * max(1.0, abs(float(jl)))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
        # each score a 16-term f32 dot product, summed in another order:
        # within the rounding bound 16 * 2^-24 * sum |terms|
        terms = np.abs(hidden[pos[:, 0]] * hidden[pos[:, 1]]).sum(-1)
        gap = np.abs(tgnn.link_scores(torch.from_numpy(hidden), pos).numpy()
                     - np.asarray(jgnn.link_scores(jnp.asarray(hidden), jnp.asarray(pos))))
        assert np.all(gap <= 16 * 2.0 ** -24 * terms), float((gap / terms).max())
        if scale == 4.0:
            assert float(tgnn.link_scores(torch.from_numpy(hidden), neg).max()) > 20


def test_hits_at_k_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.standard_normal(300).astype(np.float32)
    neg = np.round(rng.standard_normal(500), 1).astype(np.float32)   # ties among negatives
    for k in (1, 20, 50, 500, 900):
        assert tgnn.hits_at_k(torch.from_numpy(pos), neg, k) == jgnn.hits_at_k(
            jnp.asarray(pos), jnp.asarray(neg), k)


@pytest.mark.parametrize("k", [1, 3, 5, 10])
def test_hit_rate_at_k_matches_jax_with_ties(k):
    """Integer logits in [0, 4) over 12 categories tie often: at a tie the
    lower category enters the top k, as in ``jax.lax.top_k``.  Rows of one
    value throughout: only categories 0..k-1 are hits."""
    rng = np.random.default_rng(k)
    logits = rng.integers(0, 4, (400, 12)).astype(np.float32)
    logits[:12] = 1.0
    labels = rng.integers(0, 12, 400).astype(np.int32)
    labels[:12] = np.arange(12)
    want = jgnn.hit_rate_at_k(jnp.asarray(logits), jnp.asarray(labels), k)
    assert tgnn.hit_rate_at_k(torch.from_numpy(logits), labels, k) == want
    assert tgnn.hit_rate_at_k(torch.from_numpy(logits[:12]), labels[:12], k) == k / 12
    assert tgnn.accuracy(torch.from_numpy(logits), labels) == jgnn.accuracy(
        jnp.asarray(logits), labels)
