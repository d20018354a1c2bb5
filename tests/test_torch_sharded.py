"""The port's N-shard GraphSAGE (``parallel``, ``ShardedSageBatchSource``,
``OwnerPlan``, the ``sharded`` and ``owner`` decode backends) against the
JAX package and against the port's own 1-shard runs.

Reference runs: ``tests/test_sharded.py``'s fixture, a 1,200-node power-law
graph (identical in both packages), the paper's GraphSAGE narrowed to c=16,
m=8, d_c=d_m=64, fanout 5, global batch 64 over 4 shards, frontiers padded
to 64 rows, AdamW lr 1e-2.  The JAX package runs its shards as devices of
one process (its own 4-device stream runs below in a subprocess with 4
forced host devices, as ``tests/test_parallel.py`` runs its cases); the
port runs them as 4 CPU processes joined over ``gloo``, spawned once for
the module (``_ranks``, one thread each), which run every multi-rank case
and return what they saw.

Tolerances: the stacked batches, the owner plans and the duplication rule
are numpy, so bitwise against JAX.  Decoded rows are bitwise the gather
oracle on every valid row (a row's decode does not depend on the rank that
runs it); codebook and ``w0`` gradients within JAX's own rtol 1e-4 / atol
1e-5 (partials summed over the ranks in another order).  The 4-rank
step-0 loss is bitwise the 1-shard run's; 6 steps stay within 1e-3 (JAX's
bound, ``tests/test_sharded.py``).  Cached at staleness 0, host-placed
codes and a resumed run are bitwise the plain run.  The port's 4-rank
step-0 loss against JAX's 4-device one, from the same params and codes:
within 1e-5 (f32 matmuls summed in other orders).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.core import backend as jbackend
from repro.graph import engine as j_engine
from repro.graph import sampler as j_sampler
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro.optim.adamw import AdamWConfig as JAdamW
from repro_torch.configs.paper_gnn import paper_gnn_config
from repro_torch.core import backend as tbackend
from repro_torch.graph import engine as t_engine
from repro_torch.graph import sampler as t_sampler
from repro_torch.graph.generate import powerlaw_graph
from repro_torch.graph.runtime import GraphRuntime, GraphSource, RuntimeSpec
from repro_torch.interop import params_from_jax
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import policy, sharding
from repro_torch.train.checkpoint import TopologyMismatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, N_SHARDS, BATCH = 1200, 4, 64
GRAPH = dict(kind="powerlaw", seed=0, n_nodes=N, n_classes=8, avg_degree=8, homophily=0.9)
CPU = torch.device("cpu")
RUN_STEPS = 6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
JAX_LOSS_TOL = 1e-5


def _spec(lookup_impl="sharded:gather", **kw) -> RuntimeSpec:
    base = paper_gnn_config("sage", n_nodes=N, n_classes=8, fanout=5)
    cfg = dataclasses.replace(base, embedding=dataclasses.replace(
        base.embedding, c=16, m=8, d_c=64, d_m=64, lookup_impl=lookup_impl))
    spec = RuntimeSpec(graph=GraphSource(**GRAPH), model=cfg,
                       optimizer=AdamWConfig(lr=1e-2, weight_decay=0.0),
                       batch_size=BATCH, pad_to=64, max_deg=32, prefetch_depth=2,
                       n_shards=N_SHARDS)
    return spec.with_updates(**kw) if kw else spec


def _graph():
    return powerlaw_graph(0, N, avg_degree=8, n_classes=8, homophily=0.9)


def _sources(n_shards=N_SHARDS, seed=7, **kw):
    """The JAX and the port's stacked source over one graph and sampler."""
    adj, labels = _graph()
    js = j_sampler.NeighborSampler(adj, (5, 5), max_deg=32, seed=0)
    ts = t_sampler.NeighborSampler(adj, (5, 5), max_deg=32, seed=0)
    make = lambda mod, smp: mod.ShardedSageBatchSource(
        smp, np.arange(N), labels, BATCH // n_shards, n_shards=n_shards, seed=seed,
        pad_to=64, **kw)
    return make(j_engine, js), make(t_engine, ts)


def _same_batch(jb, tb):
    jf, tf = jb["frontier"], tb["frontier"]
    np.testing.assert_array_equal(np.asarray(jf.unique), tf.unique)
    np.testing.assert_array_equal(np.asarray(jf.valid), tf.valid)
    assert int(jf.n_unique) == tf.n_unique
    for a, b in zip(jf.index_maps, tf.index_maps):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(jb["labels"]), tb["labels"])
    assert (jf.plan is None) == (tf.plan is None)
    if tf.plan is not None:
        jp = jf.plan
        for a, b in zip((jp.req_rows, jp.owned_src, jp.ret_idx, jp.n_owned), tf.plan.leaves()):
            np.testing.assert_array_equal(np.asarray(a), b)
            assert b.dtype == np.int32


# ---------------------------------------------------------------------------
# host side, in this process: bitwise against JAX
# ---------------------------------------------------------------------------

def test_stacked_batches_and_owner_plans_match_jax():
    js, ts = _sources(owner_plan=True)
    for _ in range(3):
        _same_batch(js.next_batch(), ts.next_batch())
    assert ts.state_dict() == js.state_dict()
    # resume replays the stream
    state = ts.state_dict()
    ref = ts.next_batch()
    _, again = _sources(owner_plan=True)
    again.load_state_dict(state)
    _same_batch(ref, again.next_batch())
    with pytest.raises(ValueError):
        again.load_state_dict(dict(state, n_shards=2))
    assert t_sampler.OWNER_SAFETY == j_sampler.OWNER_SAFETY


def test_owner_caps_and_overflow_match_jax():
    for cap in (64, 512, 7168, 15616):
        for n in (1, 2, 4, 8, 16):
            assert t_sampler.default_owner_caps(cap, n) == j_sampler.default_owner_caps(cap, n)
    assert t_sampler.default_owner_caps(15616, 4) == (4880, 7808)
    js, ts = _sources(owner_plan=True, owner_cap=2, owner_unique_cap=8)
    with pytest.warns(UserWarning, match="owner plan overflow"):
        jb = js.next_batch()
    with pytest.warns(UserWarning, match="owner plan overflow"):
        tb = ts.next_batch()
    assert tb["frontier"].plan is None and ts.plan_overflows == 1
    _same_batch(jb, tb)
    with pytest.raises(ValueError, match="positive"):
        _sources(owner_plan=True, owner_cap=0)


def test_owner_plan_routes_every_valid_row_once():
    """Simulating the exchange with the ids as payloads: each valid row gets
    its id back, and the owners decode exactly the distinct ids of the four
    blocks, each once."""
    _, ts = _sources(owner_plan=True)
    fb = ts.next_batch()["frontier"]
    plan, n, cap = fb.plan, ts.n_shards, ts.frontier_cap
    unique, valid = fb.unique.reshape(n, cap), fb.valid.reshape(n, cap)
    distinct = np.unique(fb.unique[fb.valid])
    assert int(plan.n_owned.sum()) == distinct.shape[0]
    out = np.full((n, cap), -1, np.int64)
    for o in range(n):
        recv = np.stack([unique[s][np.clip(plan.req_rows[s, o], 0, cap - 1)]
                         for s in range(n)]).reshape(-1)
        owned = recv[plan.owned_src[o]]
        k = int(plan.n_owned[o])
        assert len(np.unique(owned[:k])) == k and (owned[:k] % n == o).all()
        for s in range(n):
            rows = plan.req_rows[s, o]
            ok = rows < cap
            out[s, rows[ok]] = owned[plan.ret_idx[o, s]][ok]
    np.testing.assert_array_equal(out[valid], unique[valid])


def test_duplication_rule_matches_jax():
    js, ts = _sources(owner_plan="auto")
    assert ts.duplication_measured == js.duplication_measured
    assert ts.owner_plan == js.owner_plan
    _same_batch(js.next_batch(), ts.next_batch())     # the peeked step is not resampled
    assert tbackend.OWNER_DUP_THRESHOLD == jbackend.OWNER_DUP_THRESHOLD
    for dup in (None, 1.2, 2.0, 3.0):
        assert tbackend.resolve_auto(CPU, dup) == jbackend.resolve_auto(dup) == "onehot"
    # a mesh of several ranks: the rule alone needs no process group
    with sharding.use_sharding(sharding.DataMesh(rank=0, size=2, device=CPU)):
        assert tbackend.resolve_auto(CPU, 3.0) == "owner"
        assert tbackend.resolve_auto(CPU, 1.2) == tbackend.resolve_auto(CPU) == "sharded"
        assert tbackend.get_backend("auto", device=CPU, duplication=3.0).base.name == "onehot"
    assert sharding.data_axis_size() == 1


def test_collective_registry_and_single_device_fallback():
    for name, base in (("sharded:gather", "gather"), ("owner:pallas", "pallas"),
                       ("sharded", "onehot")):
        assert tbackend.get_backend(name, device=CPU).base.name == base
    for bad in ("sharded:sharded", "owner:owner", "owner:sharded", "sharded:owner",
                "hashemb:sharded"):
        with pytest.raises(ValueError):
            tbackend.get_backend(bad, device=CPU)
    rng = np.random.default_rng(1)
    codes = torch.from_numpy(rng.integers(0, 16, (32, 8)).astype(np.int32))
    cb = torch.from_numpy(rng.standard_normal((8, 16, 64)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    ref = tbackend.get_backend("gather", device=CPU).decode(codes, cb, w0)
    for name in ("sharded:gather", "owner:gather"):
        be = tbackend.get_backend(name, device=CPU)
        assert torch.equal(be.decode(codes, cb, w0), ref)
        assert torch.equal(be.decode_frontier(codes, cb, w0, plan=None), ref)


def test_placement_keeps_row_blocks_and_the_rest_whole():
    _, ts = _sources(owner_plan=True)
    batch = ts.next_batch()
    cap = ts.frontier_cap
    mesh = sharding.DataMesh(rank=2, size=N_SHARDS, device=CPU)
    spec = policy.frontier_batch_shardings(batch, mesh)
    assert spec["frontier"].unique == spec["frontier"].valid == policy.ROWS
    assert spec["labels"] == policy.WHOLE
    placed = policy.make_frontier_placement(mesh)(batch)
    fb, full = placed["frontier"], batch["frontier"]
    assert torch.equal(fb.unique, torch.from_numpy(full.unique[2 * cap:3 * cap].astype(np.int64)))
    assert all(torch.equal(a, torch.from_numpy(b.astype(np.int64)))
               for a, b in zip(fb.index_maps, full.index_maps))
    assert fb.n_unique == full.n_unique and placed["labels"].shape == (BATCH,)
    for got, want in zip(fb.plan.leaves(), full.plan.leaves()):
        assert torch.equal(got, torch.from_numpy(want[2:3].astype(np.int64)))


def test_no_group_of_n_ranks_raises():
    assert sharding.data_mesh(1) is None
    with pytest.raises(ValueError, match="process group"):
        sharding.data_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="process group"):
        GraphRuntime.from_spec(_spec("owner"), device="cpu")


def test_collective_specs_serve_on_one_device_as_their_base():
    """A ``sharded:`` or ``owner:`` spec serves on one device, and both
    decode their base's bits (JAX's ``test_sharded.py:202``)."""
    ref = GraphRuntime.from_spec(_spec("gather", n_shards=1), device="cpu")
    ids = np.arange(0, 64, dtype=np.int32)
    want = ref.serve(cache_capacity=0).serve(ids)
    for impl in ("sharded:gather", "owner:gather"):
        rt = GraphRuntime.from_spec(_spec(impl, n_shards=1), graph=(ref.adj, ref.labels),
                                    device="cpu")
        for eng in (rt.serve(cache_capacity=0), rt.serve()):
            got = eng.serve(ids)
            np.testing.assert_array_equal(got.embeddings, want.embeddings)
            np.testing.assert_array_equal(got.logits, want.logits)
        np.testing.assert_array_equal(rt.embed(ids), ref.embed(ids))


# ---------------------------------------------------------------------------
# four ranks over gloo, spawned once
# ---------------------------------------------------------------------------

def _decode_cases(mesh, case):
    """Each collective backend's frontier decode of this rank's block, with
    and without w0, and its codebook / w0 gradients."""
    fb = case["frontier"]
    cap = case["cap"]
    r = mesh.rank
    codes_l = torch.from_numpy(case["codes"][r * cap:(r + 1) * cap])
    plan = t_sampler.OwnerPlan(*(torch.from_numpy(a[r:r + 1].astype(np.int64))
                                 for a in fb.plan.leaves()))
    vm = torch.from_numpy(fb.valid)[:, None]
    cb0, w00 = (torch.from_numpy(case[k]) for k in ("cb", "w0"))
    out = {}
    with sharding.use_sharding(mesh):
        for name in ("sharded:gather", "owner:gather", "owner:pallas"):
            be = tbackend.get_backend(name, device=CPU)
            rows = [be.decode_frontier(codes_l, cb0, scale, plan=plan) for scale in (w00, None)]
            cb, w0 = cb0.clone().requires_grad_(), w00.clone().requires_grad_()
            loss = ((be.decode_frontier(codes_l, cb, w0, plan=plan) * vm) ** 2).sum()
            gcb, gw0 = torch.autograd.grad(loss, (cb, w0))
            out[name] = [t.numpy() for t in rows + [gcb, gw0]]
        # the whole batch on every rank, 30 rows: padded to 32 to split
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out["pad"] = tbackend.get_backend("sharded:gather", device=CPU).decode(
                torch.from_numpy(case["codes"][:30]), cb0, None).numpy()
    return out


def _train(spec, steps=RUN_STEPS, **kw):
    rt = GraphRuntime.from_spec(spec, device="cpu", **kw)
    try:
        losses = rt.train(steps).losses
        return losses, {k: v.numpy().copy() for k, v in
                        _flat(rt.params).items()}, rt
    finally:
        rt.close()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v
    return out


def _rank_program(rank, case):
    torch.set_num_threads(1)
    mesh = sharding.data_mesh(N_SHARDS, device="cpu")
    res = {"decode": _decode_cases(mesh, case), "runs": {}, "errors": {}}
    runs = res["runs"]
    for impl in ("sharded:gather", "owner:gather", "owner:pallas", "auto"):
        losses, params, rt = _train(_spec(impl))
        runs[impl] = (losses, params)
        if impl == "owner:gather":
            res["owner_plan"] = rt.source.owner_plan
            res["overflows"] = rt.source.plan_overflows
        if impl == "auto":
            res["auto"] = (type(rt.train_step.model.backend).__name__,
                           rt.source.duplication_measured)
    # a dense table and a plain backend: under the mesh their frontier
    # rows come back from every rank too
    runs["dense"] = _train(_spec(kind="dense"), 2)[:2]
    runs["hashemb:gather"] = _train(_spec("hashemb:gather"), 2)[:2]
    for impl in ("sharded:gather", "owner:gather"):
        runs["cached " + impl] = _train(_spec(impl, cache_capacity=256, cache_staleness=0))[:2]
        runs["host " + impl] = _train(_spec(impl, codes_placement="host"))[:2]
        runs["noprefetch " + impl] = _train(_spec(impl, prefetch_depth=0))[:2]
    # a checkpoint at step 3 (rank 0 writes), resumed on every rank
    spec = _spec("owner:gather", ckpt_dir=case["ckpt_dir"], ckpt_every=1000)
    first = _train(spec, 3)[0]
    rt = GraphRuntime.resume(case["ckpt_dir"], device="cpu")
    try:
        runs["resumed"] = (first + rt.train(RUN_STEPS).losses,
                           {k: v.numpy().copy() for k, v in _flat(rt.params).items()})
    finally:
        rt.close()
    # JAX's params and codes: step 0 beside JAX's own 4-device stream
    runs["jax params"] = _train(_spec("sharded:gather", prefetch_depth=0), 1,
                                params=params_from_jax(case["jax_params"], device="cpu"))[:2]
    # the loud failures, inside a group of 4
    for name, fn in (
            ("indivisible", lambda: GraphRuntime.from_spec(_spec(batch_size=66), device="cpu")),
            ("plan_misses", lambda: GraphRuntime.from_spec(
                _spec(cache_capacity=256, cache_plan_misses=True), device="cpu")),
            ("too_few", lambda: sharding.data_mesh(8, device="cpu")),
            ("wraps", lambda: tbackend.get_backend("owner:sharded", device=CPU))):
        try:
            fn()
            res["errors"][name] = None
        except ValueError as e:
            res["errors"][name] = str(e)
    res["transport"] = mesh.backend
    return res


_JAX_4SHARD = """
import dataclasses, numpy as np
from repro.configs.paper_gnn import paper_gnn_config
from repro.graph.runtime import GraphRuntime, GraphSource, RuntimeSpec
from repro.optim.adamw import AdamWConfig
base = paper_gnn_config("sage", n_nodes={N}, n_classes=8, fanout=5)
cfg = dataclasses.replace(base, embedding=dataclasses.replace(
    base.embedding, c=16, m=8, d_c=64, d_m=64, lookup_impl="sharded:gather"))
spec = RuntimeSpec(graph=GraphSource(**{GRAPH}), model=cfg,
                   optimizer=AdamWConfig(lr=1e-2, weight_decay=0.0), batch_size={BATCH},
                   pad_to=64, max_deg=32, prefetch_depth=0, n_shards=4)
rt = GraphRuntime.from_spec(spec)
print("LOSS", repr(rt.train(1).losses[0]))
"""


@pytest.fixture(scope="module")
def jax_params():
    """The JAX runtime's seeded init at 1 shard (the 4-shard init is the
    same: the params do not depend on the shard count)."""
    jspec = JSpec(graph=JSource(**GRAPH), model=_jcfg(), batch_size=BATCH,
                  optimizer=JAdamW(lr=1e-2, weight_decay=0.0), pad_to=64, max_deg=32,
                  prefetch_depth=0)
    jrt = JRuntime.from_spec(jspec)
    try:
        return jax.tree.map(np.asarray, jrt.state["params"])
    finally:
        jrt.close()


def _jcfg():
    base = j_paper_cfg("sage", n_nodes=N, n_classes=8, fanout=5)
    return dataclasses.replace(base, embedding=dataclasses.replace(
        base.embedding, c=16, m=8, d_c=64, d_m=64, lookup_impl="sharded:gather"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params):
    """Start JAX's 4-device stream in a subprocess, run the 4 ranks, and
    hand both results (and the decode case the ranks held) to the tests."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    code = textwrap.dedent(_JAX_4SHARD).format(N=N, GRAPH=GRAPH, BATCH=BATCH)
    jproc = subprocess.Popen([sys.executable, "-c", code], env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    _, ts = _sources(owner_plan=True)
    fb = ts.next_batch()["frontier"]
    rng = np.random.default_rng(0)
    table = rng.integers(0, 16, (N, 8)).astype(np.int32)
    case = dict(frontier=fb, cap=ts.frontier_cap, codes=table[fb.unique],
                cb=rng.standard_normal((8, 16, 64)).astype(np.float32),
                w0=rng.standard_normal(64).astype(np.float32),
                ckpt_dir=str(tmp_path_factory.mktemp("ckpt4")), jax_params=jax_params)
    try:
        results = sharding.spawn(_rank_program, N_SHARDS, args=(case,), timeout_s=600)
    finally:
        out, err = jproc.communicate(timeout=600)
    assert jproc.returncode == 0, err
    jloss = float(next(l for l in out.splitlines() if l.startswith("LOSS")).split()[1])
    return results, case, jloss


@pytest.fixture(scope="module")
def one_shard():
    """The port's 1-shard runs of the same global batch and init."""
    return {impl: _train(_spec(impl, n_shards=1))[:2] for impl in ("gather", "pallas", "auto")}


def test_every_rank_holds_the_same_params(ranks):
    results, _, _ = ranks
    for name, (losses, params) in results[0]["runs"].items():
        for other in results[1:]:
            got_l, got_p = other["runs"][name]
            assert got_l == losses, name
            assert all(np.array_equal(params[k], got_p[k]) for k in params), name


@pytest.mark.parametrize("impl", ["sharded:gather", "owner:gather", "owner:pallas"])
def test_decode_is_the_gather_oracle_on_every_valid_row(ranks, impl):
    results, case, _ = ranks
    valid = case["frontier"].valid
    codes, cb, w0 = (jnp.asarray(case[k]) for k in ("codes", "cb", "w0"))
    oracle = jbackend.get_backend("gather")
    fwd_w0, fwd_none, gcb, gw0 = results[0]["decode"][impl]
    np.testing.assert_array_equal(fwd_w0[valid], np.asarray(oracle.decode(codes, cb, w0))[valid])
    np.testing.assert_array_equal(fwd_none[valid],
                                  np.asarray(oracle.decode(codes, cb, None))[valid])
    if impl.startswith("owner"):
        assert not fwd_w0[~valid].any()              # padding rows decode to zeros
    vm = jnp.asarray(valid)[:, None]
    jg = jax.grad(lambda c, s: ((oracle.decode(codes, c, s) * vm) ** 2).sum(),
                  argnums=(0, 1))(cb, w0)
    for got, want in zip((gcb, gw0), jg):
        np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    for other in results[1:]:
        for a, b in zip(other["decode"][impl], results[0]["decode"][impl]):
            np.testing.assert_array_equal(a, b)


def test_sharded_decode_pads_an_unaligned_batch(ranks):
    results, case, _ = ranks
    want = jbackend.get_backend("gather").decode(jnp.asarray(case["codes"][:30]),
                                                 jnp.asarray(case["cb"]), None)
    np.testing.assert_array_equal(results[0]["decode"]["pad"], np.asarray(want))


@pytest.mark.parametrize("impl,base", [("sharded:gather", "gather"), ("owner:gather", "gather"),
                                       ("owner:pallas", "pallas"), ("auto", "auto")])
def test_four_ranks_step0_loss_is_the_one_shard_runs(ranks, one_shard, impl, base):
    results, _, _ = ranks
    losses, _ = results[0]["runs"][impl]
    ref, _ = one_shard[base]
    assert losses[0] == ref[0], (losses[0], ref[0])
    assert max(abs(a - b) for a, b in zip(losses, ref)) < 1e-3


@pytest.mark.parametrize("name,kw", [("dense", dict(kind="dense")),
                                     ("hashemb:gather", dict(lookup_impl="hashemb:gather"))])
def test_other_tables_step0_is_the_one_shard_runs(ranks, name, kw):
    results, _, _ = ranks
    losses, _ = results[0]["runs"][name]
    ref = _train(_spec(n_shards=1, **kw), 2)[0]
    assert losses[0] == ref[0]
    assert max(abs(a - b) for a, b in zip(losses, ref)) < 1e-3


def test_owner_runs_plan_every_step_and_auto_measures(ranks):
    results, _, _ = ranks
    r = results[0]
    assert r["owner_plan"] and r["overflows"] == 0
    # the runtime's source: the training split, 16 targets a shard, data seed 0
    from repro.graph.generate import train_val_test_split
    adj, labels = _graph()
    js = j_engine.ShardedSageBatchSource(
        j_sampler.NeighborSampler(adj, (5, 5), max_deg=32, seed=0),
        train_val_test_split(0, N, (0.7, 0.1, 0.2))[0], labels, BATCH // N_SHARDS,
        n_shards=N_SHARDS, seed=0, pad_to=64, owner_plan="auto")
    name, dup = r["auto"]
    assert dup == js.duplication_measured
    assert name == ("OwnerBackend" if dup > tbackend.OWNER_DUP_THRESHOLD else "ShardedBackend")
    assert r["transport"] == "gloo"


@pytest.mark.parametrize("variant", ["cached", "host", "noprefetch"])
@pytest.mark.parametrize("impl", ["sharded:gather", "owner:gather"])
def test_variants_are_the_plain_run_bitwise(ranks, variant, impl):
    """Cached at staleness 0, codes on the host (JAX's
    ``test_codes_offload.py:279-301``) and no prefetch: the plain run."""
    results, _, _ = ranks
    losses, params = results[0]["runs"][impl]
    got_l, got_p = results[0]["runs"][f"{variant} {impl}"]
    assert got_l == losses
    common = set(params) & set(got_p)       # host placement carries no codes_buf
    assert "embed/decoder/codebooks" in common
    assert all(np.array_equal(params[k], got_p[k]) for k in common)


def test_resume_is_bitwise_and_other_shard_counts_are_refused(ranks):
    results, case, _ = ranks
    losses, params = results[0]["runs"]["owner:gather"]
    got_l, got_p = results[0]["runs"]["resumed"]
    assert got_l == losses
    assert all(np.array_equal(params[k], got_p[k]) for k in params)
    with pytest.raises(TopologyMismatch):
        rt = GraphRuntime.from_spec(_spec("owner:gather", n_shards=1, ckpt_dir=case["ckpt_dir"]),
                                    device="cpu")
        try:
            rt.train(RUN_STEPS + 1)
        finally:
            rt.close()


def test_loud_failures_inside_a_group(ranks):
    errors = ranks[0][0]["errors"]
    assert "not divisible" in errors["indivisible"]
    assert "single-shard" in errors["plan_misses"]
    assert "has 4 ranks" in errors["too_few"]
    assert "wrap itself" in errors["wraps"]


def test_step0_loss_matches_jax_four_devices(ranks):
    results, _, jloss = ranks
    losses, _ = results[0]["runs"]["jax params"]
    assert abs(losses[0] - jloss) <= JAX_LOSS_TOL, (losses[0], jloss)
