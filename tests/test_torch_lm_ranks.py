"""The LM across ranks: the port's 4-rank step, expert parallelism, GPipe,
compressed gradients and a restart on another mesh, against the JAX
package (its devices forced on the host, in a subprocess, as
``tests/test_parallel.py`` runs them) and against the port's own one-rank
step.

The port's ranks are 4 CPU processes over gloo, spawned once for the
module (``_ranks``, one thread each), on the (data 2, model 2) mesh, which
run every case and return what they saw; the restart spawns 2 more.
Reduced qwen1.5-0.5b and granite-moe-3b-a800m (f32, 2 layers, d_model
128), a batch of 8 x 16 tokens, one step from JAX's params
(``interop.params_from_jax``) with AdamW at eps 1, lr 1 and no warmup
(``HYPER``), so that the step moves each weight by about its clipped
gradient and the params after it show the gradient, the clip's norm
included.

Bounds:
  * qwen's 4-rank step (``DEFAULT_STRATEGY``: TP over model, FSDP over
    data; ``dp_over_model``: FSDP over data, the batch over both axes)
    against JAX's single-device step: loss rtol 1e-4, params rtol 5e-3 /
    atol 5e-4 (JAX's own, ``tests/test_parallel.py``); against the port's
    one-rank step: the step-0 loss within 1e-6 relative and the params
    within rtol 1e-3 / atol 1e-5; against both, every leaf's update within
    ``DELTA`` of the reference's largest (the TP and FSDP sums add f32
    partials in another order), a bound that the update of half the batch
    (the data axis's sum dropped) and an unchanged state both fail; every
    rank's gathered params the same bits;
  * granite's 4-rank step (EP over model, drops at capacity 1.25) against
    JAX's (2, 2)-mesh step: loss rtol 1e-4, params rtol 5e-3 / atol 5e-4,
    the update within ``DELTA``;
  * EP at JAX's case (d 32, d_ff 64, 8 experts, top-2, capacity 4.0: no
    drops) against JAX's ``moe_ffn`` within 2e-4; at capacity 1.25 (rows
    drop) against JAX's ``moe_ffn_ep`` on a (2, 2) mesh within 2e-4;
    ``moe_ffn_ep_reference`` bitwise the ranks';
  * ``gpipe`` (4 stages, 8 microbatches) against JAX's: output 2e-5,
    gradients 1e-4; ``compress_gradients_int8`` and
    ``decompress_gradients_int8`` bitwise JAX's; ``psum_compressed`` over
    4 ranks bitwise JAX's over 4 devices and the plain version's;
  * the restart: a state saved on (2, 2) restored on 2 ranks as (1, 2) and
    (2, 1) is bitwise the saved one gathered, and takes step 2 to a finite
    loss;
  * TP over the SSM heads is held to JAX's (2, 2)-mesh step in
    ``tests/test_torch_lm_ranks_ssm.py`` (its own subprocess and ranks, so
    that neither file holds its worker long);
  * layouts no JAX-parity case reaches, against the port's one-rank step
    (the same bounds): reduced qwen with a dense table (looked up
    vocab-parallel), reduced granite under EP with 16 experts at its own
    top-8 and capacity 4.0 (a rank's window then holds all its rows, so
    nothing drops and one rank's ``moe_ffn`` is the reference; with 8
    experts padded to 16 all real experts sit on model rank 0 and rows drop
    at any capacity, JAX's formula), reduced musicgen-large (GELU MLP, its
    biases split over the model axis, LayerNorm) under
    ``Strategy(tp_vocab=False)``,
    reduced mamba2 and zamba2 (the hybrid's shared block and tail) under
    ``dp_over_model``.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as j_compress
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_jax
from repro_torch.nn import moe as t_moe
from repro_torch.nn.module import leaves_with_path
from repro_torch.optim import compress
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import sharding
from repro_torch.train.step import TrainHyper, init_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QWEN, GRANITE, MAMBA2 = "qwen1.5-0.5b", "granite-moe-3b-a800m", "mamba2-2.7b"
JAX_LOSS_RTOL, JAX_RTOL, JAX_ATOL = 1e-4, 5e-3, 5e-4
ONE_LOSS_RTOL, ONE_RTOL, ONE_ATOL = 1e-6, 1e-3, 1e-5
# the parity steps' AdamW: eps 1 and no warmup, so the step's update is
# about lr * c * g (c the clip's scale) and moves each weight by about its
# gradient (up to 0.03 here, the median 1e-3); at eps 1e-8 it would be lr *
# sign(g), which turns a rounding-level gradient into a whole step
LR = 1.0
HYPER = TrainHyper(optimizer=AdamWConfig(lr=LR, weight_decay=0.01, clip_norm=1.0, eps=1.0),
                   warmup_steps=1, total_steps=10)
# the update of every leaf against the reference's, max |d - d_ref| / max
# |d_ref| a leaf: 4 ranks against one read at most 7.3e-6 (another order of
# f32 sums), against JAX at most 6.9e-6; the gradient of half the batch (the
# data axis's sum dropped) reads 1.13, an unchanged state 1
DELTA = 1e-4
EP_TOL = 2e-4

_JAX_SCRIPT = r'''
import pickle, sys
LR = float(sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs import get_config, reduced
from repro.parallel.sharding import make_mesh, use_sharding, shard_map
from repro.parallel.policy import state_shardings, batch_shardings
from repro.train.step import TrainHyper, init_train_state, make_train_step
from repro.optim.adamw import AdamWConfig
from repro.nn.moe import MoEConfig, init_moe, moe_ffn, moe_ffn_ep
from repro.parallel.pipeline import gpipe
from repro.optim.compress import psum_compressed

out = {}
tree_np = lambda t: jax.tree.map(lambda a: None if a is None else np.asarray(a), t,
                                 is_leaf=lambda x: x is None)
rng = np.random.default_rng(0)
for arch in ("qwen1.5-0.5b", "granite-moe-3b-a800m"):
    cfg = reduced(get_config(arch))
    key = jax.random.PRNGKey(0)
    state = init_train_state(key, cfg)
    tokens = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    step = make_train_step(cfg, TrainHyper(
        optimizer=AdamWConfig(lr=LR, weight_decay=0.01, clip_norm=1.0, eps=1.0),
        warmup_steps=1, total_steps=10))
    r = {"params": tree_np(state["params"]), "tokens": tokens}
    if arch.startswith("qwen"):
        s1, m1 = jax.jit(step)(jax.tree.map(lambda x: x, state), batch)
        r["single"] = (float(m1["loss"]), tree_np(s1["params"]))
    else:
        mesh = make_mesh((2, 2), ("data", "model"))
        with use_sharding(mesh):
            st_sh = state_shardings(cfg, jax.eval_shape(lambda: init_train_state(key, cfg)), mesh)
            b_sh = batch_shardings(jax.eval_shape(lambda: batch), mesh)
            s2, m2 = jax.jit(step, in_shardings=(st_sh, b_sh),
                             out_shardings=(st_sh, None))(state, batch)
        r["sharded"] = (float(m2["loss"]), tree_np(s2["params"]))
    out[arch] = r

key = jax.random.PRNGKey(0)
for cap in (4.0, 1.25):
    cfg = MoEConfig(d_model=32, d_ff=64, n_experts=8, top_k=2, capacity_factor=cap)
    p = init_moe(key, cfg)
    x = jax.random.normal(key, (64, 32))
    mesh = make_mesh((2, 2), ("data", "model"))
    with use_sharding(mesh):
        ep = jax.jit(lambda p, x: moe_ffn_ep(p, x, cfg))(p, x)
    out[f"moe_{cap}"] = dict(params=tree_np(p), x=np.asarray(x), ep=np.asarray(ep),
                             single=np.asarray(moe_ffn(p, x, cfg)))

S, M, mb, T, D = 4, 8, 2, 8, 16
sp = {"w": jax.random.normal(key, (S, 2, D, D)) * 0.1,
      "b": jax.random.normal(jax.random.fold_in(key, 1), (S, 2, D)) * 0.1}
def stage_fn(p, x):
    for i in range(2):
        x = jnp.tanh(x @ p["w"][i] + p["b"][i])
    return x
xs = jax.random.normal(jax.random.fold_in(key, 2), (M, mb, T, D))
mesh = make_mesh((1, 4), ("data", "model"))
fwd = gpipe(stage_fn, sp, xs, mesh, axis="model")
grads = jax.grad(lambda p: (gpipe(stage_fn, p, xs, mesh, axis="model") ** 2).sum())(sp)
out["gpipe"] = dict(params=tree_np(sp), xs=np.asarray(xs), out=np.asarray(fwd),
                    grads=tree_np(grads))

gs = np.random.default_rng(1).standard_normal((4, 1000)).astype(np.float32)
res = np.random.default_rng(2).standard_normal((4, 1000)).astype(np.float32) * 0.01
mesh4 = make_mesh((4,), ("data",))
f = jax.jit(shard_map(lambda g, r: psum_compressed(g[0], "data", r[0]), mesh=mesh4,
                      in_specs=(P("data", None), P("data", None)),
                      out_specs=(P("data"), P("data")), check_vma=False))
mean, newres = f(jnp.asarray(gs), jnp.asarray(res))
out["psum"] = dict(gs=gs, res=res, mean=np.asarray(mean).reshape(4, -1),
                   newres=np.asarray(newres).reshape(4, -1))
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """JAX's references, computed in a subprocess with 4 forced host devices."""
    path = str(tmp_path_factory.mktemp("jax") / "ref.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, path, repr(LR)], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _flat(tree):
    """Leaves as numpy copies (the step updates the state in place)."""
    return {"/".join(p): (t.numpy().copy() if isinstance(t, torch.Tensor) else np.asarray(t))
            for p, t in leaves_with_path(tree)}


def _jflat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jflat(v, prefix + k + "/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _batch(tokens):
    return {"tokens": tokens.astype(np.int64), "labels": tokens.astype(np.int64)}


def _state_from(params_np, mesh, cfg, strategy):
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import policy
    full = params_from_jax(params_np, "cpu")
    specs = policy.params_shardings(cfg, policy.abstract_params(cfg), mesh, strategy)
    local = policy.shard_tree(full, specs, mesh)
    return {"params": local, "opt": adamw_init(local), "step": 0}


def _step_case(ref, arch, mesh, strategy, steps=1):
    """``steps`` sharded steps from JAX's params: (losses, gathered params)."""
    from repro_torch.parallel import policy
    cfg = reduced(get_config(arch))
    state = _state_from(ref["params"], mesh, cfg, strategy)
    step = make_train_step(cfg, HYPER, mesh=mesh, strategy=strategy)
    losses = []
    for _ in range(steps):
        state, m = step(state, _batch(ref["tokens"]))
        losses.append(float(m["loss"]))
    specs = policy.state_shardings(cfg, state, mesh, strategy)
    return losses, _flat(policy.gather_tree(state["params"], specs["params"], mesh)), state, specs


def _ep_case(case, mesh, plan):
    cfg = t_moe.MoEConfig(d_model=32, d_ff=64, n_experts=8, top_k=2,
                          capacity_factor=float(case["cap"]))
    p = params_from_jax(case["params"], "cpu")
    e_local = cfg.e_pad // 2
    m, d = mesh.coords["model"], mesh.coords["data"]
    local = {k: (v if k == "router" else v[m * e_local:(m + 1) * e_local]) for k, v in p.items()}
    x = torch.from_numpy(case["x"])[d * 32:(d + 1) * 32]
    return t_moe.moe_ffn_ep(local, x, cfg, plan=plan).numpy()


def _own_cases():
    """(name, config, strategy) of the cases held to the port's one-rank step."""
    import dataclasses
    from repro_torch.parallel import policy
    qwen = reduced(get_config(QWEN))
    dense = dataclasses.replace(qwen, embedding=dataclasses.replace(qwen.embedding, kind="dense"))
    dp = policy.Strategy(dp_over_model=True)
    granite = reduced(get_config(GRANITE))
    return (("qwen_dense_table", dense, policy.DEFAULT_STRATEGY),
            ("granite_ep_no_drop", dataclasses.replace(granite, n_experts=16, moe_top_k=8,
                                                       moe_capacity_factor=4.0),
             policy.DEFAULT_STRATEGY),
            ("musicgen_gelu_tp", reduced(get_config("musicgen-large")),
             policy.Strategy(tp_vocab=False)),
            ("mamba2_dp_over_model", reduced(get_config(MAMBA2)), dp),
            ("zamba2_dp_over_model", reduced(get_config("zamba2-7b")), dp))


def _own_batch(cfg):
    shape = (8, 16, cfg.n_codebooks) if cfg.input_mode == "audio_tokens" else (8, 16)
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, shape)
    return _batch(tok)


def _rank_main(rank, payload):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import pipeline, policy
    from repro_torch.parallel.tensor import ShardPlan
    from repro_torch.train.checkpoint import CheckpointManager
    ref = payload["ref"]
    mesh = make_host_mesh(2, 2, device="cpu")
    line = make_host_mesh(1, 4, device="cpu")
    out = {"coords": mesh.coords}
    dp = policy.Strategy(dp_over_model=True)
    for name, strategy in (("default", policy.DEFAULT_STRATEGY), ("dp", dp)):
        losses, params, state, specs = _step_case(ref[QWEN], QWEN, mesh, strategy)
        out[f"qwen_{name}"] = (losses, params)
        if name == "default":
            ck = CheckpointManager(payload["ckpt"], mesh=mesh)
            ck.save_sharded(1, state, specs)
            ck.wait()
    out["granite"] = _step_case(ref[GRANITE], GRANITE, mesh, policy.DEFAULT_STRATEGY)[:2]
    plan = ShardPlan(mesh=mesh, specs={}, grad_axes=("data",), tp=True,
                     compute_dtype=torch.float32)
    for cap in (4.0, 1.25):
        out[f"moe_{cap}"] = _ep_case(dict(ref[f"moe_{cap}"], cap=cap), mesh, plan)
    # gpipe: stage = this rank's place on the model axis of (1, 4)
    g = ref["gpipe"]
    s = line.index("model")
    sp = {k: torch.from_numpy(v[s]).requires_grad_(True) for k, v in g["params"].items()}
    y = pipeline.gpipe(_stage_fn, sp, torch.from_numpy(g["xs"]), line, axis="model")
    (y ** 2).sum().backward()
    out["gpipe"] = (y.detach().numpy(), {k: v.grad.numpy() for k, v in sp.items()})
    p = ref["psum"]
    r = line.index("model")
    mean, res = compress.psum_compressed(torch.from_numpy(p["gs"][r]),
                                         torch.from_numpy(p["res"][r]), line, "model")
    out["psum"] = (mean.numpy(), res.numpy())
    for name, cfg, strategy in _own_cases():
        state = init_train_state(torch.Generator().manual_seed(0), cfg, mesh=mesh,
                                 strategy=strategy)
        step = make_train_step(cfg, HYPER, mesh=mesh, strategy=strategy)
        state, m = step(state, _own_batch(cfg))
        specs = policy.state_shardings(cfg, state, mesh, strategy)
        out[name] = (float(m["loss"]),
                     _flat(policy.gather_tree(state["params"], specs["params"], mesh)))
    out["stats"] = dict(mesh.stats)
    return out


def _stage_fn(p, x):
    for i in range(2):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def _restart_main(rank, payload):
    """Restore the (2, 2) checkpoint on 2 ranks as (1, 2) and as (2, 1), and
    step."""
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.parallel import policy
    from repro_torch.train.checkpoint import CheckpointManager
    cfg = reduced(get_config(QWEN))
    out = {}
    for shape in ((1, 2), (2, 1)):
        mesh = make_host_mesh(*shape, device="cpu")
        strategy = policy.DEFAULT_STRATEGY
        specs = policy.params_shardings(cfg, policy.abstract_params(cfg), mesh, strategy)
        local = policy.shard_tree(params_from_jax(payload["params"], "cpu"), specs, mesh)
        template = {"params": local, "opt": adamw_init(local), "step": 0}
        template["opt"]["step"] = 0
        sspecs = policy.state_shardings(cfg, template, mesh, strategy)
        ck = CheckpointManager(payload["ckpt"], mesh=mesh)
        state, _ = ck.restore_sharded(1, template, sspecs)
        whole = _flat(policy.gather_tree(state["params"], sspecs["params"], mesh))
        mu = _flat(policy.gather_tree(state["opt"]["mu"], sspecs["opt"]["mu"], mesh))
        step = make_train_step(cfg, TrainHyper(total_steps=10), mesh=mesh, strategy=strategy)
        state, m = step(state, _batch(payload["tokens"]))
        out[shape] = dict(params=whole, mu=mu, step=state["step"], loss=float(m["loss"]))
    return out


@pytest.fixture(scope="module")
def ranks(jref):
    ckpt = tempfile.mkdtemp(prefix="lm_ranks_ckpt_")
    res = sharding.spawn(_rank_main, 4, backend="gloo",
                         args=(dict(ref=jref, ckpt=ckpt),), timeout_s=400)
    restart = sharding.spawn(_restart_main, 2, backend="gloo",
                             args=(dict(ckpt=ckpt, params=jref[QWEN]["params"],
                                        tokens=jref[QWEN]["tokens"]),), timeout_s=300)
    return res, restart, ckpt


def _close(got, want, rtol, atol, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=f"{what}: {k}")


def _delta_gap(got, want, start):
    """The worst leaf's max |(got - start) - (want - start)| / max |want -
    start|: the step's update against the reference's, over its scale."""
    worst = 0.0
    for k, w in want.items():
        d_want = w.astype(np.float64) - start[k]
        diff = np.abs(got[k].astype(np.float64) - start[k] - d_want).max()
        scale = np.abs(d_want).max()
        worst = max(worst, diff / scale if scale else (0.0 if diff == 0 else np.inf))
    return worst


def _one_rank_step(cfg, params, batch):
    """The port's one-rank step from ``params`` (f32 leaves as numpy,
    copied before the step) on ``batch``: (loss, params after)."""
    from repro_torch.optim.adamw import adamw_init
    torch.set_num_threads(1)
    state = {"params": params, "opt": adamw_init(params), "step": 0}
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    state, m = make_train_step(cfg, HYPER)(state, batch)
    return float(m["loss"]), {k: v for k, v in _flat(state["params"]).items()
                              if v.dtype.kind == "f"}


@pytest.mark.parametrize("strategy", ["default", "dp"])
def test_qwen_step_across_ranks_against_jax_and_one_rank(ranks, jref, strategy):
    res, _, _ = ranks
    losses, params = res[0][f"qwen_{strategy}"]
    j_loss, j_params = jref[QWEN]["single"]
    start = _jflat(jref[QWEN]["params"])
    np.testing.assert_allclose(losses[0], j_loss, rtol=JAX_LOSS_RTOL)
    want = {k: v for k, v in _jflat(j_params).items() if v.dtype.kind == "f"}
    _close(params, want, JAX_RTOL, JAX_ATOL, "against JAX")
    assert _delta_gap(params, want, start) <= DELTA
    # the port's one-rank step from the same params and batch
    cfg = reduced(get_config(QWEN))
    tokens = jref[QWEN]["tokens"]
    loss, one = _one_rank_step(cfg, params_from_jax(jref[QWEN]["params"], "cpu"),
                               _batch(tokens))
    np.testing.assert_allclose(losses[0], loss, rtol=ONE_LOSS_RTOL)
    _close(params, one, ONE_RTOL, ONE_ATOL, "against one rank")
    assert _delta_gap(params, one, start) <= DELTA
    # the controls the update's bound must fail: the gradient of data rank
    # 0's rows alone (the data axis's sum dropped), and the state unchanged
    _, half = _one_rank_step(cfg, params_from_jax(jref[QWEN]["params"], "cpu"),
                             _batch(tokens[:4]))
    assert _delta_gap(half, one, start) > 100 * DELTA
    assert _delta_gap({k: start[k] for k in one}, one, start) > 100 * DELTA
    # every rank holds the same bits of every leaf (replicated leaves equal)
    for r in res[1:]:
        assert r[f"qwen_{strategy}"][0] == losses
        for k, v in r[f"qwen_{strategy}"][1].items():
            assert np.array_equal(v, params[k]), k


def test_granite_ep_step_against_jax_sharded(ranks, jref):
    res, _, _ = ranks
    losses, params = res[0]["granite"]
    j_loss, j_params = jref[GRANITE]["sharded"]
    np.testing.assert_allclose(losses[0], j_loss, rtol=JAX_LOSS_RTOL)
    want = {k: v for k, v in _jflat(j_params).items() if v.dtype.kind == "f"}
    _close(params, want, JAX_RTOL, JAX_ATOL, "granite against JAX's sharded step")
    assert _delta_gap(params, want, _jflat(jref[GRANITE]["params"])) <= DELTA
    for r in res[1:]:
        assert r["granite"][0] == losses
        assert all(np.array_equal(v, params[k]) for k, v in r["granite"][1].items())


def _ep_gathered(res, cap):
    """The (64, 32) output from the ranks: data rank d's 32 rows (the model
    ranks of a row hold the same ones)."""
    by_data = {}
    for r in res:
        by_data.setdefault(r["coords"]["data"], []).append(r[f"moe_{cap}"])
    for outs in by_data.values():
        assert all(np.array_equal(o, outs[0]) for o in outs)
    return np.concatenate([by_data[d][0] for d in sorted(by_data)])


@pytest.mark.parametrize("cap", [4.0, 1.25])
def test_moe_ep_across_ranks_against_jax(ranks, jref, cap):
    res, _, _ = ranks
    got = _ep_gathered(res, cap)
    case = jref[f"moe_{cap}"]
    want = case["single"] if cap == 4.0 else case["ep"]
    np.testing.assert_allclose(got, want, rtol=EP_TOL, atol=EP_TOL)
    cfg = t_moe.MoEConfig(d_model=32, d_ff=64, n_experts=8, top_k=2, capacity_factor=cap)
    p = params_from_jax(case["params"], "cpu")
    ref = t_moe.moe_ffn_ep_reference(p, torch.from_numpy(case["x"]), cfg, ep=2, data_shards=2)
    assert np.array_equal(ref.numpy(), got)
    if cap == 1.25:     # rows drop: the EP output is not the no-drop one
        assert np.abs(got - case["single"]).max() > 1e-3


def test_gpipe_against_jax(ranks, jref):
    res, _, _ = ranks
    g = jref["gpipe"]
    for r in res:
        np.testing.assert_allclose(r["gpipe"][0], g["out"], rtol=2e-5, atol=2e-5)
    stage = {r["coords"]["data"] * 2 + r["coords"]["model"]: r for r in res}
    for s in range(4):
        for k in ("w", "b"):
            np.testing.assert_allclose(stage[s]["gpipe"][1][k], g["grads"][k][s],
                                       rtol=1e-4, atol=1e-4)
    from repro_torch.parallel.pipeline import pipeline_reference
    sp = {k: torch.from_numpy(v) for k, v in g["params"].items()}
    ref = pipeline_reference(_stage_fn, sp, torch.from_numpy(g["xs"]))
    np.testing.assert_allclose(ref.numpy(), g["out"], rtol=2e-5, atol=2e-5)


def test_compress_int8_bitwise_jax(ranks, jref):
    g = np.random.default_rng(5).standard_normal(1000).astype(np.float32) * 3
    g[:256] = 0.0                                        # an all-zero block: scale 1
    jq, js = j_compress.compress_gradients_int8(jnp.asarray(g))
    tq, ts = compress.compress_gradients_int8(torch.from_numpy(g))
    assert np.array_equal(np.asarray(jq), tq.numpy()) and np.array_equal(np.asarray(js), ts.numpy())
    jb = j_compress.decompress_gradients_int8(jq, js, g.shape)
    tb = compress.decompress_gradients_int8(tq, ts, g.shape)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    res, _, _ = ranks
    p = jref["psum"]
    ref_mean, ref_res = compress.psum_compressed_reference(
        [torch.from_numpy(x) for x in p["gs"]], [torch.from_numpy(x) for x in p["res"]])
    for r in res:
        i = r["coords"]["data"] * 2 + r["coords"]["model"]
        mean, new_res = r["psum"]
        assert np.array_equal(mean, p["mean"][i])
        assert np.array_equal(mean, ref_mean.numpy())
        assert np.array_equal(new_res, ref_res[i].numpy())
        # XLA:CPU contracts the residual's g - q * scale into one fused
        # multiply-add; the port rounds the product first (so the card and
        # the CPU agree): the residuals part by at most one ulp of q * scale
        deq = p["gs"][i] + p["res"][i] - new_res
        assert np.all(np.abs(new_res - p["newres"][i]) <= np.spacing(np.abs(deq)))


def test_restart_on_another_mesh(ranks):
    res, restart, ckpt = ranks
    saved = res[0]["qwen_default"][1]
    for shape in ((1, 2), (2, 1)):
        for r in restart:
            got = r[shape]
            assert all(np.array_equal(got["params"][k], v) for k, v in saved.items())
            assert got["step"] == 2 and np.isfinite(got["loss"])
        assert restart[0][shape]["loss"] == restart[1][shape]["loss"]


@pytest.mark.parametrize("case", [c[0] for c in _own_cases()])
def test_layouts_against_the_ports_one_rank_step(ranks, case):
    res, _, _ = ranks
    name, cfg, _ = next(c for c in _own_cases() if c[0] == case)
    torch.set_num_threads(1)
    params = init_train_state(torch.Generator().manual_seed(0), cfg)["params"]
    start = _flat(params)
    one_loss, one = _one_rank_step(cfg, params, _own_batch(cfg))
    loss, got = res[0][name]
    np.testing.assert_allclose(loss, one_loss, rtol=ONE_LOSS_RTOL)
    _close(got, one, ONE_RTOL, ONE_ATOL, name)
    assert _delta_gap(got, one, start) <= DELTA
    for r in res[1:]:
        assert r[name][0] == loss and all(np.array_equal(v, got[k])
                                          for k, v in r[name][1].items())


def test_bytes_counted_by_axis_and_collective(ranks):
    res, _, _ = ranks
    stats = res[0]["stats"]
    for key in ("data/fsdp_gather", "data/reduce_scatter", "model/all_reduce",
                "data+model/grad_norm"):
        assert stats.get(key, 0) > 0, (key, stats)
