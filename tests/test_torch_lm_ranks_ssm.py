"""TP over the SSM heads (the JAX package's ``ssm_heads`` / ``ssm_inner``
rules): reduced mamba2-2.7b and zamba2-7b (the hybrid's shared attention
block and tail too) under ``DEFAULT_STRATEGY`` on the (data 2, model 2)
mesh, half the SSD heads a rank, against JAX's step jitted on a (2, 2)
mesh of 4 host devices (in a subprocess, as ``tests/test_torch_lm_ranks.py``
runs its references, whose helpers and bounds this file shares) and
against the port's one-rank step.

The port's ranks are 4 CPU processes over gloo, spawned once for the
module, one thread each; one step from JAX's params at AdamW eps 1, lr 1,
no warmup, so the step moves each weight by about its clipped gradient.

Bounds (``tests/test_torch_lm_ranks.py``'s): against JAX loss rtol 1e-4,
params rtol 5e-3 / atol 5e-4; against one rank the step-0 loss within
1e-6 relative and the params within rtol 1e-3 / atol 1e-5; against both
every leaf's update within ``DELTA`` of the reference's largest; every
rank the same bits.  Also: reduced mamba2 under ``dp_over_model`` (its JAX
profile) steps to the same finite loss on every rank; the norm's sums
over the model axis are counted (``model/reduce``, ``model/reduce_grad``).
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_lm_ranks as base
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_jax
from repro_torch.parallel import sharding
from repro_torch.train.step import TrainHyper, init_train_state, make_train_step

MAMBA2, ZAMBA2 = "mamba2-2.7b", "zamba2-7b"

_JAX_SCRIPT = r'''
import pickle, sys
LR = float(sys.argv[2])
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.parallel.sharding import make_mesh, use_sharding
from repro.parallel.policy import state_shardings, batch_shardings
from repro.train.step import TrainHyper, init_train_state, make_train_step
from repro.optim.adamw import AdamWConfig

out = {}
tree_np = lambda t: jax.tree.map(lambda a: None if a is None else np.asarray(a), t,
                                 is_leaf=lambda x: x is None)
rng = np.random.default_rng(0)
for arch in ("mamba2-2.7b", "zamba2-7b"):
    cfg = reduced(get_config(arch))
    key = jax.random.PRNGKey(0)
    state = init_train_state(key, cfg)
    tokens = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    step = make_train_step(cfg, TrainHyper(
        optimizer=AdamWConfig(lr=LR, weight_decay=0.01, clip_norm=1.0, eps=1.0),
        warmup_steps=1, total_steps=10))
    r = {"params": tree_np(state["params"]), "tokens": tokens}
    mesh = make_mesh((2, 2), ("data", "model"))
    with use_sharding(mesh):
        st_sh = state_shardings(cfg, jax.eval_shape(lambda: init_train_state(key, cfg)), mesh)
        b_sh = batch_shardings(jax.eval_shape(lambda: batch), mesh)
        s2, m2 = jax.jit(step, in_shardings=(st_sh, b_sh),
                         out_shardings=(st_sh, None))(state, batch)
    r["sharded"] = (float(m2["loss"]), tree_np(s2["params"]))
    out[arch] = r
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """JAX's (2, 2)-mesh steps, in a subprocess with 4 forced host devices."""
    path = str(tmp_path_factory.mktemp("jax") / "ssm.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(base.REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, path, repr(base.LR)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def _rank_main(rank, ref):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel import policy
    mesh = make_host_mesh(2, 2, device="cpu")
    out = {}
    for arch in (MAMBA2, ZAMBA2):
        out[arch] = base._step_case(ref[arch], arch, mesh, policy.DEFAULT_STRATEGY)[:2]
    out["stats"] = dict(mesh.stats)
    dp = policy.Strategy(dp_over_model=True)
    cfg = reduced(get_config(MAMBA2))
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (8, 16))
    state = init_train_state(torch.Generator().manual_seed(0), cfg, mesh=mesh, strategy=dp)
    step = make_train_step(cfg, TrainHyper(total_steps=10), mesh=mesh, strategy=dp)
    out["mamba2_dp"] = float(step(state, base._batch(tok))[1]["loss"])
    return out


@pytest.fixture(scope="module")
def ranks(jref):
    ref = {arch: {k: jref[arch][k] for k in ("params", "tokens")} for arch in (MAMBA2, ZAMBA2)}
    return sharding.spawn(_rank_main, 4, backend="gloo", args=(ref,), timeout_s=300)


@pytest.mark.parametrize("arch", [MAMBA2, ZAMBA2])
def test_ssm_across_model_ranks_against_jax_and_one_rank(ranks, jref, arch):
    """TP over the SSM heads (``DEFAULT_STRATEGY`` on (2, 2): half the heads
    a rank) against JAX's (2, 2)-mesh step and the port's one-rank step."""
    res = ranks
    losses, params = res[0][arch]
    j_loss, j_params = jref[arch]["sharded"]
    start = base._jflat(jref[arch]["params"])
    np.testing.assert_allclose(losses[0], j_loss, rtol=base.JAX_LOSS_RTOL)
    want = {k: v for k, v in base._jflat(j_params).items() if v.dtype.kind == "f"}
    base._close(params, want, base.JAX_RTOL, base.JAX_ATOL, f"{arch} against JAX's sharded step")
    assert base._delta_gap(params, want, start) <= base.DELTA
    cfg = reduced(get_config(arch))
    loss, one = base._one_rank_step(cfg, params_from_jax(jref[arch]["params"], "cpu"),
                                    base._batch(jref[arch]["tokens"]))
    np.testing.assert_allclose(losses[0], loss, rtol=base.ONE_LOSS_RTOL)
    base._close(params, one, base.ONE_RTOL, base.ONE_ATOL, f"{arch} against one rank")
    assert base._delta_gap(params, one, start) <= base.DELTA
    for r in res[1:]:
        assert r[arch][0] == losses
        assert all(np.array_equal(v, params[k]) for k, v in r[arch][1].items())
    # the gated norm's sums over the model axis, and its gradient's
    for key in ("model/reduce", "model/reduce_grad", "model/all_reduce"):
        assert res[0]["stats"].get(key, 0) > 0, (key, res[0]["stats"])
    # mamba2 under dp_over_model (its JAX profile): the same finite loss on
    # every rank
    assert np.isfinite(res[0]["mamba2_dp"])
    assert len({r["mamba2_dp"] for r in res}) == 1
