"""The LM's prefill and decode steps across ranks: the port's 4-rank steps
(``make_prefill_step`` / ``make_serve_step`` with ``mesh=``) against JAX's
steps jitted under ``params_shardings`` and ``cache_shardings_policy`` on
4 host devices (in a subprocess, as ``tests/test_torch_lm_ranks.py`` runs
them), decode with ``kv_seq`` bound to ``kv_seq_mesh_axis`` as JAX's dry
run binds it, and against the port's own one-rank steps.

The port's ranks are 4 CPU processes over gloo, spawned once for the
module, one thread each.  Every case starts from JAX's params
(``interop.params_from_jax``, each rank keeping its blocks), prefills 4
prompts of 16 tokens into a cache of 32 slots, then decodes 3 given
tokens (the same tokens in every run, so that the logits of each step
compare).  Reduced configs, f32:

  * ``qwen_tp``: qwen1.5-0.5b on (data 2, model 2), ``DEFAULT_STRATEGY``:
    attention on the rank's KV heads, the vocab-parallel head;
  * ``split_kv``: chatglm3-6b (4 query heads on 2 KV heads) on (1, 4): its
    KV heads do not divide the model axis, so the cache's slots split over
    ``model`` (``kv_seq`` binds model) and each rank attends over its own
    slots, the ranks' partials combined;
  * ``batch_of_one``: qwen with one prompt: the slots split over ``data``
    (JAX's long-context layout);
  * ``granite_ep``: granite-moe-3b-a800m under EP (rows drop at capacity
    1.25: held to JAX's sharded steps, which drop the same rows);
    ``granite_no_drop``: 16 experts at top-8 and capacity 4.0, nothing
    dropped, also held to the one-rank steps;
  * TP over the SSM heads (mamba2, zamba2) is in
    ``tests/test_torch_serve_ranks_ssm.py``, with this file's helpers and
    bounds (its own subprocess and ranks, so that neither file holds its
    worker long).

Bounds: each step's logits within ``LOGIT_TOL`` (abs and rel) of JAX's and
of the port's one-rank step (4 ranks against one read at most 1e-5: the
sums over ranks add f32 partials in another order); the caches after the
last step, gathered from the ranks' blocks, within ``CACHE_TOL`` of JAX's;
every rank the same logits bits.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_jax
from repro_torch.parallel import sharding

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S0, S_MAX, STEPS, BATCH = 16, 32, 3, 4
LOGIT_TOL = 1e-4
CACHE_TOL = 1e-4
# name -> (arch, config overrides, (data, model), batch)
CASES = {
    "qwen_tp": ("qwen1.5-0.5b", {}, (2, 2), BATCH),
    "split_kv": ("chatglm3-6b", {}, (1, 4), BATCH),
    "batch_of_one": ("qwen1.5-0.5b", {}, (2, 2), 1),
    "granite_ep": ("granite-moe-3b-a800m", {}, (2, 2), BATCH),
    "granite_no_drop": ("granite-moe-3b-a800m",
                        {"n_experts": 16, "moe_top_k": 8, "moe_capacity_factor": 4.0},
                        (2, 2), BATCH),
}
ONE_RANK_CASES = [c for c in CASES if c != "granite_ep"]     # EP drops rows: no one-rank twin

_JAX_SCRIPT = r'''
import dataclasses, json, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config, reduced
from repro.models.lm import init_cache, init_lm
from repro.parallel.policy import (DEFAULT_STRATEGY, batch_shardings, cache_shardings_policy,
                                   kv_seq_mesh_axis, params_shardings, rules_for)
from repro.parallel.sharding import ShardingRules, make_mesh, use_sharding
from repro.train.step import make_prefill_step, make_serve_step

cases = json.loads(sys.argv[2])
S0, S_MAX, STEPS = (int(a) for a in sys.argv[3:6])
tree_np = lambda t: jax.tree.map(lambda a: None if a is None else np.asarray(a), t,
                                 is_leaf=lambda x: x is None)
out = {}
for name, (arch, over, shape, B) in cases.items():
    cfg = dataclasses.replace(reduced(get_config(arch)), **over)
    mesh = make_mesh(tuple(shape), ("data", "model"))
    params = init_lm(jax.random.PRNGKey(0), cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S0 + STEPS)).astype(np.int32)
    rules = rules_for(DEFAULT_STRATEGY, mesh)
    dtype = jnp.dtype(cfg.compute_dtype)
    c_tpl = jax.eval_shape(lambda: init_cache(cfg, B, S_MAX, dtype))
    with use_sharding(mesh, rules):
        p_sh = params_shardings(cfg, jax.eval_shape(lambda: params), mesh)
        c_sh = cache_shardings_policy(cfg, c_tpl, mesh)
        b_sh = batch_shardings({"tokens": jax.ShapeDtypeStruct((B, S0), jnp.int32)}, mesh)
        pre = jax.jit(make_prefill_step(cfg, S_MAX), in_shardings=(p_sh, b_sh),
                      out_shardings=(None, c_sh))
        logits, cache = pre(params, {"tokens": jnp.asarray(tokens[:, :S0])})
    steps = [np.asarray(logits)]
    d_rules = ShardingRules(rules={**rules.rules,
                                   "kv_seq": kv_seq_mesh_axis(cfg, mesh, DEFAULT_STRATEGY, B)})
    with use_sharding(mesh, d_rules):
        b1 = batch_shardings({"tokens": jax.ShapeDtypeStruct((B, 1), jnp.int32)}, mesh)
        srv = jax.jit(make_serve_step(cfg), in_shardings=(p_sh, c_sh, b1),
                      out_shardings=(None, c_sh))
        for i in range(STEPS):
            logits, cache = srv(params, cache, {"tokens": jnp.asarray(tokens[:, S0 + i:S0 + i + 1])})
            steps.append(np.asarray(logits))
    out[name] = dict(params=tree_np(params), tokens=tokens, logits=steps,
                     cache={k: np.asarray(getattr(cache, k)) for k in
                            ("kv_k", "kv_v", "ssm_state", "conv")
                            if getattr(cache, k) is not None})
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
'''


def _cfg(case):
    """A case's reduced config: (arch, overrides, mesh shape, batch)."""
    arch, over, _, _ = case
    return dataclasses.replace(reduced(get_config(arch)), **over)


def jax_steps(cases, tmp_path_factory):
    """JAX's sharded steps of ``cases``, in a subprocess with 4 forced host
    devices."""
    path = str(tmp_path_factory.mktemp("jax") / "serve.pkl")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, path, json.dumps(cases),
                          str(S0), str(S_MAX), str(STEPS)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(path, "rb") as f:
        return pickle.load(f)


def port_ranks(cases, jref):
    """The port's 4 ranks over every case, from JAX's params."""
    ref = {name: {k: jref[name][k] for k in ("params", "tokens", "cache")} for name in cases}
    return sharding.spawn(_rank_main, 4, backend="gloo", args=(ref, cases), timeout_s=400)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    return jax_steps(CASES, tmp_path_factory)


def _steps(cfg, params, tokens, mesh=None):
    """The prefill and ``STEPS`` decode steps: (each step's logits, cache)."""
    from repro_torch.train.step import make_prefill_step, make_serve_step
    t = torch.from_numpy(tokens.astype(np.int64))
    prefill = make_prefill_step(cfg, S_MAX, mesh=mesh)
    serve = make_serve_step(cfg, mesh=mesh)
    logits, cache = prefill(params, {"tokens": t[:, :S0]})
    out = [logits.numpy().copy()]
    for i in range(STEPS):
        logits, cache = serve(params, cache, {"tokens": t[:, S0 + i:S0 + i + 1]})
        out.append(logits.numpy().copy())
    return out, cache


def _rank_main(rank, ref, cases):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.lm import LMCache
    from repro_torch.parallel import policy
    out = {}
    meshes = {}
    for name, (_, _, shape, batch) in cases.items():
        if shape not in meshes:      # every rank builds the meshes' groups in one order
            meshes[shape] = make_host_mesh(*shape, device="cpu")
    for name, case in cases.items():
        mesh = meshes[case[2]]
        cfg = _cfg(case)
        specs = policy.params_shardings(cfg, policy.abstract_params(cfg), mesh)
        params = policy.shard_tree(params_from_jax(ref[name]["params"], "cpu"), specs, mesh)
        before = dict(mesh.stats)
        logits, cache = _steps(cfg, params, ref[name]["tokens"], mesh)
        whole = {k: torch.empty(v.shape, device="meta") for k, v in ref[name]["cache"].items()}
        cspecs = policy.cache_shardings_policy(cfg, LMCache(pos=0, **whole), mesh)
        gathered = {k: policy.gather_leaf(getattr(cache, k), getattr(cspecs, k), mesh).numpy()
                    for k in whole}
        out[name] = dict(logits=logits, cache=gathered, kv_seq=cache.kv_seq,
                         stats={k: v - before.get(k, 0) for k, v in mesh.stats.items()
                                if not k.endswith("_calls")})
    return out


@pytest.fixture(scope="module")
def ranks(jref):
    return port_ranks(CASES, jref)


def check_against_jax(ranks, jref, case):
    got = ranks[0][case]["logits"]
    want = jref[case]["logits"]
    assert len(got) == len(want) == STEPS + 1
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"{case}: step {i}")
    for r in ranks[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(r[case]["logits"], got))


def check_caches(ranks, jref, case):
    got, want = ranks[0][case]["cache"], jref[case]["cache"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=CACHE_TOL, atol=CACHE_TOL,
                                   err_msg=f"{case}: {k}")


def check_against_one_rank(ranks, jref, cases, case):
    torch.set_num_threads(1)
    cfg = _cfg(cases[case])
    one, _ = _steps(cfg, params_from_jax(jref[case]["params"], "cpu"), jref[case]["tokens"])
    for i, (g, w) in enumerate(zip(ranks[0][case]["logits"], one)):
        np.testing.assert_allclose(g, w, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"{case}: step {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_serve_steps_across_ranks_against_jax(ranks, jref, case):
    check_against_jax(ranks, jref, case)


@pytest.mark.parametrize("case", list(CASES))
def test_serve_caches_across_ranks_against_jax(ranks, jref, case):
    check_caches(ranks, jref, case)


@pytest.mark.parametrize("case", ONE_RANK_CASES)
def test_serve_steps_across_ranks_against_one_rank(ranks, jref, case):
    check_against_one_rank(ranks, jref, CASES, case)


def test_split_kv_layouts_and_bytes(ranks):
    """The layouts the cases exercise: chatglm3's slots on ``model`` (its
    query heads gathered, the partials combined over ``model``), one
    prompt's on ``data``; the others' slots whole on each rank."""
    r = ranks[0]
    assert r["split_kv"]["kv_seq"] == ("model",)
    assert r["batch_of_one"]["kv_seq"] == ("data",)
    assert r["qwen_tp"]["kv_seq"] == () and r["granite_ep"]["kv_seq"] == ()
    assert r["split_kv"]["stats"].get("model/kv_combine", 0) > 0
    assert r["split_kv"]["stats"].get("model/q_gather", 0) > 0
    assert r["batch_of_one"]["stats"].get("data/kv_combine", 0) > 0
    assert "model/kv_combine" not in r["qwen_tp"]["stats"]
