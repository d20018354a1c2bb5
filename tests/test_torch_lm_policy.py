"""The port's LM sharding policy against the JAX package's, spec for spec.

For every one of the 10 architectures (full widths, abstract shapes: JAX's
``jax.eval_shape`` beside the port's fake tensors), on the meshes (16, 16),
(2, 16, 16), (4, 2) and (2, 2) (a JAX ``AbstractMesh`` beside the port's
``MeshSpec``), under ``DEFAULT_STRATEGY``, ``Strategy(dp_over_model=True)``
and the arch's ``OPTIMIZED_TRAIN`` profile: every leaf spec of
``params_shardings``, ``state_shardings`` and ``batch_shardings`` equals
JAX's ``PartitionSpec``, and so do ``cache_shardings_policy``,
``kv_seq_mesh_axis`` and ``cache_shardings`` (the logical specs under the
strategy's rules).  ``analytic_hbm_bytes`` gives JAX's numbers exactly
(every arch and shape on both production meshes, under the arch's
profile), and ``OPTIMIZED_TRAIN`` is JAX's field for field.  The live
``Mesh``'s layout (rank order, lines) is checked against ``MeshSpec``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as j_get_config
from repro.launch import hbm_model as j_hbm
from repro.launch import profiles as j_profiles
from repro.launch.shapes import SHAPES as J_SHAPES
from repro.models import lm as j_lm
from repro.parallel import policy as j_policy
from repro.parallel import sharding as j_sharding
from repro.train.step import init_train_state as j_init_train_state
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import hbm_model, profiles
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import lm as t_lm
from repro_torch.nn.module import leaves_with_path
from repro_torch.optim.adamw import adamw_init
from repro_torch.parallel import policy, sharding

ARCHS = list_archs()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
STRATEGIES = ("default", "dp_over_model", "profile")
_TREES = {}


def _meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), sharding.MeshSpec(axes, shape)


def _strategies(arch, which):
    if which == "default":
        return j_policy.DEFAULT_STRATEGY, policy.DEFAULT_STRATEGY
    if which == "dp_over_model":
        return j_policy.Strategy(dp_over_model=True), policy.Strategy(dp_over_model=True)
    j, t = j_profiles.OPTIMIZED_TRAIN[arch]["strategy"], profiles.OPTIMIZED_TRAIN[arch]["strategy"]
    return j, t


def _trees(arch):
    """(JAX abstract train state, port abstract params) of an arch."""
    if arch not in _TREES:
        jcfg = j_get_config(arch)
        jstate = jax.eval_shape(lambda: j_init_train_state(jax.random.PRNGKey(0), jcfg))
        _TREES[arch] = (jstate, policy.abstract_params(get_config(arch)))
    return _TREES[arch]


def _jax_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: x is None)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            None if v is None else tuple(v.spec) for path, v in flat}


def _port_specs(tree):
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, prefix + (k,))
        else:
            out["/".join(prefix)] = t
    walk(tree, ())
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_state_and_batch_specs_equal_jax(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jstate, tparams = _trees(arch)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for which in STRATEGIES:
        jst, tst = _strategies(arch, which)
        jsh = _jax_specs(j_policy.state_shardings(jcfg, jstate, jmesh, jst))
        tstate = {"params": tparams, "opt": adamw_init(tparams), "step": 0}
        tsh = _port_specs(policy.state_shardings(tcfg, tstate, tmesh, tst))
        assert set(jsh) == set(tsh), (which, set(jsh) ^ set(tsh))
        for key, spec in jsh.items():
            assert tsh[key] == spec, (which, key, spec, tsh[key])
        # params_shardings alone is the state's "params" part
        tp = _port_specs(policy.params_shardings(tcfg, tparams, tmesh, tst))
        assert all(tp[k] == jsh["params/" + k] for k in tp)
        # batches: tokens / labels, vlm positions (3, B, S) on dim 1, audio (B, S, nq)
        for B in (256, 128, 32, 2, 1):
            S = 64
            tok = (B, S, tcfg.n_codebooks) if tcfg.input_mode == "audio_tokens" else (B, S)
            batch = {"tokens": np.zeros(tok, np.int32), "labels": np.zeros(tok, np.int32)}
            if tcfg.rope_variant == "mrope":
                batch["positions"] = np.zeros((3, B, S), np.int32)
            jb = _jax_specs(j_policy.batch_shardings(
                jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.int32), batch),
                jmesh, jst))
            tb = _port_specs(policy.batch_shardings(batch, tmesh, tst))
            assert jb == tb, (which, B, jb, tb)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for which in STRATEGIES:
        jst, tst = _strategies(arch, which)
        for batch, s_max in ((128, 1024), (1, 4096), (2, 512)):
            jc = jax.eval_shape(lambda: j_lm.init_cache(jcfg, batch, s_max, jnp.bfloat16))
            tc = t_lm.init_cache(tcfg, batch, s_max, torch.bfloat16, device="meta")
            try:
                jp = j_policy.cache_shardings_policy(jcfg, jc, jmesh, jst)
            except Exception as e:  # noqa: BLE001  JAX refuses an axis on two dims; so does the port
                assert type(e).__name__ == "DuplicateSpecError", e
                with pytest.raises(ValueError, match="more than one dim"):
                    policy.cache_shardings_policy(tcfg, tc, tmesh, tst)
                jp = None
            if jp is not None:
                tp = policy.cache_shardings_policy(tcfg, tc, tmesh, tst)
                for name in ("pos", "kv_k", "kv_v", "ssm_state", "conv"):
                    j, t = getattr(jp, name), getattr(tp, name)
                    assert (None if j is None else tuple(j.spec)) == t, (which, batch, name, j, t)
            assert (j_policy.kv_seq_mesh_axis(jcfg, jmesh, jst, batch)
                    == policy.kv_seq_mesh_axis(tcfg, tmesh, tst, batch))
            jrules = j_policy.rules_for(jst, jmesh)
            trules = policy.rules_for(tst, tmesh)
            assert jrules.rules == trules.rules
            with j_sharding.use_sharding(jmesh, jrules):
                jl = j_lm.cache_shardings(jcfg, batch, s_max)
            with sharding.use_sharding(tmesh, trules):
                tl = t_lm.cache_shardings(tcfg, batch, s_max)
            for name in ("kv_k", "kv_v", "ssm_state", "conv"):
                j, t = getattr(jl, name), getattr(tl, name)
                assert (None if j is None else tuple(j.spec)) == t, (which, batch, name, j, t)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_hbm_bytes_equal_jax(arch, multi_pod):
    jmesh, tmesh = _meshes("2x16x16" if multi_pod else "16x16")
    assert make_production_mesh(multi_pod=multi_pod) == tmesh
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for shape in SHAPES:
        jset = j_profiles.optimized_cell_settings(arch, J_SHAPES[shape].kind) or {}
        tset = profiles.optimized_cell_settings(arch, SHAPES[shape].kind) or {}
        kw = dict(microbatches=tset.get("microbatches", 1))
        j = j_hbm.analytic_hbm_bytes(jcfg, J_SHAPES[shape], jmesh, strategy=jset.get("strategy"),
                                     **kw)
        t = hbm_model.analytic_hbm_bytes(tcfg, SHAPES[shape], tmesh,
                                         strategy=tset.get("strategy"), **kw)
        assert j == t, (shape, j, t)
    j = j_hbm.analytic_hbm_bytes(jcfg, J_SHAPES["train_4k"], jmesh, attn_scores_hbm=True)
    t = hbm_model.analytic_hbm_bytes(tcfg, SHAPES["train_4k"], tmesh, attn_scores_hbm=True)
    assert j == t


def test_optimized_train_profiles_equal_jax():
    assert set(j_profiles.OPTIMIZED_TRAIN) == set(profiles.OPTIMIZED_TRAIN)
    for arch, jset in j_profiles.OPTIMIZED_TRAIN.items():
        tset = profiles.OPTIMIZED_TRAIN[arch]
        assert set(jset) == set(tset)
        for k, v in jset.items():
            if k == "strategy":
                assert dataclasses.asdict(v) == dataclasses.asdict(tset[k])
            else:
                assert v == tset[k], (arch, k)
        assert profiles.optimized_cell_settings(arch, "decode") is None
        assert profiles.optimized_cell_settings(arch, "train") is tset


@pytest.mark.parametrize("shape,axes", [((2, 2), ("data", "model")),
                                        ((2, 3, 2), ("pod", "data", "model"))])
def test_mesh_layout_is_row_major(shape, axes):
    """Ranks row-major over the axes, the last fastest (``jax.make_mesh``'s
    device order); a line is ascending ranks; ``_spec_for`` sheds leading
    axes as JAX's does; a live mesh needs its world."""
    spec = sharding.MeshSpec(axes, shape)
    jmesh = AbstractMesh(shape, axes)
    ranks = np.arange(spec.size).reshape(shape)
    for r in range(spec.size):
        c = spec.coords(r)
        assert ranks[tuple(c[a] for a in axes)] == r and spec.rank_of(c) == r
        for k, a in enumerate(axes):
            idx = [c[b] for b in axes]
            idx[k] = slice(None)
            assert spec.line(r, (a,)) == list(ranks[tuple(idx)])
    rules = sharding.DEFAULT_RULES
    for dims, names in (((256, 4096, 1024), ("batch", "seq", "embed")),
                        ((6, 2048, 64), ("batch", None, "heads")),
                        ((4, 64), ("vocab", "fsdp")), ((3,), ("batch",))):
        with j_sharding.use_sharding(jmesh):
            j = j_sharding.logical_sharding(dims, *names)
        with sharding.use_sharding(spec, rules):
            t = sharding.logical_sharding(dims, *names)
        assert tuple(j.spec) == t
    assert sharding.logical_sharding((4,), "batch") is None
    with pytest.raises(ValueError, match="ranks"):
        sharding.Mesh(spec)
    with pytest.raises(ValueError, match="ranks"):
        make_host_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        make_production_mesh(live=True, device="cpu")
    one = sharding.make_mesh((1, 1), ("data", "model"), device="cpu")
    assert one.coords == {"data": 0, "model": 0} and one.all_gather(torch.ones(2), "data")[0].sum() == 2
