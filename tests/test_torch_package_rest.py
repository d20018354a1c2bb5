"""Port parity for the package's last functions: the learning-rate
schedules ``constant_schedule`` and ``cosine_schedule``, the module helpers
``param_bytes`` and ``cast_floats``, ``CSRMatrix.to_dense``, ``FrontierBatch.targets``,
``HashEmbBackend.feature_dim``, ``CachedDecodeBackend.dtype_contract`` and
``GraphInferenceEngine.decode_buckets``, each against its JAX counterpart
on the same inputs.

Tolerances: the schedules are the same formulas in float64 here and
float32 in JAX, so within 1e-6; everything else is integer work, a copy
or a rounding both packages do the same way: equal, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.core import backend as jbackend
from repro.graph.csr import CSRMatrix as JCSR
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro.graph.sampler import FrontierBatch as JFrontier
from repro.nn import module as jmodule
from repro.optim import schedule as jschedule
from repro_torch.core import backend as tbackend
from repro_torch.graph.csr import CSRMatrix as TCSR
from repro_torch.graph.runtime import GraphRuntime, RuntimeSpec
from repro_torch.graph.sampler import FrontierBatch as TFrontier
from repro_torch.interop import params_from_jax
from repro_torch.nn import module as tmodule
from repro_torch.optim import constant_schedule, cosine_schedule

STEPS = [0, 1, 37, 99, 100, 101, 250]


@pytest.mark.parametrize("total,final_frac", [(100, 0.1), (100, 0.0), (0, 0.25)])
def test_schedules_match_jax(total, final_frac):
    for step in STEPS:
        assert constant_schedule(step) == float(jschedule.constant_schedule(step)) == 1.0
        np.testing.assert_allclose(
            cosine_schedule(step, total, final_frac),
            float(jschedule.cosine_schedule(step, total, final_frac)), rtol=1e-6, atol=1e-7)


def _trees():
    rng = np.random.default_rng(0)
    leaves = {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32),
              "ids": rng.integers(0, 9, (4,)).astype(np.int32),
              "codes_buf": rng.integers(0, 9, (6, 2)).astype(np.int32),
              "frozen_buf": rng.standard_normal((2, 2)).astype(np.float32)}
    jtree = {"layer": {k: jnp.asarray(v) for k, v in leaves.items()},
             "head": {"w": jnp.asarray(leaves["w"], jnp.bfloat16)}}
    ttree = {"layer": {k: torch.from_numpy(v) for k, v in leaves.items()},
             "head": {"w": torch.from_numpy(leaves["w"]).to(torch.bfloat16)}}
    return jtree, ttree


@pytest.mark.parametrize("trainable_only", [False, True])
def test_param_bytes_matches_jax(trainable_only):
    jtree, ttree = _trees()
    assert (tmodule.param_bytes(ttree, trainable_only)
            == jmodule.param_bytes(jtree, trainable_only) > 0)
    assert (tmodule.param_count(ttree, trainable_only)
            == jmodule.param_count(jtree, trainable_only))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cast_floats_matches_jax(dtype):
    jtree, ttree = _trees()
    jcast = {tuple(k.key for k in path): leaf for path, leaf in
             jax.tree_util.tree_leaves_with_path(jmodule.cast_floats(jtree, getattr(jnp, dtype)))}
    tcast = dict(tmodule.leaves_with_path(tmodule.cast_floats(ttree, getattr(torch, dtype))))
    assert tcast.keys() == jcast.keys()
    for path, leaf in tcast.items():
        assert str(leaf.dtype).removeprefix("torch.") == str(jcast[path].dtype), path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(jcast[path]).astype(np.float32))


def _graph():
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 60, 300), rng.integers(0, 60, 300)
    return JCSR.from_edges(src, dst, 60), TCSR.from_edges(src, dst, 60)


@pytest.mark.parametrize("kind", ["raw", "sym", "self_loops"])
def test_csr_to_dense_matches_jax(kind):
    j, t = _graph()
    if kind == "sym":
        j, t = j.normalized("sym"), t.normalized("sym")
    elif kind == "self_loops":
        j, t = j.with_self_loops(), t.with_self_loops()
    got = t.to_dense()
    assert got.dtype == torch.float32 and tuple(got.shape) == (60, 60)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.to_dense()))


def test_frontier_targets_match_jax():
    rng = np.random.default_rng(2)
    levels = [rng.integers(0, 500, 16), rng.integers(0, 500, (16, 3)),
              rng.integers(0, 500, (16, 3, 2))]
    jfb = JFrontier.from_levels(levels, pad_to=32)
    tfb = TFrontier.from_levels(levels, pad_to=32)
    np.testing.assert_array_equal(tfb.targets, np.asarray(jfb.targets))
    np.testing.assert_array_equal(tfb.targets, levels[0])
    assert torch.equal(tfb.to("cpu").targets, torch.as_tensor(levels[0], dtype=torch.int32)
                       .to(tfb.to("cpu").targets.dtype))


def test_hashemb_feature_dim_matches_jax():
    cb = np.zeros((4, 16, 24), np.float32)
    got = tbackend.get_backend("hashemb:gather", device=torch.device("cpu")).feature_dim(
        torch.from_numpy(cb))
    assert got == jbackend.get_backend("hashemb:gather").feature_dim(jnp.asarray(cb)) == 24


def test_cached_dtype_contract_matches_jax():
    assert (tbackend.CachedDecodeBackend.dtype_contract()
            == jbackend.CachedDecodeBackend.dtype_contract())
    policy = dict(param_dtype="bfloat16", quantize="int8")
    tbase = tbackend.get_backend("gather", device=torch.device("cpu"),
                                 policy=tbackend.MixedPrecisionPolicy(**policy))
    jbase = jbackend.get_backend("gather", policy=jbackend.MixedPrecisionPolicy(**policy))
    got = tbackend.CachedDecodeBackend.dtype_contract(tbase)
    assert got == jbackend.CachedDecodeBackend.dtype_contract(jbase) and got["base"] == "gather"


@pytest.fixture(scope="module")
def engines():
    cfg = j_paper_cfg("sage", n_nodes=500, n_classes=6)
    cfg = dataclasses.replace(
        cfg, d_e=16, hidden=32, fanouts=(3, 3),
        embedding=dataclasses.replace(cfg.embedding, c=16, m=4, d_c=32, d_m=32,
                                      lookup_impl="gather"))
    jspec = JSpec(graph=JSource(n_nodes=500, n_classes=6), model=cfg, serve_batch=32,
                  prefetch_depth=0)
    jrt = JRuntime.from_spec(jspec)
    params = params_from_jax(jax.tree.map(np.array, jrt.params), device="cpu")
    trt = GraphRuntime.from_spec(RuntimeSpec.from_json(jspec.to_json()), device="cpu",
                                 params=params)
    yield [(jrt.serve(**kw), trt.serve(**kw)) for kw in ({}, {"cache_capacity": 0})]
    jrt.close()


@pytest.mark.parametrize("max_requests", [1, 3, 8])
def test_decode_buckets_match_jax(engines, max_requests):
    for jeng, teng in engines:
        assert teng.cached == jeng.cached
        assert teng.decode_buckets(max_requests) == jeng.decode_buckets(max_requests)
