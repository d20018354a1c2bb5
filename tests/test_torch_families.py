"""The hashemb and tt compression families in the port against the JAX
package (each case mirrors its test in tests/test_families.py).

Sizes: 300 entities, c=16, m=4, d_c=d_m=16, d_e=16, tt rank 4 (c1=c2=4,
d1=d2=4); the runtime cases train the paper's GraphSAGE at those widths on
a 300-node graph from JAX's init (``params_from_jax``).

Tolerances, each stated where it is used:
* position codes, the hashemb fold and its decode through the ``gather``
  base and the kernel's plain version: bitwise JAX's (the same f32
  products, summed in codebook order);
* TT's decode sums m*r products per output in another order than XLA's
  einsum: rtol = atol = 1e-5; its core gradients, and hashemb's pools and
  ``wpos`` gradients (sums over the batch in another order): 1e-4 / 1e-5;
* training, as for the paper family (tests/test_torch_gnn_train.py): each
  step from JAX's state, the loss within 1e-5 and the params within 1e-4,
  and 5 free steps at Adam eps 1 within the same (at eps 1e-8 Adam
  amplifies rounding-level gradient differences, ROADMAP §C).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.core import backend as jbackend
from repro.core import codes as jcodes
from repro.core import decoder as jdecoder
from repro.core import embedding as jemb
from repro.graph.runtime import GraphRuntime as JRuntime
from repro.graph.runtime import GraphSource as JSource
from repro.graph.runtime import RuntimeSpec as JSpec
from repro.nn import module as jnn
from repro.train.step import TrainHyper as JTrainHyper
from repro.train.step import init_train_state as j_init_train_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.core import backend as tbackend
from repro_torch.core import decoder as tdecoder
from repro_torch.core import embedding as temb
from repro_torch.data.tokens import TokenStream, TokenStreamConfig
from repro_torch.graph.runtime import GraphRuntime, RuntimeSpec
from repro_torch.interop import params_from_jax
from repro_torch.nn.module import leaves_with_path, param_count, trainable_mask
from repro_torch.optim import adamw as t_adamw
from repro_torch.train.step import TrainHyper, make_train_step

CPU = torch.device("cpu")
LOSS_TOL, PARAM_TOL = 1e-5, 1e-4
STEPS = 5


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _cfgs(impl, kind="random_full", **kw):
    base = dict(kind=kind, n_entities=300, d_e=16, c=16, m=4, d_c=16, d_m=16,
                n_layers=2, tt_rank=4, lookup_impl=impl, compute_dtype="float32")
    base.update(kw)
    return jemb.EmbeddingConfig(**base), temb.EmbeddingConfig(**base)


def _jax_init(impl, kind="random_full", seed=0, **kw):
    """(JAX params as numpy, the port's copy, jcfg, tcfg)."""
    jcfg, tcfg = _cfgs(impl, kind, **kw)
    p = _np(jemb.init_embedding(jax.random.PRNGKey(seed), jcfg))
    return p, params_from_jax(p, device="cpu"), jcfg, tcfg


# ---------------- registry and the TT algebra ----------------

def test_registry_takes_the_families():
    assert tbackend.available_backends() == ("gather", "hashemb", "onehot", "owner",
                                             "pallas", "sharded", "tt")
    assert tbackend.get_backend("hashemb:gather", device=CPU).base.name == "gather"
    assert tbackend.get_backend("hashemb", device=CPU).base.name == "onehot"
    assert tbackend.get_backend("hashemb", device=torch.device("cuda")).base.name == "pallas"
    for bad in ("hashemb:tt", "hashemb:hashemb", "hashemb:sharded", "tt:gather"):
        with pytest.raises(ValueError):
            tbackend.get_backend(bad, device=CPU)
    assert tbackend.NOT_PORTED == {}
    assert tbackend.get_backend("owner:tt", device=CPU).base.name == "tt"


def test_tt_factor_pair_matches_jax():
    for n in range(1, 1025):
        assert tbackend.tt_factor_pair(n) == jbackend.tt_factor_pair(n), n


def _cores(m, c, d_c, r, seed):
    rng = np.random.default_rng(seed)
    c1, c2 = jbackend.tt_factor_pair(c)
    d1, d2 = jbackend.tt_factor_pair(d_c)
    return (rng.standard_normal((m, c1, d1, r)).astype(np.float32),
            rng.standard_normal((m, c2, r, d2)).astype(np.float32))


def test_tt_materialize_matches_jax():
    g0, g1 = _cores(4, 16, 24, 3, seed=0)
    got = tbackend.tt_materialize(torch.from_numpy(g0), torch.from_numpy(g1)).numpy()
    ref = np.asarray(jbackend.tt_materialize(jnp.asarray(g0), jnp.asarray(g1)))
    assert got.shape == (4, 16, 24)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("with_w0", [False, True])
def test_tt_decode_and_gradients_match_jax(with_w0):
    """From injected cores: the decode within 1e-5 of JAX's and of the
    gather of ``tt_materialize``; the cores' and w0's gradients within
    1e-4 of JAX's."""
    m, c, d_c, r, B = 4, 16, 24, 3, 64
    g0, g1 = _cores(m, c, d_c, r, seed=1)
    rng = np.random.default_rng(2)
    codes = rng.integers(0, c, (B, m)).astype(np.int32)
    w0 = rng.standard_normal(d_c).astype(np.float32) if with_w0 else None
    G = rng.standard_normal((B, d_c)).astype(np.float32)
    tbe = tbackend.get_backend("tt", device=CPU)
    t = [torch.from_numpy(x).requires_grad_(True) for x in (g0, g1)]
    tw0 = None if w0 is None else torch.from_numpy(w0).requires_grad_(True)
    out = tbe.decode(torch.from_numpy(codes), (t[0], t[1]), tw0)
    (out * torch.from_numpy(G)).sum().backward()
    assert tbe.feature_dim((t[0], t[1])) == d_c

    jbe = jbackend.get_backend("tt")
    jw0 = () if w0 is None else (jnp.asarray(w0),)
    ref = np.asarray(jbe.decode(jnp.asarray(codes), (jnp.asarray(g0), jnp.asarray(g1)), *jw0))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
    dense = tbackend.tt_materialize(torch.from_numpy(g0), torch.from_numpy(g1))
    oracle = tbackend.get_backend("gather", device=CPU).decode(
        torch.from_numpy(codes), dense, None if w0 is None else torch.from_numpy(w0))
    np.testing.assert_allclose(out.detach().numpy(), oracle.numpy(), rtol=1e-5, atol=1e-5)

    def loss(a, b, *w):
        return (jbe.decode(jnp.asarray(codes), (a, b), *w) * jnp.asarray(G)).sum()
    jg = jax.grad(loss, argnums=tuple(range(2 + len(jw0))))(jnp.asarray(g0), jnp.asarray(g1), *jw0)
    got = [t[0].grad, t[1].grad] + ([] if tw0 is None else [tw0.grad])
    for a, b in zip(got, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_tt_row_gather_backward_is_the_ascending_sum():
    """The core rows' gather: its backward sums each row's cotangents in f32
    in ascending position (bitwise ``index_add_`` on the CPU, which adds in
    that order), once rounded to a bf16 table's dtype; two calls the same."""
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(0, 40, 3000))
    g = torch.from_numpy(rng.standard_normal((3000, 24)).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.zeros(48, 24, dtype=dtype, requires_grad=True)
        out = tbackend._RowGather.apply(table, idx)
        assert out.dtype == torch.float32
        a = torch.autograd.grad(out, table, g, retain_graph=True)[0]
        b = torch.autograd.grad(out, table, g)[0]
        want = torch.zeros(48, 24).index_add_(0, idx, g).to(dtype)
        assert a.dtype == dtype and torch.equal(a, want) and torch.equal(a, b)


# ---------------- hashemb ----------------

@pytest.mark.parametrize("impl", ["hashemb:gather", "hashemb:pallas"])
def test_hashemb_decode_is_bitwise_jax(impl):
    """Position codes, the ``wpos`` fold and the decode through the gather
    base and the kernel base (its plain version here; JAX's Pallas kernel
    in interpret mode): bitwise.  The pools' and ``wpos``' gradients within
    1e-5 of JAX's."""
    p, tp, jcfg, tcfg = _jax_init(impl, seed=1)
    dec, tdec = p["decoder"], tp["decoder"]
    dec["wpos"] = np.random.default_rng(3).standard_normal(dec["wpos"].shape).astype(np.float32)
    tdec["wpos"] = torch.from_numpy(dec["wpos"].copy())
    ids = np.arange(256)
    jc = np.asarray(jcodes.position_codes(jnp.asarray(ids), 16, 4))
    tc = temb.lookup_codes(tp, torch.from_numpy(ids), tcfg)
    np.testing.assert_array_equal(tc.numpy(), jc)

    jdcfg, tdcfg = jcfg.decoder_config(), tcfg.decoder_config()
    jbe = jbackend.get_backend(impl, interpret=True, policy=jdcfg.precision_policy())
    G = np.random.default_rng(4).standard_normal((256, 16)).astype(np.float32)

    def jloss(pools, wpos):
        cb, w0 = jdecoder._decode_stage_operands({"pools": pools, "wpos": wpos}, jdcfg,
                                                 jnp.float32)
        out = jbe.decode(jnp.asarray(jc), cb, w0)
        return (out * jnp.asarray(G)).sum(), out

    (_, ref), jg = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(dec["pools"]), jnp.asarray(dec["wpos"]))
    leaves = {k: tdec[k].clone().requires_grad_(True) for k in ("pools", "wpos")}
    out = tdecoder.decode_stage(leaves, tc, tdcfg)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(ref))
    (out * torch.from_numpy(G)).sum().backward()
    for k, g in zip(("pools", "wpos"), jg):
        np.testing.assert_allclose(leaves[k].grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_hashemb_has_no_codes_buf_and_light_trains_wpos_only():
    _, tcfg = _cfgs("hashemb:gather")
    assert tcfg.family == "hashemb" and not tcfg.needs_codes and tcfg.is_compressed
    p = temb.init_embedding(torch.Generator().manual_seed(0), tcfg)
    assert set(p) == {"decoder"}
    out = temb.embed_lookup(p, torch.arange(10), tcfg)
    assert out.shape == (10, 16) and bool(torch.isfinite(out).all())
    _, light = _cfgs("hashemb:gather", kind="random_light")
    mask = trainable_mask(temb.init_embedding(torch.Generator().manual_seed(0), light)["decoder"])
    assert mask["pools_buf"] is False and mask["wpos"] is True
    assert set(mask) == {"pools_buf", "wpos", "mlp"}


def test_tt_light_freezes_cores():
    _, light = _cfgs("tt", kind="random_light")
    dec = temb.init_embedding(torch.Generator().manual_seed(0), light)["decoder"]
    mask = trainable_mask(dec)
    assert mask == {"tt_g0_buf": False, "tt_g1_buf": False, "w0": True,
                    "mlp": {k: True for k in dec["mlp"]}}
    assert temb.embed_lookup({"codes_buf": torch.zeros(300, 1, dtype=torch.int64),
                              "decoder": dec}, torch.arange(4), light).shape == (4, 16)


# ---------------- parameter accounting and the one-field switch -------------

@pytest.mark.parametrize("impl", ["onehot", "hashemb:gather", "tt"])
@pytest.mark.parametrize("kind", ["random_full", "random_light"])
def test_closed_form_param_counts(impl, kind):
    jcfg, tcfg = _cfgs(impl, kind=kind)
    p = temb.init_embedding(torch.Generator().manual_seed(4), tcfg)
    tdcfg, jdcfg = tcfg.decoder_config(), jcfg.decoder_config()
    n_bias = tdcfg.d_m * (tdcfg.n_layers - 1) + tdcfg.d_e
    actual = param_count(p["decoder"], trainable_only=True)
    assert tdcfg.trainable_params() + n_bias == actual == jnn.param_count(
        jemb.init_embedding(jax.random.PRNGKey(4), jcfg)["decoder"], trainable_only=True)
    assert tdcfg.trainable_params() == jdcfg.trainable_params()
    assert tdcfg.frozen_params() == jdcfg.frozen_params() == param_count(p["decoder"]) - actual
    assert tdcfg._decode_stage_params() == jdcfg._decode_stage_params()


def test_one_field_family_switch_gives_jax_leaves():
    for impl in ("onehot", "hashemb:gather", "tt"):
        for kind in ("random_full", "random_light"):
            jcfg, tcfg = _cfgs(impl, kind=kind)
            jp = jemb.init_embedding(jax.random.PRNGKey(7), jcfg)
            tp = temb.init_embedding(torch.Generator().manual_seed(7), tcfg)
            want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
                    for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
            got = {"/".join(path): tuple(leaf.shape) for path, leaf in leaves_with_path(tp)}
            assert got == want, (impl, kind)
            assert temb.embed_lookup(tp, torch.arange(6), tcfg).shape == (6, 16)


# ---------------- precision and the cache compose ----------------

@pytest.mark.parametrize("impl", ["hashemb:gather", "tt"])
def test_families_respect_drift_bounds(impl):
    _, tp, _, tcfg = _jax_init(impl, seed=8)
    ids = torch.arange(64)
    ref = temb.embed_lookup(tp, ids, tcfg)
    scale = float(ref.abs().max())
    for pd, q, bound in (("bfloat16", "none", tbackend.DRIFT_BOUNDS["bfloat16"]),
                         (None, "int8", tbackend.DRIFT_BOUNDS["int8"])):
        out = temb.embed_lookup(tp, ids, dataclasses.replace(tcfg, param_dtype=pd, quantize=q))
        assert float((out - ref).abs().max()) / scale <= bound, (impl, pd, q)


@pytest.mark.parametrize("impl", ["hashemb:gather", "tt"])
def test_family_dtype_contract(impl):
    policy = tbackend.MixedPrecisionPolicy(param_dtype="bfloat16", compute_dtype="bfloat16")
    got = tbackend.get_backend(impl, device=CPU, policy=policy).dtype_contract()
    want = jbackend.get_backend(impl, policy=jbackend.MixedPrecisionPolicy(
        param_dtype="bfloat16", compute_dtype="bfloat16")).dtype_contract()
    assert got == want and "family" in got and got["backend"] == impl.split(":")[0]


@pytest.mark.parametrize("impl", ["hashemb:gather", "tt"])
def test_cached_staleness0_bitwise(impl):
    _, tp, _, tcfg = _jax_init(impl, seed=9)
    ids = torch.arange(32)
    decode = lambda i: temb.embed_lookup(tp, i, tcfg)   # noqa: E731
    cache = tbackend.CachedDecodeBackend(staleness=0)
    state = cache.init_state(64, 16)
    out1, state = cache.lookup(state, ids, decode)
    out2, state = cache.lookup(state, ids, decode)
    ref = decode(ids)
    assert torch.equal(out1, ref) and torch.equal(out2, ref)


# ---------------- the runtime ----------------

def _jspec(impl, **extra):
    return JSpec(graph=JSource(kind="powerlaw", seed=0, n_nodes=300, n_classes=5),
                 model=j_paper_cfg("sage", n_nodes=300, n_classes=5, fanout=5),
                 batch_size=16, total_steps=STEPS, log_every=1, prefetch_depth=0,
                 ).with_updates(c=16, m=4, d_c=16, d_m=16, lookup_impl=impl, **extra)


FAMILY_SPECS = [("hashemb", {}), ("tt", {"tt_rank": 4}), ("pallas", {"quantize": "int8"})]


@pytest.mark.parametrize("impl,extra", FAMILY_SPECS)
def test_spec_round_trip_and_with_updates(impl, extra):
    jspec = _jspec(impl, **extra)
    tspec = RuntimeSpec.from_json(jspec.to_json())
    assert tspec.to_dict() == jspec.to_dict()
    assert RuntimeSpec.from_dict(tspec.to_dict()) == tspec
    base = RuntimeSpec.from_json(_jspec("onehot").to_json())
    assert base.with_updates(lookup_impl=impl, **extra) == tspec
    assert tspec.with_updates(batch_size=8, hidden=64, param_dtype="bfloat16").to_dict() == \
        jspec.with_updates(batch_size=8, hidden=64, param_dtype="bfloat16").to_dict()
    with pytest.raises(TypeError, match="unknown field"):
        tspec.with_updates(nope=1)


def _pair(impl, extra, **opt):
    jspec = _jspec(impl, **extra)
    jspec = dataclasses.replace(jspec, optimizer=dataclasses.replace(jspec.optimizer, **opt))
    jrt = JRuntime.from_spec(jspec)
    init = _np(jrt.state["params"])
    trt = GraphRuntime.from_spec(RuntimeSpec.from_json(jspec.to_json()), device="cpu",
                                 params=params_from_jax(init, device="cpu"))
    return jrt, trt, init


def _assert_params_close(mine, ref_np):
    ref = dict(leaves_with_path(params_from_jax(ref_np, device="cpu")))
    got = dict(leaves_with_path(mine))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        if r.dtype == torch.int64:
            assert torch.equal(got[path], r), "/".join(path)
        else:
            np.testing.assert_allclose(got[path].numpy(), r.numpy(), rtol=0, atol=PARAM_TOL,
                                       err_msg="/".join(path))


def _state_from_jax(jstate):
    def moments(tree):
        return params_from_jax(_np(tree), device="cpu")
    return {"params": moments(jstate["params"]),
            "opt": {"step": int(jstate["opt"]["step"]), "mu": moments(jstate["opt"]["mu"]),
                    "nu": moments(jstate["opt"]["nu"])},
            "step": int(jstate["step"])}


@pytest.mark.parametrize("impl,extra", FAMILY_SPECS)
def test_runtime_training_matches_jax(impl, extra):
    """Five ``train`` steps each from JAX's state (loss within 1e-5, params
    within 1e-4 after it), then five free-running at Adam eps 1 within the
    same; ``evaluate`` within the same loss bound."""
    jrt, trt, init = _pair(impl, extra)
    if impl == "hashemb":
        assert trt.codes is None and jrt.codes is None
        assert "codes_buf" not in trt.params["embed"]
    for k in range(STEPS):
        trt.state = _state_from_jax(jrt.state)
        jloss, tloss = jrt.train(1).losses[0], trt.train(1).losses[0]
        assert abs(tloss - jloss) <= LOSS_TOL, (k, tloss, jloss)
        _assert_params_close(trt.params, _np(jrt.params))
    trt.state = _state_from_jax(jrt.state)
    je, te = jrt.evaluate("val"), trt.evaluate("val")
    assert te["n"] == je["n"] and abs(te["loss"] - je["loss"]) <= LOSS_TOL
    jrt.close()
    trt.close()
    jfree, tfree, _ = _pair(impl, extra, eps=1.0)
    jl, tl = jfree.train(STEPS).losses, tfree.train(STEPS).losses
    assert max(abs(a - b) for a, b in zip(jl, tl)) <= LOSS_TOL, (tl, jl)
    _assert_params_close(tfree.params, _np(jfree.params))
    jfree.close()
    tfree.close()


@pytest.mark.parametrize("impl,extra", FAMILY_SPECS[:2])
def test_resume_continues_bitwise(impl, extra, tmp_path):
    """4 straight steps equal 2 steps, ``GraphRuntime.resume`` and 2 more,
    bit for bit; the checkpoint carries the family's leaves (no codes for
    hashemb) and the resumed spec keeps the family and its rank."""
    spec = RuntimeSpec.from_json(_jspec(impl, **extra).to_json())
    straight = GraphRuntime.from_spec(spec, device="cpu")
    graph = (straight.adj, straight.labels)
    full = straight.train(4).losses
    part = GraphRuntime.from_spec(dataclasses.replace(
        spec, ckpt_dir=str(tmp_path), ckpt_every=2), graph=graph, device="cpu")
    part.train(2)
    part.close()
    resumed = GraphRuntime.resume(str(tmp_path), graph=graph, device="cpu")
    assert resumed.spec.model.embedding == spec.model.embedding
    assert ("codes_buf" in resumed.params["embed"]) == (impl != "hashemb")
    tail = resumed.train(4)
    assert tail.resumed_from == 2 and tail.losses == full[2:]
    for (pa, a), (pb, b) in zip(leaves_with_path(straight.params),
                                leaves_with_path(resumed.params)):
        assert pa == pb and torch.equal(a, b), "/".join(pa)
    assert all(math.isfinite(x) for x in full)
    straight.close()
    resumed.close()


def test_serving_rejects_a_family_switch():
    trt = GraphRuntime.from_spec(RuntimeSpec.from_json(_jspec("hashemb:gather").to_json()),
                                 device="cpu")
    trt.train(1)
    with pytest.raises(ValueError, match="family"):
        trt.serve(serve_batch=16, decode_backend="tt")
    eng = trt.serve(serve_batch=16, decode_backend="hashemb:onehot")
    out = eng.serve(np.arange(8))
    assert np.isfinite(out.embeddings).all()
    # cached and uncached serving give the same bits
    plain = trt.serve(serve_batch=16, cache_capacity=0).serve(np.arange(8))
    np.testing.assert_array_equal(trt.serve(serve_batch=16).serve(np.arange(8)).embeddings,
                                  plain.embeddings)
    trt.close()


def test_lm_reduced_config_takes_a_hashemb_step():
    """The reduced LM with ``lookup_impl="hashemb"``: no codes built, and
    one training step from JAX's init within 1e-5 of JAX's loss."""
    jcfg = j_reduced(j_get_config("qwen1.5-0.5b"))
    jcfg = dataclasses.replace(jcfg, embedding=dataclasses.replace(jcfg.embedding,
                                                                   lookup_impl="hashemb"))
    tcfg = reduced(get_config("qwen1.5-0.5b", attn_impl="flash"))
    tcfg = dataclasses.replace(tcfg, embedding=dataclasses.replace(tcfg.embedding,
                                                                   lookup_impl="hashemb"))
    from repro_torch.models.lm import init_lm
    assert "codes_buf" not in init_lm(torch.Generator().manual_seed(0), tcfg)["embed"]
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    assert "codes_buf" not in jstate["params"]["embed"]
    params = params_from_jax(jstate["params"], device="cpu")
    tstate = {"params": params, "opt": t_adamw.adamw_init(params), "step": 0}
    batch = TokenStream(TokenStreamConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                          batch_size=4, seed=1)).next_batch()
    _, jm = jax.jit(j_make_train_step(jcfg, JTrainHyper(warmup_steps=1, total_steps=3)))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = make_train_step(tcfg, TrainHyper(warmup_steps=1, total_steps=3))(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= LOSS_TOL
    assert tstate["step"] == 1
