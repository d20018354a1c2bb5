"""Port parity: decode backends, decoder, embedding layer and the SAGE
model against the JAX package, on params the JAX package initialised.

Tolerances: the gather backend and the kernel's plain version repeat the
JAX gather's f32 adds in order, so they match bitwise.  Everything with a
matmul (one-hot backend, decoder MLP, SAGE layers) sums in torch's CPU
order rather than XLA's, so it is held to rtol = atol = 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_gnn import paper_gnn_config as j_paper_cfg
from repro.core import backend as jbackend
from repro.core import decoder as jdecoder
from repro.core import embedding as jemb
from repro.graph.generate import powerlaw_graph as j_powerlaw
from repro.graph.sampler import NeighborSampler as JSampler
from repro.models import gnn as jgnn
from repro_torch.configs.paper_gnn import paper_gnn_config as t_paper_cfg
from repro_torch.core import backend as tbackend
from repro_torch.core import decoder as tdecoder
from repro_torch.core import embedding as temb
from repro_torch.graph.engine import GNNModel
from repro_torch.graph.generate import powerlaw_graph as t_powerlaw
from repro_torch.interop import params_from_jax
from repro_torch.models import gnn as tgnn

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _small(cfg, **emb):
    return dataclasses.replace(
        cfg, d_e=16, hidden=32, fanouts=(3, 3),
        embedding=dataclasses.replace(cfg.embedding, c=16, m=4, d_c=32, d_m=32, **emb))


@pytest.mark.parametrize("name", ["gather", "onehot", "pallas"])
@pytest.mark.parametrize("with_w0", [False, True])
def test_backends_match_jax_gather(name, with_w0):
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 16, (70, 6)).astype(np.int32)
    cb = rng.standard_normal((6, 16, 40)).astype(np.float32)
    w0 = rng.standard_normal(40).astype(np.float32) if with_w0 else None
    ref = np.asarray(jbackend.GatherBackend().decode(
        jnp.asarray(codes), jnp.asarray(cb), None if w0 is None else jnp.asarray(w0)))
    be = tbackend.get_backend(name, device=torch.device("cpu"))
    got = be.decode(torch.from_numpy(codes), torch.from_numpy(cb),
                    None if w0 is None else torch.from_numpy(w0)).numpy()
    if name == "onehot":
        np.testing.assert_allclose(got, ref, **TOL)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("param_dtype,quantize", [("bfloat16", "none"), (None, "int8")])
def test_precision_policies_match_jax_gather(param_dtype, quantize):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 8, (50, 5)).astype(np.int32)
    cb = rng.standard_normal((5, 8, 24)).astype(np.float32)
    jp = jbackend.MixedPrecisionPolicy(param_dtype=param_dtype, quantize=quantize)
    tp = tbackend.MixedPrecisionPolicy(param_dtype=param_dtype, quantize=quantize)
    ref = np.asarray(jbackend.GatherBackend(policy=jp).decode(jnp.asarray(codes), jnp.asarray(cb)))
    for name in ("gather", "pallas"):
        be = tbackend.get_backend(name, device=torch.device("cpu"), policy=tp)
        np.testing.assert_array_equal(
            be.decode(torch.from_numpy(codes), torch.from_numpy(cb)).numpy(), ref)
    assert tp.quantize == jp.quantize and tbackend.DRIFT_BOUNDS == jbackend.DRIFT_BOUNDS


def test_backend_registry():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tbackend.resolve_auto(cpu) == "onehot" == jbackend.resolve_auto()
    assert tbackend.resolve_auto(cuda) == "pallas"
    assert isinstance(tbackend.get_backend("auto", device=cpu), tbackend.OnehotBackend)
    assert tbackend.available_backends() == ("gather", "hashemb", "onehot", "owner",
                                             "pallas", "sharded", "tt")
    # the collective backends are ported (tests/test_torch_sharded.py):
    # no decode backend raises NotImplementedError, a collective wrapping a
    # collective raises as in the JAX package
    assert tbackend.NOT_PORTED == {}
    assert tbackend.get_backend("sharded", device=cpu).base.name == "onehot"
    assert tbackend.get_backend("owner:gather", device=cpu).base.name == "gather"
    for name in ("sharded:owner", "owner:owner"):
        with pytest.raises(ValueError, match="wrap itself"):
            tbackend.get_backend(name, device=cpu)
    with pytest.raises(ValueError):
        tbackend.get_backend("nope", device=cpu)
    with pytest.raises(ValueError):
        tbackend.get_backend("gather:onehot", device=cpu)
    for impl in ("auto", "pallas", "hashemb:gather", "owner:tt", "tt"):
        assert tbackend.family_of(impl) == jbackend.family_of(impl)
    with pytest.raises(ValueError):
        tbackend.MixedPrecisionPolicy(quantize="int4")


@pytest.mark.parametrize("variant", ["full", "light"])
@pytest.mark.parametrize("impl", ["gather", "pallas", "onehot"])
def test_apply_decoder_matches_jax(variant, impl):
    jcfg = jdecoder.DecoderConfig(c=16, m=4, d_c=32, d_m=24, d_e=8, n_layers=3,
                                  variant=variant, lookup_impl="gather",
                                  compute_dtype="float32")
    params = _np_tree(jdecoder.init_decoder(jax.random.PRNGKey(0), jcfg))
    if variant == "light":
        params["w0"] = np.random.default_rng(0).standard_normal(32).astype(np.float32)
    codes = np.random.default_rng(1).integers(0, 16, (9, 7, 4)).astype(np.int32)
    ref = np.asarray(jdecoder.apply_decoder(jax.tree.map(jnp.asarray, params),
                                            jnp.asarray(codes), jcfg))
    tcfg = tdecoder.DecoderConfig(**{**dataclasses.asdict(jcfg), "lookup_impl": impl})
    got = tdecoder.apply_decoder(params_from_jax(params, device="cpu"),
                                 torch.from_numpy(codes), tcfg).numpy()
    assert got.shape == (9, 7, 8)
    np.testing.assert_allclose(got, ref, **TOL)


def test_init_trees_match_jax_layout():
    """Same keys, shapes and dtypes as the JAX init, so params carry over."""
    jcfg = _small(j_paper_cfg("sage", n_nodes=120, n_classes=5))
    tcfg = _small(t_paper_cfg("sage", n_nodes=120, n_classes=5))
    adj, _ = j_powerlaw(0, 120, avg_degree=6, n_classes=5)
    jp = _np_tree(jgnn.init_gnn(jax.random.PRNGKey(0), jcfg, aux=adj))
    codes = torch.zeros((120, 1), dtype=torch.int64)
    tp = tgnn.init_gnn(torch.Generator().manual_seed(0), tcfg, codes=codes)
    jflat = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    tflat = {}

    def walk(prefix, tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}['{k}']", v)
            else:
                tflat[f"{prefix}['{k}']"] = v
    walk("", tp)
    assert sorted(jflat) == sorted(tflat)
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == v.shape, k
    for k in ("['w1']", "['embed']['decoder']['codebooks']", "['embed']['decoder']['mlp']['w0']"):
        assert tflat[k].dtype == torch.float32
    # the full-graph trees are held to JAX's in tests/test_torch_fullgraph.py;
    # a model neither package knows raises as JAX's init does
    with pytest.raises(ValueError, match="gat"):
        tgnn.init_gnn(torch.Generator(), dataclasses.replace(tcfg, model="gat"))


@pytest.fixture(scope="module")
def sage():
    n = 300
    jcfg = _small(j_paper_cfg("sage", n_nodes=n, n_classes=5), lookup_impl="gather")
    tcfg = _small(t_paper_cfg("sage", n_nodes=n, n_classes=5), lookup_impl="gather")
    adj, labels = j_powerlaw(1, n, avg_degree=6, n_classes=5)
    jp = jgnn.init_gnn(jax.random.PRNGKey(3), jcfg, aux=adj)
    levels = JSampler(adj, (3, 3)).sample(np.arange(0, n, 7, dtype=np.int32)[:24],
                                          rng=np.random.default_rng(0))
    return jcfg, tcfg, jp, params_from_jax(_np_tree(jp), device="cpu"), levels, labels


def test_embed_lookup_and_decode_all_match_jax(sage):
    jcfg, tcfg, jp, tp, levels, _ = sage
    je, te = jcfg.embedding_config(), tcfg.embedding_config()
    ids = levels[2]
    np.testing.assert_allclose(
        temb.embed_lookup(tp["embed"], torch.from_numpy(ids), te).numpy(),
        np.asarray(jemb.embed_lookup(jp["embed"], jnp.asarray(ids), je)), **TOL)
    np.testing.assert_allclose(temb.decode_all(tp["embed"], te, block=128).numpy(),
                               np.asarray(jemb.decode_all(jp["embed"], je, block=128)), **TOL)
    np.testing.assert_array_equal(
        temb.lookup_codes(tp["embed"], torch.from_numpy(ids), te).numpy(),
        np.asarray(jemb.codes_lib.unpack_codes(
            jnp.take(jp["embed"]["codes_buf"], jnp.asarray(ids), axis=0), 16, 4)))


def test_sage_forward_loss_accuracy_match_jax(sage):
    jcfg, tcfg, jp, tp, levels, labels = sage
    jh = jgnn.sage_forward(jp, [jnp.asarray(l) for l in levels], jcfg)
    th = GNNModel(tcfg, device="cpu").apply(tp, levels)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    jl = jgnn.node_logits(jp, jh, jcfg)
    tl = tgnn.node_logits(tp, th, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    y = labels[levels[0]]
    np.testing.assert_allclose(float(tgnn.node_loss(tl, torch.from_numpy(y))),
                               float(jgnn.node_loss(jl, jnp.asarray(y))), **TOL)
    assert tgnn.accuracy(tl, torch.from_numpy(y)) == jgnn.accuracy(jl, y)


def test_embedding_kinds_and_not_ported_placement():
    g = torch.Generator().manual_seed(0)
    tadj, _ = t_powerlaw(0, 50, avg_degree=4, n_classes=3)
    cfg = temb.EmbeddingConfig(kind="hash_light", n_entities=50, d_e=8, c=4, m=6,
                               d_c=16, d_m=16, compute_dtype="float32")
    p = temb.init_embedding(g, cfg, aux=tadj)
    assert set(p["decoder"]) == {"codebooks_buf", "w0", "mlp"}
    assert tuple(temb.embed_lookup(p, torch.arange(10), cfg).shape) == (10, 8)
    rnd = dataclasses.replace(cfg, kind="random_full")
    assert tuple(temb.init_embedding(g, rnd)["codes_buf"].shape) == (50, 1)
    dense = dataclasses.replace(cfg, kind="dense")
    assert tuple(temb.embed_lookup(temb.init_embedding(g, dense), torch.arange(4), dense).shape) == (4, 8)
    with pytest.raises(ValueError, match="aux"):
        temb.make_codes(g, cfg)
    # host placement (ported): the params carry the decoder alone; an
    # unknown placement is refused at init
    host = dataclasses.replace(cfg, codes_placement="host")
    assert host.codes_on_host and set(temb.init_embedding(g, host, aux=tadj)) == {"decoder"}
    with pytest.raises(ValueError, match="codes_placement"):
        temb.init_embedding(g, dataclasses.replace(cfg, codes_placement="hbm"), aux=tadj)
    hashemb = dataclasses.replace(cfg, lookup_impl="hashemb")      # ported: no codes
    assert set(temb.init_embedding(g, hashemb, aux=tadj)) == {"decoder"}


def test_gather_gradient_is_the_same_bits_on_threads():
    """ROADMAP §C (PR 21): the ``gather`` backend's codebook gradient added a
    codebook row's repeats (about 1,250 each here) in a varying order on
    several CPU threads (an indexed read's backward, an accumulating
    ``index_put_``).  Under 8 threads three gradients of one loss are now
    the same bits, and JAX's ``gather`` gradient's."""
    rng = np.random.default_rng(3)
    B, m, c, d_c = 20_000, 8, 16, 64
    codes = rng.integers(0, c, (B, m)).astype(np.int32)
    cb = rng.standard_normal((m, c, d_c)).astype(np.float32)
    w0 = rng.standard_normal(d_c).astype(np.float32)
    r = rng.standard_normal((B, d_c)).astype(np.float32)
    be = tbackend.get_backend("gather", device=torch.device("cpu"))
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        grads = []
        for _ in range(3):
            tcb, tw0 = (torch.from_numpy(a).requires_grad_() for a in (cb, w0))
            loss = (be.decode(torch.from_numpy(codes), tcb, tw0) * torch.from_numpy(r)).sum()
            grads.append([g.numpy() for g in torch.autograd.grad(loss, (tcb, tw0))])
    finally:
        torch.set_num_threads(threads)
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            np.testing.assert_array_equal(a, b)
    jgrad = jax.grad(lambda c_, s_: (jbackend.GatherBackend().decode(jnp.asarray(codes), c_, s_)
                                     * jnp.asarray(r)).sum(), argnums=(0, 1))
    jcb, jw0 = jgrad(jnp.asarray(cb), jnp.asarray(w0))
    np.testing.assert_array_equal(grads[0][0], np.asarray(jcb))
    np.testing.assert_allclose(grads[0][1], np.asarray(jw0), rtol=1e-5, atol=1e-5)
