"""Port parity for the LM side of slice 2: configs, ``nn`` layers, RoPE,
attention, ``models.lm`` and the ``hash_decode`` backward, against the JAX
package on the CPU.

The model is ``reduced(get_config("qwen1.5-0.5b"))`` (2 layers, d_model
128, 4 heads of 32, vocab 512, c=16, m=8, f32).  Params are the JAX
package's ``init_lm`` draw carried across with ``params_from_jax``; inputs
come from numpy seeds; TF32 is off.  The port runs attention through the
flash wrapper and the decode through the kernel backend (``"pallas"``),
whose plain versions run here; the JAX reference runs ``attn_impl="xla"``
(its flash path needs ``interpret``, which ``attention`` does not pass) and
the one-hot decode.  Bounds: elementwise layers 1e-6; attention, logits and
loss 2e-5 (f32 matmuls in another order, softmax over 64-128 keys);
decode gradients 1e-5 in f32 (one-hot contraction in both, the w0 sum
re-decoded by the gather) and 1e-2 relative in bf16 (one bf16 rounding of
nearly equal f32 sums).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import backend as j_backend
from repro.models import lm as j_lm
from repro.nn import attention as j_attn
from repro.nn import layers as j_layers
from repro.nn import module as j_module
from repro.nn import rope as j_rope
from repro_torch.configs import base as t_base
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.core import backend as t_backend
from repro_torch.device import disable_tf32
from repro_torch.interop import params_from_jax
from repro_torch.kernels.hash_decode import ops as hd_ops
from repro_torch.models import lm as t_lm
from repro_torch.nn import attention as t_attn
from repro_torch.nn import layers as t_layers
from repro_torch.nn import module as t_module
from repro_torch.nn import rope as t_rope

disable_tf32()

ARCH = "qwen1.5-0.5b"


def _configs(**port):
    jcfg = j_reduced(j_get_config(ARCH))
    tcfg = reduced(get_config(ARCH, attn_impl="flash"))
    tcfg = dataclasses.replace(tcfg, embedding=dataclasses.replace(
        tcfg.embedding, lookup_impl="pallas"), **port)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    jparams = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jparams, device="cpu")


def _tree_shapes(tree):
    return {k: _tree_shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


# ---- configs ----------------------------------------------------------------

def test_lm_config_fields_and_properties_match_jax():
    from repro.configs.base import LMConfig as JLMConfig
    jf = [(f.name, f.default) for f in dataclasses.fields(JLMConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(t_base.LMConfig)]
    assert jf == tf
    for cfg_j, cfg_t in [(j_get_config(ARCH), get_config(ARCH)),
                         (j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH)))]:
        assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
        assert cfg_t.head_dim == cfg_j.head_dim
        assert cfg_t.vocab_padded == cfg_j.vocab_padded
        assert cfg_t.param_count() == cfg_j.param_count()
        assert dataclasses.asdict(cfg_t.embedding_config()) == \
            dataclasses.asdict(cfg_j.embedding_config())
    assert get_config(ARCH).vocab_padded == 152_064


def test_get_config_overrides_and_unported_archs():
    cfg = get_config(ARCH, attn_impl="flash", embedding=dataclasses.replace(
        get_config(ARCH).embedding, lookup_impl="auto"))
    assert cfg.attn_impl == "flash" and cfg.embedding.lookup_impl == "auto"
    assert list_archs() == ["chatglm3-6b", "dbrx-132b", "granite-moe-3b-a800m",
                            "internlm2-20b", "mamba2-2.7b", "musicgen-large", ARCH,
                            "qwen2-vl-7b", "yi-9b", "zamba2-7b"]
    for arch in ("chatglm3-6b", "yi-9b", "internlm2-20b"):   # their fields: test_torch_lm_serving
        assert get_config(arch).family == "dense" and get_config(arch).name == arch
    from repro_torch.configs.archs import NOT_PORTED
    assert NOT_PORTED == {}           # audio and vlm fields: test_torch_lm_audio_vlm
    music = get_config("musicgen-large", attn_impl="flash")
    assert (music.family, music.input_mode, music.n_codebooks, music.attn_impl) == \
        ("audio", "audio_tokens", 4, "flash")
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid"])
def test_unported_families_raise(family):
    """The name is older than the families' port and kept, so the test keeps
    its identity across the change: each family's reduced arch initialises
    and runs its forward, and so do the audio and vlm families (the last
    two ported); an unknown family raises ``ValueError``, as in JAX."""
    arch = {"moe": "granite-moe-3b-a800m", "ssm": "mamba2-2.7b", "hybrid": "zamba2-7b"}[family]
    cfg = reduced(get_config(arch))
    params = t_lm.init_lm(torch.Generator().manual_seed(0), cfg)
    logits, _ = t_lm.lm_forward(params, torch.zeros((1, 16), dtype=torch.int64), cfg)
    assert logits.shape == (1, 16, cfg.vocab_padded) and bool(logits.isfinite().all())
    for arch, tail in (("musicgen-large", (4,)), ("qwen2-vl-7b", ())):
        other = reduced(get_config(arch))
        params = t_lm.init_lm(torch.Generator().manual_seed(0), other)
        logits, _ = t_lm.lm_forward(params, torch.zeros((1, 16) + tail, dtype=torch.int64), other)
        assert logits.shape == (1, 16) + tail + (other.vocab_padded,)
        assert bool(logits.isfinite().all())
    with pytest.raises(ValueError):
        t_lm.init_lm(torch.Generator().manual_seed(0), dataclasses.replace(cfg, family="no-such"))


# ---- nn.module ----------------------------------------------------------------

def test_init_lm_tree_mask_and_count_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    mine = t_lm.init_lm(torch.Generator().manual_seed(0), tcfg)
    assert _tree_shapes(mine) == _tree_shapes(tparams)
    assert mine["blocks"]["attn"]["wq"]["w"].shape[0] == tcfg.n_layers
    jmask = j_module.trainable_mask(jparams)
    tmask = t_module.trainable_mask(tparams)
    assert jmask == tmask
    assert tmask["embed"]["codes_buf"] is False
    for trainable in (False, True):
        assert t_module.param_count(tparams, trainable) == \
            j_module.param_count(jparams, trainable)


# ---- layers ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_linear_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), t_backend.torch_dtype(dtype)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jy = j_layers.rmsnorm({"scale": jnp.asarray(scale)}, jx)
    ty = t_layers.rmsnorm({"scale": torch.from_numpy(scale)}, tx)
    assert ty.dtype == tdt
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               rtol=tol, atol=tol)
    jl = j_layers.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jx, jdt)
    tl = t_layers.linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, tx, tdt)
    assert tl.dtype == tdt
    tol = 2e-5 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_and_layernorm_match_jax(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    jp = j_layers.init_mlp(jax.random.PRNGKey(1), 32, 64, act)
    tp = params_from_jax(jp, device="cpu")
    np.testing.assert_allclose(t_layers.mlp(tp, torch.from_numpy(x), act).numpy(),
                               np.asarray(j_layers.mlp(jp, jnp.asarray(x), act)),
                               rtol=2e-5, atol=2e-5)
    ln = {"scale": rng.standard_normal(32).astype(np.float32),
          "bias": rng.standard_normal(32).astype(np.float32)}
    np.testing.assert_allclose(
        t_layers.layernorm(params_from_jax(ln, device="cpu"), torch.from_numpy(x)).numpy(),
        np.asarray(j_layers.layernorm(ln, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope_matches_jax(fraction):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32) + 5, (2, 9))
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), 32, fraction=fraction)
    tc, ts = t_rope.rope_cos_sin(torch.from_numpy(np.array(pos)), 32, fraction=fraction)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        t_rope.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(j_rope.apply_rope(jnp.asarray(x), jc, js)), rtol=1e-6, atol=1e-6)
    assert torch.equal(t_rope.default_positions(2, 9, "standard"),
                       torch.from_numpy(np.array(j_rope.default_positions(2, 9, "standard"))))
    # M-RoPE over 3 streams (the head's first 2 * 16 * fraction dims rotated)
    sections = (4, 6, 6) if fraction == 1.0 else (2, 3, 3)
    pos3 = np.stack([pos, pos + 7, 2 * pos]).astype(np.int32)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos3), 32, fraction=fraction,
                                 mrope_sections=sections)
    tc, ts = t_rope.rope_cos_sin(torch.from_numpy(pos3), 32, fraction=fraction,
                                 mrope_sections=sections)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    assert torch.equal(t_rope.default_positions(2, 9, "mrope"),
                       torch.from_numpy(np.array(j_rope.default_positions(2, 9, "mrope"))))


# ---- attention --------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
def test_attention_matches_jax(impl, H, K):
    jcfg = j_attn.AttentionConfig(d_model=64, n_heads=H, n_kv_heads=K, d_head=32,
                                  qkv_bias=True)
    tcfg = t_attn.AttentionConfig(d_model=64, n_heads=H, n_kv_heads=K, d_head=32,
                                  qkv_bias=True, impl=impl)
    jp = j_attn.init_attention(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), 32)
    tc, ts = t_rope.rope_cos_sin(torch.from_numpy(np.array(pos)), 32)
    jy, _ = j_attn.attention(jp, jnp.asarray(x), jcfg, cos=jc, sin=js)
    ty, _ = t_attn.attention(tp, torch.from_numpy(x), tcfg, cos=tc, sin=ts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)


def test_chunked_xla_attention_equals_unchunked():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 4, 32)).astype(np.float32))
               for _ in range(3))
    full = t_attn._attend_xla(q, k, v, causal=True)
    chunked = t_attn._attend_xla_chunked(q, k, v, causal=True, chunk=16)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)


def test_attention_with_cache_raises():
    """The name is older than the cache branch and kept, so the test keeps
    its identity across the change: attention with a cache no longer
    raises; a prefill of 5 tokens into the cache and one decode step
    against it equal JAX's within 2e-5."""
    from repro.nn import kvcache as j_kv
    from repro_torch.nn import kvcache as t_kv
    jcfg = j_attn.AttentionConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=32,
                                  qkv_bias=True)
    tcfg = t_attn.AttentionConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=32,
                                  qkv_bias=True)
    jp = j_attn.init_attention(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jp, device="cpu")
    x = np.random.default_rng(4).standard_normal((2, 6, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), 32)
    tc, ts = t_rope.rope_cos_sin(torch.from_numpy(np.array(pos)), 32)
    jcache = j_kv.KVCache.zeros(2, 12, 2, 32, jnp.float32)
    tcache = t_kv.KVCache.zeros(2, 12, 2, 32, torch.float32, device="cpu")
    for sl in (slice(0, 5), slice(5, 6)):
        jy, jcache = j_attn.attention(jp, jnp.asarray(x[:, sl]), jcfg, cos=jc[:, sl],
                                      sin=js[:, sl], cache=jcache)
        ty, tcache = t_attn.attention(tp, torch.from_numpy(x[:, sl]), tcfg, cos=tc[:, sl],
                                      sin=ts[:, sl], cache=tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5, atol=2e-5)
        assert tcache.pos == int(jcache.pos)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), rtol=2e-5, atol=2e-5)


# ---- the model --------------------------------------------------------------------

def _batch(cfg, B=2, S=48, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("remat", [False, True])
def test_lm_forward_and_loss_match_jax(model, remat):
    jcfg, tcfg, jparams, tparams = model
    tcfg = dataclasses.replace(tcfg, remat=remat)
    b = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jlogits, _ = jax.jit(lambda p, t: j_lm.lm_forward(p, t, jcfg))(jparams, jb["tokens"])
    tlogits, _ = t_lm.lm_forward(tparams, tb["tokens"], tcfg)
    assert tlogits.dtype == torch.float32 and tuple(tlogits.shape) == (2, 48, 512)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=2e-5, atol=2e-5)
    jloss = float(jax.jit(lambda p, bb: j_lm.lm_loss(p, bb, jcfg))(jparams, jb))
    tloss = float(t_lm.lm_loss(tparams, tb, tcfg))
    assert abs(tloss - jloss) <= 2e-5, (tloss, jloss)


def test_lm_loss_masks_vocab_padding(model):
    _, tcfg, _, tparams = model
    tcfg = dataclasses.replace(tcfg, vocab_size=500)      # padded to 512
    b = {k: torch.from_numpy(v % 500) for k, v in _batch(tcfg).items()}
    logits, _ = t_lm.lm_forward(tparams, b["tokens"], tcfg)
    lp = torch.log_softmax(logits[..., :500], dim=-1)
    expect = -lp.gather(-1, b["labels"].long()[..., None]).mean()
    assert abs(float(t_lm.lm_loss(tparams, b, tcfg)) - float(expect)) <= 1e-5
    # the chunked loss (8 chunks of 64, the pad columns in the last) no
    # longer raises: it equals the plain one
    chunked = t_lm.lm_loss(tparams, b, dataclasses.replace(tcfg, loss_vocab_chunk=64))
    assert abs(float(chunked) - float(expect)) <= 1e-5


# ---- hash_decode backward ------------------------------------------------------

@pytest.mark.parametrize("variant", ["float32", "float32+w0", "bfloat16+w0"])
def test_hash_decode_grads_match_jax_pallas_interpret(variant):
    dtype, _, with_w0 = variant.partition("+")
    B, m, c, d_c = 64, 8, 16, 128
    rng = np.random.default_rng(6)
    codes = rng.integers(0, c, (B, m)).astype(np.int32)
    cb = rng.standard_normal((m, c, d_c)).astype(np.float32)
    w0 = rng.standard_normal(d_c).astype(np.float32)
    G = rng.standard_normal((B, d_c)).astype(np.float32)
    pdt = "bfloat16" if dtype == "bfloat16" else None
    jbe = j_backend.PallasBackend(interpret=True,
                                  policy=j_backend.MixedPrecisionPolicy(param_dtype=pdt))

    def jloss(cb_, w0_):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = jbe.decode(jnp.asarray(codes), cb_, w0_ if with_w0 else None)
        return (out * jnp.asarray(G)).sum()

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(cb), jnp.asarray(w0))
    tbe = t_backend.get_backend("pallas", device=torch.device("cpu"),
                                policy=t_backend.MixedPrecisionPolicy(param_dtype=pdt))
    assert tbe.capabilities.grad
    tcb = torch.from_numpy(cb).requires_grad_(True)
    tw0 = torch.from_numpy(w0).requires_grad_(True)
    out = tbe.decode(torch.from_numpy(codes), tcb, tw0 if with_w0 else None)
    (out * torch.from_numpy(G)).sum().backward()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(jg[0]), rtol=tol, atol=tol)
    if with_w0:
        np.testing.assert_allclose(tw0.grad.numpy(), np.asarray(jg[1]),
                                   rtol=tol, atol=tol * np.abs(np.asarray(jg[1])).max())
    else:
        assert tw0.grad is None


def test_hash_decode_backward_is_deterministic_and_int8_grad_raises():
    rng = np.random.default_rng(7)
    codes = torch.from_numpy(rng.integers(0, 16, (300, 8)).astype(np.int32))
    cb = torch.from_numpy(rng.standard_normal((8, 16, 96)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((300, 96)).astype(np.float32))
    a = hd_ops.hash_decode_backward(codes, cb, w0, g)
    b = hd_ops.hash_decode_backward(codes, cb, w0, g)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    be = t_backend.get_backend(
        "pallas", device=torch.device("cpu"),
        policy=t_backend.MixedPrecisionPolicy(quantize="int8"))
    # The name is older than the int8 backward and kept, so the test keeps
    # its identity across the change: the int8 backward no longer raises,
    # its codebook gradient goes straight through to the masters, the
    # unquantized gradient's bits
    masters = cb.clone().requires_grad_(True)
    (be.decode(codes, masters) * g).sum().backward()
    assert torch.equal(masters.grad, hd_ops.hash_decode_backward(codes, cb, None, g)[0])
    with torch.no_grad():
        assert be.decode(codes, cb.clone().requires_grad_(True)).shape == (300, 96)


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            bad += [f"{f.relative_to(root)}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert len(files) > 30 and not bad, bad


def test_sinusoidal_positions_match_jax():
    pos = np.broadcast_to(np.arange(11, dtype=np.int32), (2, 11))
    np.testing.assert_allclose(
        t_lm._sinusoidal_pe(torch.from_numpy(np.array(pos)), 64, torch.float32).numpy(),
        np.asarray(j_lm._sinusoidal_pe(jnp.asarray(pos), 64, jnp.float32)),
        rtol=1e-5, atol=1e-5)
