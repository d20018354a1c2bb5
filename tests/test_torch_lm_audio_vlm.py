"""Port parity for the audio and vlm LM families against the JAX package on
the CPU: the musicgen-large and qwen2-vl-7b configs, M-RoPE, ``init_lm``'s
trees and tiled codes, ``lm_forward`` and ``lm_loss``, the prefill and
decode steps, ``DecodeEngine`` and the interop of params and caches (the
training step: ``test_torch_lm_audio_vlm_train.py``).

The models are ``reduced(get_config(arch))`` (2 layers, d_model 128, 4
heads of 32, vocab 512, c=16, m=8, f32; musicgen 4 codebooks, MHA,
sinusoidal positions, LayerNorm and GELU; qwen2-vl GQA 4 on 1, QKV bias,
M-RoPE sections (4, 6, 6)); musicgen both at its dense default and under
``hash_full``.  Params are JAX's ``init_lm`` draw carried across with
``params_from_jax``; inputs come from numpy seeds; TF32 is off.  The port
decodes through the kernel backend (``"pallas"``, its plain version here),
JAX one-hot.  M-RoPE batches carry three distinct position streams laid
out as Qwen2-VL lays out an image (``_vl_positions``).

Bounds: logits 5e-5; loss 1e-5; the engine's
greedy tokens equal JAX's up to the first step where JAX's top-2 margin is
under twice the logits bound; cos and sin 1e-6.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import lm as j_lm
from repro.nn import module as j_module
from repro.nn import rope as j_rope
from repro.serving import engine as j_engine
from repro_torch.configs import get_config, reduced
from repro_torch.device import disable_tf32
from repro_torch.interop import lm_cache_from_jax, params_from_jax
from repro_torch.models import lm as t_lm
from repro_torch.nn import module as t_module
from repro_torch.nn import rope as t_rope
from repro_torch.serving import DecodeEngine
from repro_torch.train import make_prefill_step, make_serve_step

disable_tf32()

AUDIO, VLM = "musicgen-large", "qwen2-vl-7b"
CASES = {"audio": (AUDIO, "dense"), "vlm": (VLM, "hash_full")}
B, S0, STEPS, S_MAX = 2, 8, 6, 16
TOL = 5e-5


def _kind(cfg, kind):
    return dataclasses.replace(cfg, embedding=dataclasses.replace(cfg.embedding, kind=kind))


def _port_cfg(arch, kind, **fields):
    cfg = _kind(reduced(get_config(arch)), kind)
    return dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, lookup_impl="pallas"), **fields)


def _close(got: torch.Tensor, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def _walk(tree, jtree, fn, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            _walk(v, jtree[k], fn, path + (k,))
        elif v is not None:
            fn("/".join(path + (k,)), v, jtree[k])


def _tree_shapes(tree):
    return {k: _tree_shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def _vl_positions(batch: int, seq: int, grid: int = 4) -> np.ndarray:
    """(3, B, S) M-RoPE positions of a text / image / text sequence, as
    Qwen2-VL lays them out: text positions equal in all three streams; a
    ``grid`` x ``grid`` image span starting at text position ``st`` holds
    temporal ``st`` and height and width ``st`` + its row and column; the
    text after it goes on from the largest position + 1.  Row b's image
    starts at 3 + 2b."""
    pos = np.empty((3, batch, seq), np.int32)
    for b in range(batch):
        st = 3 + 2 * b
        pos[:, b, :st] = np.arange(st)
        rows, cols = np.divmod(np.arange(grid * grid), grid)
        pos[0, b, st:st + grid * grid] = st
        pos[1, b, st:st + grid * grid] = st + rows
        pos[2, b, st:st + grid * grid] = st + cols
        rest = seq - st - grid * grid
        pos[:, b, st + grid * grid:] = st + grid + np.arange(rest)
    return pos


def _batch(cfg, S=32, seed=5, positions=True):
    rng = np.random.default_rng(seed)
    shape = (B, S + 1) + ((cfg.n_codebooks,) if cfg.input_mode == "audio_tokens" else ())
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.input_mode == "tokens_mrope" and positions:
        b["positions"] = _vl_positions(B, S)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.fixture(scope="module", params=list(CASES))
def fam(request):
    """One case's reduced arch: JAX's init, and JAX's engine run (its greedy
    tokens, and the last logits and cache after its prefill and after each
    decode step along them)."""
    arch, kind = CASES[request.param]
    jcfg = _kind(j_reduced(j_get_config(arch)), kind)
    jparams = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    jeng = j_engine.DecodeEngine(jcfg, jparams, s_max=S_MAX)
    shape = (B, S0) + ((jcfg.n_codebooks,) if jcfg.input_mode == "audio_tokens" else ())
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, shape).astype(np.int32)
    tokens = np.array(jeng.generate(prompts, STEPS).tokens)
    logits, cache = jeng._prefill(jparams, {"tokens": jnp.asarray(prompts)})
    steps = [(np.asarray(logits), cache)]
    for t in range(STEPS):
        logits, cache = jeng._serve(jparams, cache,
                                    {"tokens": jnp.asarray(tokens[:, S0 + t:S0 + t + 1])})
        steps.append((np.asarray(logits), cache))
    return types.SimpleNamespace(case=request.param, arch=arch, jcfg=jcfg, jparams=jparams,
                                 tcfg=_port_cfg(arch, kind), prompts=prompts, tokens=tokens,
                                 steps=steps, tparams=params_from_jax(jparams, device="cpu"))


# ---- configs and M-RoPE ---------------------------------------------------------------

@pytest.mark.parametrize("arch", [AUDIO, VLM])
def test_configs_and_counts_match_jax(arch):
    for cfg_j, cfg_t in [(j_get_config(arch), get_config(arch)),
                         (j_reduced(j_get_config(arch)), reduced(get_config(arch)))]:
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.active_param_count() == cfg_j.active_param_count()
        assert cfg_t.vocab_padded == cfg_j.vocab_padded
    assert get_config(AUDIO).param_count() == 2_436_890_624
    assert get_config(VLM).mrope_sections == (16, 24, 24)


@pytest.mark.parametrize("sections,fraction", [((4, 6, 6), 1.0), ((16, 24, 24), 1.0),
                                               ((2, 3, 3), 0.5)])
def test_mrope_cos_sin_match_jax(sections, fraction):
    """Each frequency section read from its own stream; sections that do not
    sum to d_rot/2 raise ``ValueError`` as in JAX."""
    d_head = 2 * sum(sections) if fraction == 1.0 else 4 * sum(sections)
    pos = _vl_positions(3, 40)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 40, 2, d_head)).astype(np.float32)
    jc, js = j_rope.rope_cos_sin(jnp.asarray(pos), d_head, fraction=fraction,
                                 mrope_sections=sections)
    tc, ts = t_rope.rope_cos_sin(torch.from_numpy(pos), d_head, fraction=fraction,
                                 mrope_sections=sections)
    assert tc.shape == (3, 40, sum(sections))
    _close(tc, jc, 1e-6)
    _close(ts, js, 1e-6)
    _close(t_rope.apply_rope(torch.from_numpy(x), tc, ts),
           j_rope.apply_rope(jnp.asarray(x), jc, js), 1e-6)
    np.testing.assert_array_equal(t_rope.default_positions(2, 9, "mrope").numpy(),
                                  np.asarray(j_rope.default_positions(2, 9, "mrope")))
    bad = (sections[0] + 1,) + tuple(sections[1:])
    with pytest.raises(ValueError, match="mrope sections"):
        j_rope.rope_cos_sin(jnp.asarray(pos), d_head, fraction=fraction, mrope_sections=bad)
    with pytest.raises(ValueError, match="mrope sections"):
        t_rope.rope_cos_sin(torch.from_numpy(pos), d_head, fraction=fraction,
                            mrope_sections=bad)


def test_equal_streams_are_standard_rope_bit_for_bit():
    """Three equal position streams give standard RoPE's cos and sin and the
    model's loss bit for bit; distinct streams give another loss."""
    pos = np.broadcast_to(np.arange(32, dtype=np.int32) + 3, (B, 32))
    c3, s3 = t_rope.rope_cos_sin(torch.from_numpy(np.stack([pos] * 3)), 32,
                                 mrope_sections=(4, 6, 6))
    c1, s1 = t_rope.rope_cos_sin(torch.from_numpy(np.array(pos)), 32)
    assert torch.equal(c3, c1) and torch.equal(s3, s1)
    cfg = _port_cfg(VLM, "hash_full")
    params = t_lm.init_lm(torch.Generator().manual_seed(0), cfg)
    b = _batch(cfg, positions=False)
    equal = _t(dict(b, positions=np.broadcast_to(pos[None], (3, B, 32))))
    mrope = float(t_lm.lm_loss(params, equal, cfg))
    standard = float(t_lm.lm_loss(params, _t(dict(b, positions=pos)),
                                  dataclasses.replace(cfg, rope_variant="standard")))
    assert mrope == standard
    distinct = float(t_lm.lm_loss(params, _t(dict(b, positions=_vl_positions(B, 32))), cfg))
    assert distinct != mrope


# ---- init and interop ---------------------------------------------------------------------

def test_init_lm_tree_mask_and_count_match_jax(fam):
    mine = t_lm.init_lm(torch.Generator().manual_seed(0), fam.tcfg)
    assert _tree_shapes(mine) == _tree_shapes(fam.tparams)
    assert j_module.trainable_mask(fam.jparams) == t_module.trainable_mask(fam.tparams)
    for trainable in (False, True):
        assert t_module.param_count(fam.tparams, trainable) == \
            j_module.param_count(fam.jparams, trainable)
    nq = fam.tcfg.n_codebooks if fam.case == "audio" else 1
    assert mine["head"].shape == (fam.tcfg.d_model, fam.tcfg.vocab_padded * nq)
    rows = fam.tcfg.vocab_padded * nq
    table = mine["embed"]["table"] if fam.case == "audio" else mine["embed"]["codes_buf"]
    assert table.shape[0] == rows


@pytest.mark.parametrize("case", ["audio_hash", "vlm"])
def test_init_lm_tiles_given_codes_as_jax(case):
    """Codes for the vocabulary (Algorithm 1's, here JAX's random draw) given
    to both packages' ``init_lm``: the same ``codes_buf``, tiled over the
    audio codebooks (``jnp.tile(codes, (reps, 1))[:n]``)."""
    from repro.core import embedding as j_emb
    arch, kind = {"audio_hash": (AUDIO, "hash_full"), "vlm": CASES["vlm"]}[case]
    jcfg = _kind(j_reduced(j_get_config(arch)), kind)
    ecfg = dataclasses.replace(jcfg.embedding_config(), kind="random_full")
    codes = j_emb.make_codes(jax.random.PRNGKey(4), ecfg, None)
    assert codes.shape[0] == jcfg.vocab_padded
    jbuf = np.asarray(j_lm.init_lm(jax.random.PRNGKey(0), jcfg, codes=codes)["embed"]["codes_buf"])
    tcodes = torch.from_numpy(np.asarray(codes).astype(np.int64))
    tbuf = t_lm.init_lm(torch.Generator().manual_seed(0), _port_cfg(arch, kind),
                        codes=tcodes)["embed"]["codes_buf"]
    converted = params_from_jax({"codes_buf": jbuf}, device="cpu")["codes_buf"]
    assert torch.equal(tbuf, converted)
    nq = jcfg.n_codebooks if case == "audio_hash" else 1
    assert tbuf.shape[0] == jcfg.vocab_padded * nq
    for q in range(nq):
        assert torch.equal(tbuf[q * jcfg.vocab_padded:(q + 1) * jcfg.vocab_padded],
                           tbuf[:jcfg.vocab_padded])


def test_lm_cache_from_jax_round_trip(fam):
    """JAX's cache after its prefill and 3 steps, carried across, takes the
    port one step: JAX's next logits and KV buffers."""
    jl_next, jc_next = fam.steps[4]
    cache = lm_cache_from_jax(fam.steps[3][1], device="cpu")
    assert cache.pos == S0 + 3 and cache.ssm_state is None
    np.testing.assert_array_equal(cache.kv_k.numpy(), np.asarray(fam.steps[3][1].kv_k))
    tok = torch.from_numpy(fam.tokens[:, S0 + 3:S0 + 4])
    with torch.inference_mode():
        logits, cache = t_lm.lm_forward(fam.tparams, tok, fam.tcfg, cache=cache)
    _close(logits[:, -1], jl_next)
    _close(cache.kv_k, jc_next.kv_k)
    _close(cache.kv_v, jc_next.kv_v)


# ---- the forward and the training step --------------------------------------------------

def test_lm_forward_and_loss_match_jax(fam):
    """Logits and loss over 32 positions (audio: 4 codebooks a position;
    vlm: distinct M-RoPE streams)."""
    b = _batch(fam.jcfg)
    pos = b.get("positions")
    jlogits, jloss = jax.jit(lambda p, jb: (
        j_lm.lm_forward(p, jb["tokens"], fam.jcfg, positions=jb.get("positions"))[0],
        j_lm.lm_loss(p, jb, fam.jcfg)))(fam.jparams, _j(b))
    tlogits, _ = t_lm.lm_forward(fam.tparams, torch.from_numpy(b["tokens"]), fam.tcfg,
                                 positions=None if pos is None else torch.from_numpy(pos))
    expect = (B, 32) + ((fam.tcfg.n_codebooks,) if fam.case == "audio" else ()) \
        + (fam.tcfg.vocab_padded,)
    assert tuple(tlogits.shape) == expect
    _close(tlogits, jlogits)
    jloss = float(jloss)
    tloss = float(t_lm.lm_loss(fam.tparams, _t(b), fam.tcfg))
    assert abs(tloss - jloss) <= 1e-5, (tloss, jloss)


# ---- serving ---------------------------------------------------------------------------------

def _port_steps(fam):
    """The port's prefill and serve steps along JAX's tokens: after each,
    (last logits, a copy of the KV buffers)."""
    prefill, serve = make_prefill_step(fam.tcfg, S_MAX), make_serve_step(fam.tcfg)
    logits, cache = prefill(fam.tparams, {"tokens": torch.from_numpy(fam.tokens[:, :S0])})
    out = []
    for t in range(STEPS + 1):
        out.append((logits, dataclasses.replace(cache, kv_k=cache.kv_k.clone(),
                                                kv_v=cache.kv_v.clone())))
        if t < STEPS:
            logits, cache = serve(fam.tparams, cache,
                                  {"tokens": torch.from_numpy(fam.tokens[:, S0 + t:S0 + t + 1])})
    return out


def test_prefill_and_decode_steps_match_jax(fam):
    """Each step's last logits (audio: (B, nq, Vpad)) and the KV cache
    against JAX's engine's, along JAX's tokens."""
    for (tl, tc), (jl, jc) in zip(_port_steps(fam), fam.steps):
        assert tuple(tl.shape) == jl.shape
        _close(tl, jl)
        assert tc.pos == int(jc.pos)
        _close(tc.kv_k, jc.kv_k, what="kv_k")
        _close(tc.kv_v, jc.kv_v, what="kv_v")


def test_cached_logits_equal_uncached(fam):
    """The port's cached steps against its own forward without a cache over
    the same 14 positions."""
    full, _ = t_lm.lm_forward(fam.tparams, torch.from_numpy(fam.tokens), fam.tcfg)
    for t, (logits, _) in enumerate(_port_steps(fam)):
        _close(logits, full[:, S0 - 1 + t].numpy())


def test_engine_greedy_tokens_match_jax(fam):
    """``DecodeEngine`` at temperature 0: audio prompts (B, S0, nq) give
    (B, S0 + n, nq), one argmax a codebook fed back as (B, 1, nq); JAX's
    tokens up to the first step where JAX's top-2 margin (the least over
    the codebooks) is under twice the logits bound; on ``gather`` the
    kernel engine's tokens bit for bit."""
    eng = DecodeEngine(fam.tcfg, fam.tparams, s_max=S_MAX, device="cpu")
    res = eng.generate(fam.prompts, STEPS)
    assert res.tokens.shape == fam.tokens.shape == (B, S0 + STEPS) + fam.prompts.shape[2:]
    for b in range(B):
        for t in range(STEPS):
            top2 = np.sort(fam.steps[t][0][b, ..., :fam.jcfg.vocab_size], axis=-1)[..., -2:]
            if (top2[..., 1] - top2[..., 0]).min() <= 2 * TOL:
                break
            np.testing.assert_array_equal(res.tokens[b, S0 + t], fam.tokens[b, S0 + t])
    gather = DecodeEngine(fam.tcfg, fam.tparams, s_max=S_MAX, decode_backend="gather",
                          device="cpu")
    np.testing.assert_array_equal(gather.generate(fam.prompts, STEPS).tokens, res.tokens)
