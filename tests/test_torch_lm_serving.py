"""Port parity for LM serving: the KV cache, the cache branch of attention,
``lm_forward(cache=)``, the prefill and serve steps, ``DecodeEngine``, the
chunked cross-entropy and the chatglm3-6b, yi-9b and internlm2-20b
configs, against the JAX package on the CPU.

The models are ``reduced(get_config(arch))`` of the four dense archs (2
layers, d_model 128, 4 heads of 32, vocab 512, c=16, m=8, f32).  Params are
the JAX package's ``init_lm`` draw carried across with ``params_from_jax``;
inputs come from numpy seeds; TF32 is off.  The port decodes through the
kernel backend (``"pallas"``), whose plain version runs here; the JAX
reference decodes one-hot.  Each arch's JAX engine is built once (module
fixture), so JAX jits its prefill and serve steps once an arch, and its
generated tokens, last logits and caches are the reference of every case.

Bounds: the cache writes are data movement, bitwise; attention, logits and
the caches' keys and values 2e-5 (f32 matmuls in another order, softmax
over up to 40 keys; ``tests/test_torch_lm.py``'s bound); decode against
prefill within the port 2e-5 (``tests/test_nn.py`` holds JAX's to 2e-4);
greedy tokens equal wherever JAX's top-2 margin exceeds twice the logits
bound; the chunked loss rtol 1e-5 and its gradients rtol 2e-3, atol 1e-5
(``tests/test_perf_features.py``'s bounds).
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
from repro.nn import attention as j_attn
from repro.nn import kvcache as j_kv
from repro.nn import rope as j_rope
from repro.serving import engine as j_engine
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.configs.archs import NOT_PORTED
from repro_torch.device import disable_tf32
from repro_torch.interop import lm_cache_from_jax, params_from_jax
from repro_torch.models import lm as t_lm
from repro_torch.nn import attention as t_attn
from repro_torch.nn import kvcache as t_kv
from repro_torch.nn import rope as t_rope
from repro_torch.serving import DecodeEngine, Engine, GenerationResult
from repro_torch.train import make_prefill_step, make_serve_step

disable_tf32()

DENSE = ["qwen1.5-0.5b", "chatglm3-6b", "yi-9b", "internlm2-20b"]
B, S0, STEPS, S_MAX = 2, 8, 6, 16
TOL = 2e-5


def _port_cfg(arch, **fields):
    cfg = reduced(get_config(arch))
    return dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, lookup_impl="pallas"), **fields)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _generate_with_logits(eng, prompts, steps):
    """``eng.generate`` with its prefill and serve steps wrapped to keep each
    step's last-position logits: (result, (B, 1 + steps, Vpad) logits)."""
    kept = []

    def wrap(step):
        def recorded(*args):
            out = step(*args)
            kept.append(out[0])
            return out
        return recorded

    eng._prefill, eng._serve = wrap(eng._prefill), wrap(eng._serve)
    return eng.generate(prompts, steps), torch.stack(kept, dim=1)


@pytest.fixture(scope="module", params=DENSE)
def served(request):
    """JAX's engine for one arch: its greedy tokens, and the last logits
    and the cache after its prefill and after each decode step along them."""
    arch = request.param
    jcfg = j_reduced(j_get_config(arch))
    jparams = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    jeng = j_engine.DecodeEngine(jcfg, jparams, s_max=S_MAX)
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, (B, S0)).astype(np.int32)
    tokens = np.array(jeng.generate(prompts, STEPS).tokens)
    logits, cache = jeng._prefill(jparams, {"tokens": jnp.asarray(prompts)})
    steps = [(np.asarray(logits), cache)]
    for t in range(STEPS):
        logits, cache = jeng._serve(jparams, cache,
                                    {"tokens": jnp.asarray(tokens[:, S0 + t:S0 + t + 1])})
        steps.append((np.asarray(logits), cache))
    return types.SimpleNamespace(arch=arch, jcfg=jcfg, tcfg=_port_cfg(arch), prompts=prompts,
                                 tokens=tokens, steps=steps,
                                 tparams=params_from_jax(jparams, device="cpu"))


def _port_steps(s, tokens):
    """The port's prefill and serve steps along ``tokens``: after each,
    (last logits, pos, kv_k, kv_v), the buffers copied (the next step
    writes them in place)."""
    prefill, serve = make_prefill_step(s.tcfg, S_MAX), make_serve_step(s.tcfg)
    logits, cache = prefill(s.tparams, {"tokens": torch.from_numpy(tokens[:, :S0])})
    out = []
    for t in range(STEPS + 1):
        out.append((logits, cache.pos, cache.kv_k.clone(), cache.kv_v.clone()))
        if t < STEPS:
            logits, cache = serve(s.tparams, cache,
                                  {"tokens": torch.from_numpy(tokens[:, S0 + t:S0 + t + 1])})
    return out


# ---- KVCache ------------------------------------------------------------------

@pytest.mark.parametrize("branch", ["full", "one", "chunk"])
def test_kvcache_update_matches_jax(branch):
    """Each of ``update``'s branches, from a cache already holding 3 rows
    (the full write from zero), bitwise JAX's."""
    rng = np.random.default_rng(0)
    Bc, S, K, Dh = 2, 8, 2, 4
    s_new = {"full": S, "one": 1, "chunk": 3}[branch]
    first = rng.standard_normal((Bc, 3, K, Dh)).astype(np.float32)
    new_k, new_v = (rng.standard_normal((Bc, s_new, K, Dh)).astype(np.float32)
                    for _ in range(2))
    jc = j_kv.KVCache.zeros(Bc, S, K, Dh, jnp.float32)
    tc = t_kv.KVCache.zeros(Bc, S, K, Dh, torch.float32, device="cpu")
    if branch != "full":
        jc = jc.update(jnp.asarray(first), jnp.asarray(first))
        tc = tc.update(torch.from_numpy(first), torch.from_numpy(first))
    jc = jc.update(jnp.asarray(new_k), jnp.asarray(new_v))
    tc = tc.update(torch.from_numpy(new_k), torch.from_numpy(new_v))
    assert tc.pos == int(jc.pos)
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_array_equal(tc.valid_mask().numpy(), np.asarray(jc.valid_mask()))


def test_kvcache_writes_in_place_and_refuses_to_overflow():
    tc = t_kv.KVCache.zeros(1, 4, 1, 2, torch.float32, device="cpu")
    buf = tc.k
    tc = tc.update(torch.ones(1, 3, 1, 2), torch.ones(1, 3, 1, 2))
    assert tc.k is buf and tc.pos == 3 and float(buf[0, :3].sum()) == 6.0
    with pytest.raises(ValueError, match="overflow"):
        tc.update(torch.ones(1, 2, 1, 2), torch.ones(1, 2, 1, 2))


# ---- attention with a cache ---------------------------------------------------------

@pytest.mark.parametrize("chunked", [False, True])
def test_attend_xla_with_offset_and_valid_slots_matches_jax(chunked):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 32)).astype(np.float32) for _ in range(2))
    valid = np.arange(40) < 27                    # 11 cached rows + 16 new ones
    kw_j = dict(causal=True, q_offset=11, kv_valid=jnp.asarray(valid))
    kw_t = dict(causal=True, q_offset=11, kv_valid=torch.from_numpy(valid))
    if chunked:
        want = j_attn._attend_xla_chunked(*map(jnp.asarray, (q, k, v)), chunk=4, **kw_j)
        got = t_attn._attend_xla_chunked(*map(torch.from_numpy, (q, k, v)), chunk=4, **kw_t)
    else:
        want = j_attn._attend_xla(*map(jnp.asarray, (q, k, v)), **kw_j)
        got = t_attn._attend_xla(*map(torch.from_numpy, (q, k, v)), **kw_t)
    _close(got, want)


@pytest.mark.parametrize("kv", [1, 2, 8])
def test_attention_decode_equals_prefill(kv):
    """The cache branch token by token equals one causal pass over the
    prompt (``tests/test_nn.py``'s case), and each decode step equals
    JAX's."""
    jcfg = j_attn.AttentionConfig(d_model=64, n_heads=8, n_kv_heads=kv, d_head=8)
    tcfg = t_attn.AttentionConfig(d_model=64, n_heads=8, n_kv_heads=kv, d_head=8)
    jp = j_attn.init_attention(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jp, device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 16, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    cos, sin = t_rope.rope_cos_sin(torch.from_numpy(np.array(pos)), 8)
    y_full, none = t_attn.attention(tp, torch.from_numpy(x), tcfg, cos=cos, sin=sin)
    assert none is None
    jcache = j_kv.KVCache.zeros(2, 32, kv, 8, jnp.float32)
    tcache = t_kv.KVCache.zeros(2, 32, kv, 8, torch.float32, device="cpu")
    ys = []
    for t in range(16):
        jc, js = j_rope.rope_cos_sin(jnp.asarray(pos[:, t:t + 1]), 8)
        yj, jcache = j_attn.attention(jp, jnp.asarray(x[:, t:t + 1]), jcfg, cos=jc, sin=js,
                                      cache=jcache)
        yt, tcache = t_attn.attention(tp, torch.from_numpy(x[:, t:t + 1]), tcfg,
                                      cos=cos[:, t:t + 1], sin=sin[:, t:t + 1], cache=tcache)
        _close(yt, yj)
        ys.append(yt)
    assert tcache.pos == 16
    _close(torch.cat(ys, 1), y_full.numpy())
    _close(tcache.k, jcache.k)


# ---- the model's cached forward, the steps and the engine ---------------------------

def test_prefill_and_decode_steps_match_jax(served):
    """Prefill of 8 tokens, then 6 decode steps along JAX's tokens: each
    step's last logits and the whole cache against JAX's."""
    for (tl, pos, kv_k, kv_v), (jl, jc) in zip(_port_steps(served, served.tokens),
                                               served.steps):
        assert tl.dtype == torch.float32 and tl.shape == (B, served.tcfg.vocab_padded)
        _close(tl, jl)
        assert pos == int(jc.pos)
        _close(kv_k, jc.kv_k)
        _close(kv_v, jc.kv_v)


def test_one_decode_step_from_jax_cache(served):
    """JAX's cache after its prefill and 3 steps, carried across, takes the
    port one step: JAX's next logits and cache."""
    jl_next, jc_next = served.steps[4]
    cache = lm_cache_from_jax(served.steps[3][1], device="cpu")
    assert cache.pos == S0 + 3 and cache.kv_k.shape == (served.tcfg.n_layers, B, S_MAX,
                                                        served.tcfg.n_kv_heads, 32)
    tok = torch.from_numpy(served.tokens[:, S0 + 3:S0 + 4])
    logits, cache = t_lm.lm_forward(served.tparams, tok, served.tcfg, cache=cache)
    _close(logits[:, -1], jl_next)
    assert cache.pos == int(jc_next.pos)
    _close(cache.kv_k, jc_next.kv_k)


def test_cached_logits_equal_uncached(served):
    """The port's cached steps against its own forward without a cache over
    the same 14 tokens (``tests/test_arch_smoke.py``'s consistency case)."""
    full, _ = t_lm.lm_forward(served.tparams, torch.from_numpy(served.tokens), served.tcfg)
    for t, (logits, *_) in enumerate(_port_steps(served, served.tokens)):
        _close(logits, full[:, S0 - 1 + t].numpy())


def test_engine_greedy_tokens_match_jax(served):
    """``DecodeEngine`` at temperature 0, seed 0: the port's tokens are
    JAX's up to the first step where JAX's top-2 margin is under twice the
    logits bound (after it, the two may pick different tokens and part);
    the port's logits teacher-forced along JAX's tokens are within the
    bound at every step."""
    eng = DecodeEngine(served.tcfg, served.tparams, s_max=S_MAX, device="cpu")
    res, logits = _generate_with_logits(eng, served.prompts, STEPS)
    assert isinstance(res, GenerationResult) and res.steps == STEPS
    assert res.tokens.dtype == np.int32 and res.tokens.shape == (B, S0 + STEPS)
    assert logits.shape == (B, STEPS + 1, served.tcfg.vocab_padded)
    np.testing.assert_array_equal(res.tokens[:, :S0], served.prompts)
    vocab = served.jcfg.vocab_size
    for b in range(B):
        for t in range(STEPS):
            top2 = np.sort(served.steps[t][0][b, :vocab])[-2:]
            if top2[1] - top2[0] <= 2 * TOL:
                break
            assert res.tokens[b, S0 + t] == served.tokens[b, S0 + t], (served.arch, b, t)
    if np.array_equal(res.tokens, served.tokens):
        for t, (jl, _) in enumerate(served.steps):
            _close(logits[:, t], jl)
    else:
        for (tl, *_), (jl, _) in zip(_port_steps(served, served.tokens), served.steps):
            _close(tl, jl)


def test_engine_protocol_backends_and_sampling():
    """``tests/test_serving.py``'s protocol case: an ``Engine``, unknown
    kwargs ignored; the backend names; sampled tokens reproducible from a
    seed and inside the vocabulary."""
    cfg = _port_cfg("qwen1.5-0.5b", vocab_size=500)          # padded to 512
    params = t_lm.init_lm(torch.Generator().manual_seed(0), cfg)
    eng = DecodeEngine(cfg, params, s_max=16, decode_backend="auto", device="cpu")
    assert isinstance(eng, Engine) and eng.decode_backend == "onehot"
    req = np.random.default_rng(3).integers(0, 500, (2, 5))
    for res in (eng.serve(req, max_new_tokens=2),
                eng.serve(req, max_new_tokens=2, definitely_not_a_real_option=1)):
        assert res.tokens.shape == (2, 7) and res.steps == 2
    with pytest.raises(ValueError, match="unknown decode backend"):
        DecodeEngine(cfg, params, decode_backend="bogus", device="cpu")
    with pytest.raises(ValueError, match="s_max"):
        eng.generate(req, 12)
    hot = [eng.generate(req, 8, temperature=1.5, seed=s).tokens for s in (7, 7, 8)]
    np.testing.assert_array_equal(hot[0], hot[1])
    assert not np.array_equal(hot[0], hot[2])
    assert ((hot[0] >= 0) & (hot[0] < 500)).all()


# ---- the chunked cross-entropy --------------------------------------------------------

@pytest.mark.parametrize("vocab", [512, 500])
def test_chunked_loss_and_grads_match_jax(vocab):
    """reduced yi-9b, chunks of 64 (``tests/test_perf_features.py``'s case);
    at vocab 500 the pad columns fall in the last of 8 chunks.  The port's
    chunked loss against JAX's chunked loss and the port's plain loss, and
    its gradients against JAX's."""
    jcfg = dataclasses.replace(j_reduced(j_get_config("yi-9b")), vocab_size=vocab,
                               loss_vocab_chunk=64)
    tcfg = dataclasses.replace(reduced(get_config("yi-9b")), vocab_size=vocab,
                               loss_vocab_chunk=64)
    jparams = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(jparams, device="cpu")
    toks = np.random.default_rng(4).integers(0, vocab, (2, 17)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:])}
    jloss, jg = jax.value_and_grad(lambda p: j_lm.lm_loss(p, jb, jcfg), allow_int=True)(jparams)
    from repro_torch.nn.module import value_and_grad
    tloss, tg = value_and_grad(lambda p: t_lm.lm_loss(p, tb, tcfg), tparams)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    plain = t_lm.lm_loss(tparams, tb, dataclasses.replace(tcfg, loss_vocab_chunk=0))
    np.testing.assert_allclose(float(tloss), float(plain), rtol=1e-5)

    def walk(t, j, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, j[k], path + (k,))
            elif v is not None:
                np.testing.assert_allclose(v.numpy(), np.asarray(j[k]), rtol=2e-3, atol=1e-5,
                                           err_msg="/".join(path + (k,)))
    walk(tg, jg)
    assert tg["head"] is not None and float(tg["head"].abs().sum()) > 0


# ---- configs ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["chatglm3-6b", "yi-9b", "internlm2-20b"])
def test_dense_configs_match_jax(arch):
    for cfg_j, cfg_t in [(j_get_config(arch), get_config(arch)),
                         (j_reduced(j_get_config(arch)), reduced(get_config(arch)))]:
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.vocab_padded == cfg_j.vocab_padded
    assert arch in list_archs() and arch not in NOT_PORTED
