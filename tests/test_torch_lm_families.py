"""Port parity for the moe, ssm and hybrid LM families against the JAX
package on the CPU: the granite-moe-3b-a800m, dbrx-132b, mamba2-2.7b and
zamba2-7b configs, ``init_lm``'s trees, ``lm_forward`` with and without a
cache, the training step, ``DecodeEngine`` and the interop of params and
caches.

The models are ``reduced(get_config(arch))`` (d_model 128, vocab 512, c=16,
m=8, f32; moe: 8 experts padded to 16, top-2, 2 layers; ssm: 2 layers,
state 16, heads of 16, chunk 16; hybrid: 13 layers, two groups of 6 and a
tail of 1, 4 heads of 32).  Params are JAX's ``init_lm`` draw carried
across with ``params_from_jax``; inputs come from numpy seeds; TF32 is off.
The port decodes through the kernel backend (``"pallas"``, its plain
version here), JAX one-hot.

Bounds: logits 5e-5 (f32 products in another order through up to 13
layers and 2 shared-block calls; measured at most 1.3e-5); one training
step from JAX's state: loss 1e-5, params 1e-4 after it; 3 free steps at
Adam's eps 1 the same (PR 16's bounds and ROADMAP §C's eps rule); the
engine's greedy tokens equal JAX's wherever JAX's top-2 margin exceeds
twice the logits bound, its logits and caches within the logits bound.
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
from repro.serving import engine as j_engine
from repro.train.step import TrainHyper as JTrainHyper
from repro.train.step import make_train_step as j_make_train_step
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.configs.archs import NOT_PORTED
from repro_torch.device import disable_tf32
from repro_torch.interop import lm_cache_from_jax, params_from_jax
from repro_torch.models import lm as t_lm
from repro_torch.nn import module as t_module
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serving import DecodeEngine
from repro_torch.train import TrainHyper, make_train_step

disable_tf32()

FAMILIES = {"moe": "granite-moe-3b-a800m", "ssm": "mamba2-2.7b", "hybrid": "zamba2-7b"}
NEW_ARCHS = ["granite-moe-3b-a800m", "dbrx-132b", "mamba2-2.7b", "zamba2-7b"]
B, S0, STEPS, S_MAX = 2, 8, 6, 16
TOL = 5e-5


def _port_cfg(arch, **fields):
    cfg = reduced(get_config(arch))
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


@pytest.fixture(scope="module", params=list(FAMILIES))
def fam(request):
    """One family's reduced arch: JAX's init, and JAX's engine run (its
    greedy tokens, and the last logits and cache after its prefill and
    after each decode step along them)."""
    arch = FAMILIES[request.param]
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
    return types.SimpleNamespace(family=request.param, arch=arch, jcfg=jcfg, jparams=jparams,
                                 tcfg=_port_cfg(arch), prompts=prompts, tokens=tokens,
                                 steps=steps, tparams=params_from_jax(jparams, device="cpu"))


def _tree_shapes(tree):
    return {k: _tree_shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


# ---- configs ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_family_configs_match_jax(arch):
    for cfg_j, cfg_t in [(j_get_config(arch), get_config(arch)),
                         (j_reduced(j_get_config(arch)), reduced(get_config(arch)))]:
        assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.active_param_count() == cfg_j.active_param_count()
        assert cfg_t.n_experts_padded == cfg_j.n_experts_padded
        assert cfg_t.vocab_padded == cfg_j.vocab_padded
    assert arch in list_archs()
    assert get_config("granite-moe-3b-a800m").n_experts_padded == 48
    assert get_config("dbrx-132b").n_experts_padded == 16


def test_only_audio_and_vlm_stay_unported():
    """The name is older than the audio and vlm port and kept: now every JAX
    arch is ported, and the two families' reduced configs initialise, take
    a cache and an engine (their parity: test_torch_lm_audio_vlm)."""
    from repro.configs import list_archs as j_list_archs
    assert NOT_PORTED == {}
    assert list_archs() == j_list_archs() and len(list_archs()) == 10
    for arch in ("musicgen-large", "qwen2-vl-7b"):
        cfg = reduced(get_config(arch))
        params = t_lm.init_lm(torch.Generator().manual_seed(0), cfg)
        cache = t_lm.init_cache(cfg, 1, 8, device="cpu")
        assert cache.kv_k.shape == (cfg.n_layers, 1, 8, cfg.n_kv_heads, cfg.head_dim)
        prompts = np.zeros((1, 4) + ((cfg.n_codebooks,) if arch == "musicgen-large" else ()),
                           np.int32)
        tokens = DecodeEngine(cfg, params, s_max=8, device="cpu").generate(prompts, 2).tokens
        assert tokens.shape == (1, 6) + prompts.shape[2:]


# ---- init and interop -------------------------------------------------------------------

def test_init_lm_tree_mask_and_count_match_jax(fam):
    mine = t_lm.init_lm(torch.Generator().manual_seed(0), fam.tcfg)
    assert _tree_shapes(mine) == _tree_shapes(fam.tparams)
    assert j_module.trainable_mask(fam.jparams) == t_module.trainable_mask(fam.tparams)
    for trainable in (False, True):
        assert t_module.param_count(fam.tparams, trainable) == \
            j_module.param_count(fam.jparams, trainable)
    expect = {"moe": {"blocks"}, "ssm": {"blocks"}, "hybrid": {"blocks", "shared", "tail"}}
    assert set(mine) - {"embed", "final_norm", "head"} == expect[fam.family]
    if fam.family == "hybrid":
        assert mine["blocks"]["ssm"]["w_x"].shape[:2] == (2, 6)
        assert mine["tail"]["ssm"]["w_x"].shape[0] == 1
    if fam.family == "moe":
        assert mine["blocks"]["moe"]["w_gate"].shape[:2] == (2, 16)


@pytest.mark.parametrize("arch", NEW_ARCHS + ["qwen1.5-0.5b"])
def test_init_lm_is_bitwise_the_old_draw_then_stack(arch, monkeypatch):
    """Each layer drawn into the preallocated stack gives the bits of
    drawing every layer and stacking them, for one seed."""
    cfg = reduced(get_config(arch))
    new = t_lm.init_lm(torch.Generator().manual_seed(3), cfg)

    def stack(trees):
        return {k: stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]) for k, v in trees[0].items()}

    monkeypatch.setattr(t_lm, "_init_stacked", lambda n, one: stack([one() for _ in range(n)]))
    old = t_lm.init_lm(torch.Generator().manual_seed(3), cfg)
    pairs = list(zip(t_module.leaves_with_path(new), t_module.leaves_with_path(old)))
    assert len(pairs) == len(list(t_module.leaves_with_path(old)))
    for (pn, a), (po, b) in pairs:
        assert pn == po and torch.equal(a, b), pn


def test_lm_cache_from_jax_round_trip(fam):
    """JAX's cache after its prefill and 3 steps, carried across, takes the
    port one step: JAX's next logits, KV buffers, SSM states and conv tails."""
    jl_next, jc_next = fam.steps[4]
    cache = lm_cache_from_jax(fam.steps[3][1], device="cpu")
    assert cache.pos == S0 + 3
    for name in ("kv_k", "kv_v", "ssm_state", "conv"):
        j = getattr(fam.steps[3][1], name)
        assert (getattr(cache, name) is None) == (j is None), name
        if j is not None:
            np.testing.assert_array_equal(getattr(cache, name).numpy(), np.asarray(j))
    tok = torch.from_numpy(fam.tokens[:, S0 + 3:S0 + 4])
    with torch.inference_mode():
        logits, cache = t_lm.lm_forward(fam.tparams, tok, fam.tcfg, cache=cache)
    _close(logits[:, -1], jl_next)
    for name in ("kv_k", "ssm_state", "conv"):
        if getattr(jc_next, name) is not None:
            _close(getattr(cache, name), getattr(jc_next, name), what=name)


# ---- the forward and the training step --------------------------------------------------

def _batch(cfg, S=32, seed=5):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_lm_forward_and_loss_match_jax(fam):
    """Logits and loss over 32 tokens; the moe family under both of its
    impls (sorted dispatch, ``"ep"`` without a mesh, and ``"dense"``)."""
    impls = ["ep", "dense"] if fam.family == "moe" else [fam.jcfg.moe_impl]
    b = _batch(fam.jcfg)
    for moe_impl in impls:
        jcfg = dataclasses.replace(fam.jcfg, moe_impl=moe_impl)
        tcfg = dataclasses.replace(fam.tcfg, moe_impl=moe_impl)
        jlogits, _ = jax.jit(lambda p, t: j_lm.lm_forward(p, t, jcfg))(fam.jparams,
                                                                         b["tokens"])
        tlogits, _ = t_lm.lm_forward(fam.tparams, torch.from_numpy(b["tokens"]), tcfg)
        assert tlogits.shape == (B, 32, tcfg.vocab_padded)
        _close(tlogits, jlogits, what=moe_impl)
        jloss = float(j_lm.lm_loss(fam.jparams, {k: jnp.asarray(v) for k, v in b.items()},
                                   jcfg))
        tloss = float(t_lm.lm_loss(fam.tparams, {k: torch.from_numpy(v)
                                                 for k, v in b.items()}, tcfg))
        assert abs(tloss - jloss) <= 1e-5, (moe_impl, tloss, jloss)


def _train_pair(fam, eps):
    opt = dict(lr=1e-3, weight_decay=0.01, clip_norm=1.0, eps=eps)
    jstep = jax.jit(j_make_train_step(fam.jcfg, JTrainHyper(
        optimizer=JAdamWConfig(**opt), warmup_steps=1, total_steps=4)))
    tstep = make_train_step(fam.tcfg, TrainHyper(optimizer=AdamWConfig(**opt),
                                                 warmup_steps=1, total_steps=4))
    from repro.optim.adamw import adamw_init as j_adamw_init
    jstate = {"params": fam.jparams, "opt": j_adamw_init(fam.jparams),
              "step": jnp.zeros((), jnp.int32)}
    return jstep, jstate, tstep


def _port_state(jstate):
    params = params_from_jax(jstate["params"], device="cpu")
    opt = {"step": int(jstate["opt"]["step"]),
           "mu": params_from_jax(jstate["opt"]["mu"], device="cpu"),
           "nu": params_from_jax(jstate["opt"]["nu"], device="cpu")}
    return {"params": params, "opt": opt, "step": int(jstate["step"])}


def _params_close(tparams, jparams, tol=1e-4):
    _walk(tparams, jparams,
          lambda path, v, j: None if not v.is_floating_point()
          else _close(v, j, tol, path))


def test_training_steps_match_jax(fam):
    """Two steps, each from JAX's state (loss within 1e-5, params within 1e-4
    after it), then 3 free-running at Adam's eps 1 within the same.  For
    the hybrid, the shared block's gradient sums its 2 call sites."""
    stream = np.random.default_rng(7)
    batches = [_batch(fam.jcfg, seed=int(stream.integers(1 << 30))) for _ in range(3)]
    jstep, jstate, tstep = _train_pair(fam, 1e-8)
    for b in batches[:2]:
        tstate = _port_state(jstate)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        _params_close(tstate["params"], jstate["params"])
    jstep, jstate, tstep = _train_pair(fam, 1.0)
    tstate = _port_state(jstate)
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    _params_close(tstate["params"], jstate["params"])


def test_bf16_moments_step_reads_them_in_f32():
    """``adamw_init(moments_dtype=torch.bfloat16)`` (the JAX profiles' knob):
    the step stores the moments rounded to bf16 and moves the params from
    the f32 values, so after one step from zero moments the params are the
    f32-moment run's and the moments are its rounded."""
    cfg = _port_cfg("granite-moe-3b-a800m")
    params = t_lm.init_lm(torch.Generator().manual_seed(0), cfg)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    step = make_train_step(cfg, TrainHyper(warmup_steps=1, total_steps=3))
    states = {}
    for dt in (torch.float32, torch.bfloat16):
        p = t_module.map_tree(lambda _, t: t.clone(), params)
        states[dt], _ = step({"params": p, "opt": adamw_init(p, dt), "step": 0}, b)
    f32, bf16 = states[torch.float32], states[torch.bfloat16]
    _walk(bf16["params"], f32["params"], lambda path, v, j: torch.testing.assert_close(
        v, j, rtol=0, atol=0, msg=path))
    mu = bf16["opt"]["mu"]["blocks"]["moe"]["w_up"]
    assert mu.dtype == torch.bfloat16
    assert torch.equal(mu, f32["opt"]["mu"]["blocks"]["moe"]["w_up"].to(torch.bfloat16))


# ---- serving ---------------------------------------------------------------------------------

def _port_steps(fam, cfg=None):
    """The port's prefill and serve steps along JAX's tokens: after each,
    (last logits, a copy of the cache's buffers)."""
    from repro_torch.train import make_prefill_step, make_serve_step
    cfg = cfg or fam.tcfg
    prefill, serve = make_prefill_step(cfg, S_MAX), make_serve_step(cfg)
    logits, cache = prefill(fam.tparams, {"tokens": torch.from_numpy(fam.tokens[:, :S0])})
    out = []
    for t in range(STEPS + 1):
        out.append((logits, dataclasses.replace(
            cache, **{n: getattr(cache, n).clone() for n in ("kv_k", "kv_v", "ssm_state", "conv")
                      if getattr(cache, n) is not None})))
        if t < STEPS:
            logits, cache = serve(fam.tparams, cache,
                                  {"tokens": torch.from_numpy(fam.tokens[:, S0 + t:S0 + t + 1])})
    return out


def test_prefill_and_decode_steps_match_jax(fam):
    """Each step's last logits and the whole cache (KV sites, SSM states,
    conv tails) against JAX's engine's, along JAX's tokens; the cache's
    bytes are its four buffers'."""
    for (tl, tc), (jl, jc) in zip(_port_steps(fam), fam.steps):
        _close(tl, jl)
        assert tc.pos == int(jc.pos)
        for name in ("kv_k", "kv_v", "ssm_state", "conv"):
            j = getattr(jc, name)
            assert (getattr(tc, name) is None) == (j is None), name
            if j is not None:
                assert getattr(tc, name).dtype == torch.float32
                _close(getattr(tc, name), j, what=name)
    assert tc.nbytes == sum(np.asarray(getattr(jc, n)).nbytes
                            for n in ("kv_k", "kv_v", "ssm_state", "conv")
                            if getattr(jc, n) is not None)


def test_cached_logits_equal_uncached(fam):
    """The port's cached steps (for ssm and hybrid: the single-step
    recurrence) against its own forward without a cache (the chunked scan)
    over the same 14 tokens, padded to 16 (a chunk; causal, so the pad
    changes no earlier logit)."""
    toks = np.concatenate([fam.tokens, np.zeros((B, 2), np.int32)], axis=1)
    full, _ = t_lm.lm_forward(fam.tparams, torch.from_numpy(toks), fam.tcfg)
    for t, (logits, _) in enumerate(_port_steps(fam)):
        _close(logits, full[:, S0 - 1 + t].numpy())


def test_engine_greedy_tokens_match_jax(fam):
    """``DecodeEngine`` at temperature 0: JAX's tokens up to the first step
    where JAX's top-2 margin is under twice the logits bound; on the
    ``gather`` backend the kernel engine's tokens bit for bit."""
    eng = DecodeEngine(fam.tcfg, fam.tparams, s_max=S_MAX, device="cpu")
    res = eng.generate(fam.prompts, STEPS)
    assert res.tokens.shape == (B, S0 + STEPS)
    for b in range(B):
        for t in range(STEPS):
            top2 = np.sort(fam.steps[t][0][b, :fam.jcfg.vocab_size])[-2:]
            if top2[1] - top2[0] <= 2 * TOL:
                break
            assert res.tokens[b, S0 + t] == fam.tokens[b, S0 + t], (fam.arch, b, t)
    gather = DecodeEngine(fam.tcfg, fam.tparams, s_max=S_MAX, decode_backend="gather",
                          device="cpu")
    np.testing.assert_array_equal(gather.generate(fam.prompts, STEPS).tokens, res.tokens)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_in_parts_is_the_whole_leafs_bits(moments, monkeypatch):
    """The update slices a large leaf (``UPDATE_PART`` elements at a time,
    so its f32 temporaries stay small); elementwise, so the slices give
    the bits of the whole-leaf update, moments included."""
    from repro_torch.optim import adamw
    rng = np.random.default_rng(8)
    params = {"w": torch.from_numpy(rng.standard_normal((6, 50, 7)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(9).astype(np.float32))}
    grads = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in params.items()}
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.01, clip_norm=0.5)
    out = []
    for part in (1 << 26, 64):
        monkeypatch.setattr(adamw, "UPDATE_PART", part)
        p = {k: v.clone() for k, v in params.items()}
        state = adamw_init(p, getattr(torch, moments))
        for _ in range(2):
            adamw.adamw_update(p, grads, state, cfg)
        out.append((p, state))
    (p1, s1), (p2, s2) = out
    for k in params:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1["mu"][k], s2["mu"][k]) and torch.equal(s1["nu"][k], s2["nu"][k])


def test_engine_refuses_a_prompt_the_chunked_scan_cannot_take():
    """An ssm prompt longer than one SSD chunk (16 in the reduced config)
    and not a multiple of it fails at ``generate``, before any step."""
    cfg = _port_cfg("mamba2-2.7b")
    eng = DecodeEngine(cfg, t_lm.init_lm(torch.Generator().manual_seed(0), cfg), s_max=64,
                       device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        eng.generate(np.zeros((1, 20), np.int32), 2)
    assert eng.generate(np.zeros((1, 32), np.int32), 2).tokens.shape == (1, 34)
