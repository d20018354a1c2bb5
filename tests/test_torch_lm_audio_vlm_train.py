"""Port parity of the audio and vlm LM families' training against the JAX
package on the CPU: the training step from JAX's state and free-running,
``microbatches=2`` over distinct M-RoPE streams, musicgen's ``hash_full``
ablation, the audio loss's guard against the chunked path, and the
reproducibility of the audio gradients.  The models, inputs and helpers
are ``test_torch_lm_audio_vlm.py``'s.

Bounds: loss 1e-5; params 1e-4 after a step from JAX's state and after 3
free steps, all at Adam's eps 1 (ROADMAP §C's eps rule; one compiled JAX
step a case keeps the file cheap on a tier-1 worker).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import lm as j_lm
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as j_adamw_init
from repro.train.step import TrainHyper as JTrainHyper
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.device import disable_tf32
from repro_torch.interop import params_from_jax
from repro_torch.models import lm as t_lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import TrainHyper, make_train_step
from test_torch_lm_audio_vlm import (AUDIO, CASES, B, _batch, _close, _j, _kind, _port_cfg,
                                     _t, _walk)

disable_tf32()


@pytest.fixture(scope="module", params=list(CASES))
def fam(request):
    arch, kind = CASES[request.param]
    jcfg = _kind(j_reduced(j_get_config(arch)), kind)
    return jcfg, _port_cfg(arch, kind), j_lm.init_lm(jax.random.PRNGKey(0), jcfg)


def test_audio_loss_never_takes_the_chunked_path():
    """``loss_vocab_chunk`` leaves the audio loss as it was (JAX's guard):
    the loss with and without it the same bits."""
    cfg = _port_cfg(AUDIO, "dense")
    params = t_lm.init_lm(torch.Generator().manual_seed(1), cfg)
    b = _t(_batch(cfg))
    assert float(t_lm.lm_loss(params, b, cfg)) == float(t_lm.lm_loss(
        params, b, dataclasses.replace(cfg, loss_vocab_chunk=128)))


def _train_pair(jcfg, tcfg, eps, microbatches=1):
    opt = dict(lr=1e-3, weight_decay=0.01, clip_norm=1.0, eps=eps)
    jstep = jax.jit(j_make_train_step(jcfg, JTrainHyper(
        optimizer=JAdamWConfig(**opt), warmup_steps=1, total_steps=4,
        microbatches=microbatches)))
    tstep = make_train_step(tcfg, TrainHyper(optimizer=AdamWConfig(**opt), warmup_steps=1,
                                             total_steps=4, microbatches=microbatches))
    return jstep, tstep


def _states(jparams):
    jstate = {"params": jparams, "opt": j_adamw_init(jparams), "step": jnp.zeros((), jnp.int32)}
    return jstate, _port_state(jstate)


def _port_state(jstate):
    params = params_from_jax(jstate["params"], device="cpu")
    opt = {"step": int(jstate["opt"]["step"]),
           "mu": params_from_jax(jstate["opt"]["mu"], device="cpu"),
           "nu": params_from_jax(jstate["opt"]["nu"], device="cpu")}
    return {"params": params, "opt": opt, "step": int(jstate["step"])}


def _params_close(tparams, jparams, tol=1e-4):
    _walk(tparams, jparams,
          lambda path, v, j: None if not v.is_floating_point() else _close(v, j, tol, path))


def _steps_match(jcfg, tcfg, jparams, stepped, free=()):
    """One compiled JAX step at Adam's eps 1: each of ``stepped`` from JAX's
    state (loss within 1e-5, params within 1e-4 after it); then ``free``
    free-running from the init, within the same."""
    jstep, tstep = _train_pair(jcfg, tcfg, 1.0)
    jstate, _ = _states(jparams)
    for b in stepped:
        tstate = _port_state(jstate)
        jstate, jm = jstep(jstate, _j(b))
        tstate, tm = tstep(tstate, _t(b))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        _params_close(tstate["params"], jstate["params"])
    if free:
        jstate, tstate = _states(jparams)
        for b in free:
            jstate, jm = jstep(jstate, _j(b))
            tstate, tm = tstep(tstate, _t(b))
            assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
        _params_close(tstate["params"], jstate["params"])


def test_training_steps_match_jax(fam):
    """Two steps from JAX's state, then 3 free-running (``_steps_match``)."""
    jcfg, tcfg, jparams = fam
    stream = np.random.default_rng(7)
    batches = [_batch(jcfg, seed=int(stream.integers(1 << 30))) for _ in range(3)]
    _steps_match(jcfg, tcfg, jparams, batches[:2], free=batches)


def test_audio_hash_forward_loss_and_step_match_jax():
    """musicgen under ``hash_full`` (the chip's ``musicgen_hash`` ablation):
    the 4 x 32 x 2 codebook-offset ids decoded from the tiled codes, the
    logits and loss, and one step from JAX's state (the codebook gradient
    through the offsets within the params bound)."""
    jcfg = _kind(j_reduced(j_get_config(AUDIO)), "hash_full")
    tcfg = _port_cfg(AUDIO, "hash_full")
    jparams = j_lm.init_lm(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_jax(jparams, device="cpu")
    b = _batch(jcfg, seed=6)
    jlogits, _ = j_lm.lm_forward(jparams, jnp.asarray(b["tokens"]), jcfg)
    tlogits, _ = t_lm.lm_forward(tparams, torch.from_numpy(b["tokens"]), tcfg)
    assert tuple(tlogits.shape) == (B, 32, 4, tcfg.vocab_padded)
    _close(tlogits, jlogits)
    _steps_match(jcfg, tcfg, jparams, [b])


def test_microbatches_split_each_entry_on_its_batch_axis():
    """``microbatches=2`` against JAX's with distinct M-RoPE streams: the
    (3, B, S) positions are cut on their batch axis (dim 1), as JAX cuts
    them, so each microbatch keeps all three of its rows' streams (cutting
    dim 0 hands each one stream).  One step from one state: loss within
    1e-5, params within 1e-4; and the port's 2 microbatches against its own
    single batch."""
    arch, kind = CASES["vlm"]
    jcfg = _kind(j_reduced(j_get_config(arch)), kind)
    tcfg = _port_cfg(arch, kind)
    jparams = j_lm.init_lm(jax.random.PRNGKey(2), jcfg)
    b = _batch(jcfg, seed=9)
    jstep, tstep = _train_pair(jcfg, tcfg, 1.0, microbatches=2)
    jstate, tstate = _states(jparams)
    jstate, jm = jstep(jstate, _j(b))
    tstate, tm = tstep(tstate, _t(b))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    _params_close(tstate["params"], jstate["params"])
    _, one = _train_pair(jcfg, tcfg, 1.0)
    _, single = _states(jparams)
    _, m1 = one(single, _t(b))
    assert abs(float(m1["loss"]) - float(tm["loss"])) <= 1e-5


def test_audio_gradients_are_the_same_bits_twice_and_on_either_backend():
    """At 4 threads: the dense codebook table's gradient (4 x 128 x 4
    lookups) has the same bits on three runs (an indexed read's
    accumulating ``index_put_`` summed a row's repeats in a varying order
    here); under ``hash_full`` the kernel backend's loss and codebook
    gradient are the same bits twice and the ``gather`` backend's."""
    from repro_torch.nn.module import value_and_grad
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        for kind, leaf in (("dense", ("table",)), ("hash_full", ("decoder", "codebooks"))):
            cfg = _port_cfg(AUDIO, kind)
            gather = dataclasses.replace(cfg, embedding=dataclasses.replace(
                cfg.embedding, lookup_impl="gather"))
            params = t_lm.init_lm(torch.Generator().manual_seed(3), cfg)
            rng = np.random.default_rng(4)
            toks = rng.integers(0, cfg.vocab_size, (4, 129, cfg.n_codebooks)).astype(np.int32)
            b = _t({"tokens": toks[:, :-1], "labels": toks[:, 1:]})
            runs = []
            for c in (cfg, cfg, gather if kind == "hash_full" else cfg):
                loss, g = value_and_grad(lambda p: t_lm.lm_loss(p, b, c), params)
                g = g["embed"]
                for k in leaf:
                    g = g[k]
                runs.append((float(loss), g))
            assert runs[0][0] == runs[1][0] == runs[2][0], kind
            assert all(torch.equal(runs[0][1], g) for _, g in runs[1:]), kind
    finally:
        torch.set_num_threads(threads)
