"""Port parity for the LM training path of slice 2: the token pipeline,
AdamW and its schedule, the train step, the loop and the front door,
against the JAX package on the CPU.

The model is ``reduced(get_config("qwen1.5-0.5b"))`` with the JAX
package's ``init_lm`` draw carried across (``params_from_jax``); batches
come from ``TokenStream``, which is numpy in both packages and must give
the same bits.  The port trains through the flash wrapper and the kernel
decode backend (their plain versions here), JAX through ``attn_impl="xla"``
and the one-hot decode.  Bounds: one AdamW update 1e-6; three training
steps at the full learning rate (1e-3, warm-up of one step) 1e-5 on each
loss and on the trained codebooks (f32 matmuls in another order, moved by
three updates; measured at most 1e-6).  TF32 is off.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import TokenStream as JTokenStream
from repro.data import TokenStreamConfig as JTokenStreamConfig
from repro.data import cooccurrence_matrix as j_cooc
from repro.optim import adamw as j_adamw
from repro.optim import schedule as j_schedule
from repro.train.step import TrainHyper as JTrainHyper
from repro.train.step import init_train_state as j_init_train_state
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.data import TokenStream, TokenStreamConfig, cooccurrence_matrix
from repro_torch.device import disable_tf32
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as t_launch
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import schedule as t_schedule
from repro_torch.train import (FenceInterrupt, LoopConfig, TrainHyper,
                               make_train_step, run_training)

disable_tf32()

ARCH = "qwen1.5-0.5b"


def test_token_stream_and_cooccurrence_bitwise():
    kw = dict(vocab_size=300, seq_len=40, batch_size=3, seed=4)
    js, ts = JTokenStream(JTokenStreamConfig(**kw)), TokenStream(TokenStreamConfig(**kw))
    for _ in range(3):
        jb, tb = js.next_batch(), ts.next_batch()
        for k in ("tokens", "labels"):
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])
    assert js.state_dict() == ts.state_dict()
    ja = j_cooc(JTokenStream(JTokenStreamConfig(**kw)), 2, projection_dim=64)
    ta = cooccurrence_matrix(TokenStream(TokenStreamConfig(**kw)), 2, projection_dim=64)
    np.testing.assert_array_equal(ja, ta)


@pytest.mark.parametrize("step", [0, 5, 99, 100, 150, 2000])
def test_linear_warmup_cosine_matches_jax(step):
    j = float(j_schedule.linear_warmup_cosine(step, 100, 1000))
    assert abs(t_schedule.linear_warmup_cosine(step, 100, 1000) - j) <= 1e-6


@pytest.mark.parametrize("clip", [None, 0.5])
def test_one_adamw_update_matches_jax(clip):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "blk": {"b": rng.standard_normal(5).astype(np.float32),
                      "codes_buf": np.arange(6, dtype=np.uint32)[:, None]}}
    grads = {"w": rng.standard_normal((6, 5)).astype(np.float32),
             "blk": {"b": rng.standard_normal(5).astype(np.float32),
                     "codes_buf": np.zeros((6, 1), np.uint32)}}
    cfg_kw = dict(lr=1e-2, weight_decay=0.01, clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = j_adamw.adamw_init(jp)
    for _ in range(2):        # two updates: the second reads nonzero moments
        jp, jstate = j_adamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads), jstate,
                                          j_adamw.AdamWConfig(**cfg_kw), lr_scale=0.5)
    tp = params_from_jax(params, device="cpu")
    tstate = t_adamw.adamw_init(tp)
    tg = params_from_jax(grads, device="cpu")
    for _ in range(2):
        tp, tstate = t_adamw.adamw_update(tp, tg, tstate, t_adamw.AdamWConfig(**cfg_kw),
                                          lr_scale=0.5)
    assert tstate["step"] == int(jstate["step"]) == 2
    for key in ("w",):
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tstate["mu"][key].numpy(), np.asarray(jstate["mu"][key]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tstate["nu"][key].numpy(), np.asarray(jstate["nu"][key]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp["blk"]["b"].numpy(), np.asarray(jp["blk"]["b"]),
                               rtol=1e-6, atol=1e-6)
    assert tstate["mu"]["blk"]["codes_buf"] is None
    np.testing.assert_array_equal(tp["blk"]["codes_buf"].numpy(), [[0], [1], [2], [3], [4], [5]])


def _jax_and_port(microbatches):
    jcfg = j_reduced(j_get_config(ARCH))
    tcfg = reduced(get_config(ARCH, attn_impl="flash"))
    tcfg = dataclasses.replace(tcfg, embedding=dataclasses.replace(
        tcfg.embedding, lookup_impl="pallas"))
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jstate["params"], device="cpu")
    tstate = {"params": params, "opt": t_adamw.adamw_init(params), "step": 0}
    jhyper = JTrainHyper(warmup_steps=1, total_steps=3, microbatches=microbatches)
    thyper = TrainHyper(warmup_steps=1, total_steps=3, microbatches=microbatches)
    return (jcfg, jstate, jax.jit(j_make_train_step(jcfg, jhyper)),
            tcfg, tstate, make_train_step(tcfg, thyper))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_training_steps_match_jax(microbatches):
    jcfg, jstate, jstep, tcfg, tstate, tstep = _jax_and_port(microbatches)
    stream = TokenStream(TokenStreamConfig(vocab_size=jcfg.vocab_size, seq_len=32,
                                           batch_size=4, seed=1))
    jl, tl = [], []
    for _ in range(3):
        b = stream.next_batch()
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert tstate["step"] == 3
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5)
    assert tl[2] < tl[0]                           # it trains
    cb = tstate["params"]["embed"]["decoder"]["codebooks"].numpy()
    np.testing.assert_allclose(cb, np.asarray(jstate["params"]["embed"]["decoder"]["codebooks"]),
                               rtol=0, atol=1e-5)


class _Stream:
    def __init__(self):
        self.closed = False

    def next_batch(self):
        return {"x": 1}

    def close(self):
        self.closed = True


def test_loop_counts_stragglers_and_stops_at_a_fence():
    import time
    delays = iter([0.01, 0.01, 0.2, 0.01, 0.01, 0.01])

    def step(state, batch):
        time.sleep(next(delays))
        return state + 1, {"loss": torch.tensor(float(state))}

    def fence(i):
        if i == 3:
            raise FenceInterrupt()

    data = _Stream()
    res = run_training(step, 0, data, LoopConfig(total_steps=6), fence=fence)
    assert res.interrupted_at == 4 and res.state == 4 and res.losses == [0, 1, 2, 3]
    assert res.stragglers == 1 and data.closed


def test_launcher_runs_tiny_on_cpu(capsys, tmp_path):
    res = t_launch.main(["--preset", "tiny", "--steps", "2", "--device", "cpu"])
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    out = capsys.readouterr().out
    assert "[encode] codes (512, 1)" in out and "[done] steps=2" in out
    # --ckpt-dir: 1 step, then a second launch resumes and takes step 2,
    # bit for bit the straight run's
    ck = ["--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    first = t_launch.main(["--steps", "1"] + ck)
    second = t_launch.main(["--steps", "2"] + ck)
    assert second.resumed_from == 1 and first.losses + second.losses == res.losses
    assert "resumed_from=1" in capsys.readouterr().out
