"""``repro_torch.train.checkpoint.CheckpointManager`` and the loop's
checkpoint branch (counterparts of ``repro/train/checkpoint.py`` and the
``ckpt=`` branch of ``repro/train/loop.py``), on the CPU.

A round trip is bitwise (f32, bf16, int64 and the integer steps); the
on-disk layout is the JAX package's (``step_XXXXXXXXXX/arrays.npz`` keyed
by slash-joined paths, ``manifest.json``), so the JAX manager reads what
the port writes.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointManager as JManager
from repro_torch.train import (CheckpointManager, FenceInterrupt, LoopConfig,
                               TopologyMismatch, run_training)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g),
                       "half": torch.randn(5, generator=g).to(torch.bfloat16),
                       "codes_buf": torch.arange(6, dtype=torch.int64).reshape(3, 2) * 2**31,
                       "empty": None},
            "opt": {"step": 7, "mu": {"w": torch.randn(3, 4, generator=g), "half": None}},
            "step": 7}


def _assert_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
    else:
        assert a == b


def _jax_template():
    """The state's structure for the JAX manager's restore: numpy leaves of
    the saved shapes (bf16 as its int16 bit pattern, as the port writes it)."""
    return {"params": {"w": np.zeros((3, 4), np.float32), "half": np.zeros(5, np.int16),
                       "codes_buf": np.zeros((3, 2), np.int64)},
            "opt": {"step": np.zeros((), np.int64), "mu": {"w": np.zeros((3, 4), np.float32)}},
            "step": np.zeros((), np.int64)}


@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_round_trip_is_bitwise_and_in_the_jax_layout(tmp_path, reader):
    ck = CheckpointManager(str(tmp_path))
    state = _state()
    path = ck.save(7, state, {"data": {"step": 3}}, topology={"n_shards": 1})
    ck.wait()
    assert os.path.basename(path) == "step_0000000007"
    if reader == "torch":
        template = _state(seed=1)
        template["step"] = template["opt"]["step"] = 0
        step, restored, extra = ck.restore_latest(template, expect_topology={"n_shards": 1})
        _assert_equal(restored, state)
    else:                          # the JAX manager reads what the port wrote
        step, restored, extra = JManager(str(tmp_path)).restore_latest(
            _jax_template(), expect_topology={"n_shards": 1})
        p = state["params"]
        assert np.array_equal(restored["params"]["w"], p["w"].numpy())
        assert np.array_equal(restored["params"]["half"], p["half"].view(torch.int16).numpy())
        assert np.array_equal(restored["params"]["codes_buf"], p["codes_buf"].numpy())
        assert np.array_equal(restored["opt"]["mu"]["w"], state["opt"]["mu"]["w"].numpy())
        assert int(restored["opt"]["step"]) == 7 and int(restored["step"]) == 7
    assert step == 7 and extra == {"data": {"step": 3}}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 7 and manifest["topology"] == {"n_shards": 1}
    assert set(manifest["leaves"]) == {"params/w", "params/half", "params/codes_buf",
                                       "opt/step", "opt/mu/w", "step"}
    assert JManager(str(tmp_path)).read_extra() == {"data": {"step": 3}}


def test_save_copies_the_state_before_the_step_moves_it(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    state = _state()
    before = state["params"]["w"].clone()
    ck.save(1, state)
    state["params"]["w"].add_(1.0)            # the next step, in place
    ck.wait()
    _, restored, _ = ck.restore_latest(_state(seed=2))
    assert torch.equal(restored["params"]["w"], before)


def test_stale_tmp_is_swept_and_never_listed(tmp_path):
    stale = tmp_path / "step_0000000009.tmp"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"half written")
    (tmp_path / "step_0000000004").mkdir()     # no manifest: not a checkpoint
    ck = CheckpointManager(str(tmp_path))
    assert not stale.exists()
    assert ck.list_steps() == [] and ck.latest_step() is None
    assert ck.restore_latest(_state()) is None and ck.read_extra() is None


def test_keep_is_honoured(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 7):
        ck.save(s, _state())
    ck.wait()
    assert ck.list_steps() == [5, 6]


def test_topology_mismatch_raises_before_reading_arrays(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(3, _state(), topology={"n_shards": 1, "batch_size": 64})
    ck.wait()
    os.remove(tmp_path / "step_0000000003" / "arrays.npz")
    with pytest.raises(TopologyMismatch, match="GraphRuntime.rescale"):
        ck.restore(3, _state(), expect_topology={"n_shards": 2, "batch_size": 32})


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, _state())
    ck.wait()
    bad = _state()
    bad["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(1, bad)
    extra = _state()
    extra["params"]["new"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/new"):
        ck.restore(1, extra)


def test_at_most_one_write_outstanding(tmp_path, monkeypatch):
    ck = CheckpointManager(str(tmp_path))
    started, write = [], ck._write

    def slow(*a):
        started.append(time.perf_counter())
        time.sleep(0.2)
        write(*a)
    monkeypatch.setattr(ck, "_write", slow)
    t0 = time.perf_counter()
    ck.save(1, _state())
    ck.save(2, _state())                      # waits for the first write
    assert time.perf_counter() - t0 >= 0.2
    ck.wait()
    assert ck.list_steps() == [1, 2]


class _Counter:
    def __init__(self):
        self.step = 0

    def next_batch(self):
        self.step += 1
        return self.step

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, s):
        self.step = s["step"]


def _step(state, batch):
    state["params"]["w"].add_(float(batch))
    state["step"] += 1
    return state, {"loss": torch.tensor(float(batch))}


def test_loop_saves_resumes_and_skips_the_final_save_after_a_fence(tmp_path):
    cfg = LoopConfig(total_steps=6, ckpt_every=2)
    straight = run_training(_step, _state(), _Counter(), cfg)
    ck = CheckpointManager(str(tmp_path))

    def fence(i):
        if i == 2:
            raise FenceInterrupt()
    cut = run_training(_step, _state(), _Counter(), cfg, ckpt=ck,
                       extra_base={"spec": "x"}, fence=fence, topology={"n_shards": 1})
    ck.wait()
    assert cut.interrupted_at == 3 and ck.list_steps() == [2]
    assert ck.read_extra() == {"spec": "x", "data": {"step": 2}}
    rest = run_training(_step, _state(), _Counter(), cfg, ckpt=ck, topology={"n_shards": 1})
    assert rest.resumed_from == 2
    assert cut.losses[:2] + rest.losses == straight.losses
    assert torch.equal(rest.state["params"]["w"], straight.state["params"]["w"])
    assert ck.list_steps()[-1] == 6 and rest.state["step"] == straight.state["step"]
    with pytest.raises(TopologyMismatch):
        run_training(_step, _state(), _Counter(), cfg, ckpt=ck, topology={"n_shards": 2})
