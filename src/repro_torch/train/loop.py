"""Training loop with fault tolerance, straggler monitoring and step fences
(counterpart of ``repro/train/loop.py``).

  * auto-resume: on start, restore the newest checkpoint (params,
    optimizer, step counters, data-pipeline state) and continue;
  * periodic and final checkpoints (async, atomic);
  * straggler monitor: per-step wall-time EWMA; a step slower than
    ``straggler_factor`` x the EWMA is counted;
  * step fences: ``fence(step)`` runs every ``fence_every`` completed steps
    and may raise ``FenceInterrupt`` to stop at a step boundary; no final
    checkpoint is written then.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from repro_torch.train.checkpoint import CheckpointManager


class FenceInterrupt(Exception):
    """Raised by a step-fence callback to stop the loop at a step boundary;
    ``LoopResult.interrupted_at`` is then the number of completed steps."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 200
    log_every: int = 20
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1
    fence_every: int = 1


@dataclasses.dataclass
class LoopResult:
    state: Any
    losses: list
    step_times: list
    stragglers: int
    resumed_from: Optional[int]
    interrupted_at: Optional[int] = None


def _save(ckpt: CheckpointManager, step: int, state, data_iter,
          extra_base: Optional[Dict], topology: Optional[Dict]) -> None:
    extra = dict(extra_base or {})
    if hasattr(data_iter, "state_dict"):
        extra["data"] = data_iter.state_dict()
    ckpt.save(step, state, extra, topology=topology)


def run_training(train_step: Callable, state: Any, data_iter, loop_cfg: LoopConfig,
                 ckpt: Optional[CheckpointManager] = None,
                 to_device: Callable = lambda b: b,
                 on_metrics: Optional[Callable[[int, Dict], None]] = None,
                 extra_base: Optional[Dict] = None,
                 fence: Optional[Callable[[int], None]] = None,
                 topology: Optional[Dict] = None) -> LoopResult:
    """Runs ``train_step`` from the newest checkpoint's step (or 0) to
    ``loop_cfg.total_steps`` on batches from ``data_iter.next_batch()``.
    A step's time is taken on the host clock and ends when its loss is read
    back, which synchronises the device.

    ``extra_base``: JSON-able dict merged into every checkpoint's ``extra``
    (e.g. the runtime spec).  ``topology``: JSON-able shard layout stamped
    into every checkpoint and checked on auto-resume."""
    resumed_from = None
    start_step = 0
    if ckpt is not None:
        restored = ckpt.restore_latest(state, expect_topology=topology)
        if restored is not None:
            start_step, state, extra = restored
            resumed_from = start_step
            if hasattr(data_iter, "load_state_dict") and "data" in extra:
                data_iter.load_state_dict(extra["data"])
    losses, step_times = [], []
    stragglers = 0
    interrupted_at = None
    ewma = None
    try:
        for step in range(start_step, loop_cfg.total_steps):
            batch = to_device(data_iter.next_batch())
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])   # blocks: device sync = honest timing
            dt = time.perf_counter() - t0
            step_times.append(dt)
            losses.append(loss)
            if ewma is None:
                ewma = dt
            else:
                if dt > loop_cfg.straggler_factor * ewma:
                    stragglers += 1
                ewma = (1 - loop_cfg.ewma_alpha) * ewma + loop_cfg.ewma_alpha * dt
            if on_metrics and step % loop_cfg.log_every == 0:
                on_metrics(step, {"loss": loss, "step_time": dt, "ewma": ewma})
            if fence is not None and (step + 1) % loop_cfg.fence_every == 0:
                try:
                    fence(step)
                except FenceInterrupt:
                    interrupted_at = step + 1
                    break
            if ckpt is not None and (step + 1) % loop_cfg.ckpt_every == 0:
                _save(ckpt, step + 1, state, data_iter, extra_base, topology)
        if ckpt is not None and interrupted_at is None:
            _save(ckpt, loop_cfg.total_steps, state, data_iter, extra_base, topology)
            ckpt.wait()
    finally:
        # a prefetching iterator owns a producer thread: stop it whether the
        # loop finished or raised
        if hasattr(data_iter, "close"):
            data_iter.close()
    return LoopResult(state=state, losses=losses, step_times=step_times,
                      stragglers=stragglers, resumed_from=resumed_from,
                      interrupted_at=interrupted_at)
