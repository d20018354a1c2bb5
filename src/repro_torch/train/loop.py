"""Training loop with straggler monitoring and step fences (counterpart of
``repro/train/loop.py``).

  * straggler monitor: per-step wall-time EWMA; a step slower than
    ``straggler_factor`` x the EWMA is counted;
  * step fences: ``fence(step)`` runs every ``fence_every`` completed steps
    and may raise ``FenceInterrupt`` to stop at a step boundary.

Checkpointing and auto-resume come with ``train/checkpoint.py``; until then
``ckpt=`` raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

CKPT_SLICE = "the loop-and-front-door slice (ROADMAP A.10)"


class FenceInterrupt(Exception):
    """Raised by a step-fence callback to stop the loop at a step boundary;
    ``LoopResult.interrupted_at`` is then the number of completed steps."""


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
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


def run_training(train_step: Callable, state: Any, data_iter, loop_cfg: LoopConfig,
                 ckpt=None, to_device: Callable = lambda b: b,
                 on_metrics: Optional[Callable[[int, Dict], None]] = None,
                 fence: Optional[Callable[[int], None]] = None) -> LoopResult:
    """Runs ``loop_cfg.total_steps`` steps of ``train_step`` on batches from
    ``data_iter.next_batch()``.  A step's time is taken on the host clock
    and ends when its loss is read back, which synchronises the device."""
    if ckpt is not None:
        raise NotImplementedError(f"checkpointing is not ported yet; it comes "
                                  f"with {CKPT_SLICE}")
    losses, step_times = [], []
    stragglers = 0
    interrupted_at = None
    ewma = None
    try:
        for step in range(loop_cfg.total_steps):
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
    finally:
        if hasattr(data_iter, "close"):
            data_iter.close()
    return LoopResult(state=state, losses=losses, step_times=step_times,
                      stragglers=stragglers, resumed_from=None,
                      interrupted_at=interrupted_at)
