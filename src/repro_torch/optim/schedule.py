"""Learning-rate schedules (counterpart of ``repro/optim/schedule.py``):
the multiplicative scale of ``AdamWConfig.lr`` for an integer step, as a
Python float.  The LM train step uses ``linear_warmup_cosine``."""

from __future__ import annotations

import math


def constant_schedule(step: int) -> float:
    return 1.0


def cosine_schedule(step: int, total_steps: int, final_frac: float = 0.1) -> float:
    t = min(max(step / max(total_steps, 1), 0.0), 1.0)
    return final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t))


def linear_warmup_cosine(step: int, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1) -> float:
    if step < warmup_steps:
        return (step + 1.0) / max(warmup_steps, 1)   # step 0 trains too
    t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
    return final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi * t))
