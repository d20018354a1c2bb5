"""Milliseconds a unit in the AdamW update (``optim/adamw.py`` through
``train/step.py``, stage ``optimizer``)."""

from perfbench.metrics._stage import stage_ms


def read(ctx: dict):
    return stage_ms(ctx, "optimizer")
