"""Milliseconds a unit in the whole backward pass (``nn/module.py``
``value_and_grad``, stage ``backward``)."""

from perfbench.metrics._stage import stage_ms


def read(ctx: dict):
    return stage_ms(ctx, "backward")
