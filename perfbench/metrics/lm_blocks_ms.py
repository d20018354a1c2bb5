"""Milliseconds a unit in the LM's blocks forward (``models/lm.py``, stage
``blocks``)."""

from perfbench.metrics._stage import stage_ms


def read(ctx: dict):
    return stage_ms(ctx, "blocks")
