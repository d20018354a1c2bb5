"""Milliseconds a unit in the decoder MLP (``core/decoder.py`` ``apply_mlp``, stage
``mlp``)."""

from perfbench.metrics._stage import stage_ms


def read(ctx: dict):
    return stage_ms(ctx, "mlp")
