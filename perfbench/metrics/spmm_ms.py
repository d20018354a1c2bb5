"""Milliseconds a unit in the GCN layers' sparse products (``models/gnn.py`` through
``graph/csr.py``, stage ``spmm``), forward only: their backward runs
inside ``backward``."""

from perfbench.metrics._stage import stage_ms


def read(ctx: dict):
    return stage_ms(ctx, "spmm")
