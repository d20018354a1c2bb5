"""GPipe pipeline parallelism across ranks (counterpart of
``repro/parallel/pipeline.py``).

``gpipe(stage_fn, stage_params, microbatches, mesh, axis)`` runs ``n_stages
= mesh.axes_size(axis)`` pipeline stages, one a rank of ``axis``'s line:
each tick, every stage applies its layers to its live microbatch and the
result moves to the next stage (``Mesh.shift``), the circular schedule of
``n_micro + n_stages - 1`` ticks (bubble (S - 1) / (M + S - 1)).  The move
is differentiable (its backward moves the gradient back one stage).  Every
stage runs the same operations on every tick (the first stage's input and
the last stage's outputs are chosen with ``torch.where``, as the JAX
version chooses them), so every rank's backward meets the moves in the same
order.  The last stage's outputs reach every rank through a sum over the
line, in rank order (the others contribute zeros).

``pipeline_reference`` runs every stage on every microbatch in turn in one
process.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.nn.module import map_tree
from repro_torch.parallel.tensor import all_reduce


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.shift(x, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift(g.contiguous(), ctx.axis, -1), None, None


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous(), mesh, axis, name="pipeline_out")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gpipe(stage_fn: Callable, stage_params, microbatches: torch.Tensor, mesh,
          axis: str = "model") -> torch.Tensor:
    """Pipeline-parallel apply on this rank's stage.

    stage_fn(params_one_stage, x (mb, ...)) -> (mb, ...) of x's shape
    stage_params: this rank's stage's params (no stage dim)
    microbatches: (M, mb, ...), the same on every rank of the line
    Returns (M, mb, ...) on every rank: every stage run on every microbatch
    in order."""
    n_stages = mesh.axes_size(axis)
    stage = mesh.index(axis)
    M = microbatches.shape[0]
    mb_shape = microbatches.shape[1:]
    zeros = microbatches.new_zeros(mb_shape)
    first = torch.tensor(stage == 0, device=microbatches.device)
    last = torch.tensor(stage == n_stages - 1, device=microbatches.device)
    live, outputs = zeros, [None] * M
    for t in range(M + n_stages - 1):
        inject = microbatches[t] if t < M else zeros
        y = stage_fn(stage_params, torch.where(first, inject, live))
        emit = t - (n_stages - 1)
        if emit >= 0:
            outputs[emit] = torch.where(last, y, zeros)
        live = _Shift.apply(y, mesh, axis)
    return _SumOut.apply(torch.stack(outputs), mesh, axis)


def pipeline_reference(stage_fn: Callable, stage_params, microbatches: torch.Tensor
                       ) -> torch.Tensor:
    """Every stage on every microbatch in order; ``stage_params`` have a
    leading stage dim."""
    leaves = []
    map_tree(lambda _, t: leaves.append(t), stage_params)
    n_stages = leaves[0].shape[0]
    outs = []
    for x in microbatches.unbind(0):
        for s in range(n_stages):
            x = stage_fn(map_tree(lambda _, p: p[s], stage_params), x)
        outs.append(x)
    return torch.stack(outs)
