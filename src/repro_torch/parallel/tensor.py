"""Tensor parallelism, FSDP and the LM's step across ranks, spelled out
(the port's counterpart of what XLA's partitioner inserts for the JAX
package's sharded step).

Each rank holds its blocks of the params (``policy.shard_tree`` under
``policy.params_shardings``).  A ``ShardPlan`` is the step's view of that
layout, and the model code calls it where blocks change hands:

  * ``view`` (FSDP): a leaf's block all-gathered over its data axes before
    use (cast to the compute dtype first where the model casts it); its
    backward sums the gradient over the ranks that saw other data and keeps
    this rank's block (a reduce-scatter), so the optimizer steps blocks;
  * ``enter`` (Megatron's f): identity forward, the gradient summed over
    ``model`` backward, before a column-parallel product;
  * ``exit`` (Megatron's g): the partial sums over ``model`` forward,
    identity backward, after a row-parallel product;
  * ``split``: this rank's slice of a replicated tensor forward, the
    slices gathered backward (a replicated bias of a split product);
  * ``stack``: every model rank's tensor stacked forward, this rank's slot
    of the gradient backward (the vocab-parallel loss's statistics);
  * ``reduce``: the sum over ``model`` forward and backward, for partials
    whose consumers are themselves split (the SSM's gated RMSNorm: each
    rank's sum of squares over its channels scales its own channels).

Every sum across ranks is an ``all_gather`` (or an ``all_to_all``)
followed by a sum in rank order: every rank that holds a block gets the
same bits, and replicated leaves stay equal on every rank.  The mesh's
``stats`` count the bytes this rank receives, by axes and by operation.

The plan is passed down the model's calls explicitly: a checkpointed
layer's recompute runs on autograd's device thread, where a thread-local
context would not be seen.  ``use_plan`` makes it the one ``lm_loss``
picks up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.nn.module import leaves_with_path, map_tree
from repro_torch.parallel.sharding import Mesh, Spec, _axes_tuple

MODEL = "model"
# leaves the model casts to the compute dtype at their use: their FSDP
# gather moves that dtype (the SSM's projections under an "ssm" key)
_CAST = ("w_gate", "w_up", "w_down", "head")
_SSM_CAST = ("w_z", "w_x", "w_b", "w_c", "w_dt", "w_out")


def ordered_sum(parts):
    """parts[0] + parts[1] + ..., in that order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def all_reduce(x: torch.Tensor, mesh: Mesh, axes, name: str = "all_reduce") -> torch.Tensor:
    """The sum of ``x`` over the line of ``axes``, in rank order: the same
    bits on every rank of the line."""
    if mesh.axes_size(axes) == 1:
        return x
    return ordered_sum(mesh.all_gather(x, axes, name=name))


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of dim ``dim`` of the sum of ``x`` over the line of
    ``axes``: one ``all_to_all`` (block j to the line's rank j), then the
    blocks received summed in rank order."""
    n = mesh.axes_size(axes)
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    got = mesh.all_to_all(xm, axes, name="reduce_scatter")
    got = got.reshape((n, xm.shape[0] // n) + tuple(xm.shape[1:]))
    return ordered_sum(list(got.unbind(0))).movedim(0, dim)


def block(x: torch.Tensor, mesh: Mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of dim ``dim`` of ``x`` over the line of ``axes``."""
    n = mesh.axes_size(axes)
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * size, size)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x.contiguous(), mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = ctx.mesh.all_gather(g.contiguous(), ctx.axes, name="split_grad")
        return torch.cat(parts, dim=ctx.dim), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return all_reduce(x.contiguous(), mesh, axes, name="reduce")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axes, name="reduce_grad"), None, None


class _Stack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.index = mesh.index(axes)
        return torch.stack(mesh.all_gather(x.contiguous(), axes, name="stack"))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index], None, None


class _View(torch.autograd.Function):
    """FSDP: gather ``x``'s blocks of dim ``dim`` over ``fsdp`` (after a cast
    to ``cast``); backward: the gradient summed over ``grad_axes`` and cut
    back to this rank's block, in ``x``'s dtype."""

    @staticmethod
    def forward(ctx, x, mesh, dim, fsdp, grad_axes, cast):
        ctx.mesh, ctx.dim, ctx.fsdp, ctx.grad_axes = mesh, dim, fsdp, grad_axes
        ctx.dtype = x.dtype
        y = x.to(cast) if cast is not None else x
        if fsdp:
            y = torch.cat(mesh.all_gather(y, fsdp, name="fsdp_gather"), dim=dim)
        return y

    @staticmethod
    def backward(ctx, g):
        mesh, fsdp, grad_axes = ctx.mesh, ctx.fsdp, ctx.grad_axes
        g = g.to(ctx.dtype)
        if fsdp:
            if set(fsdp) <= set(grad_axes):
                g = reduce_scatter(g, mesh, fsdp, ctx.dim)
            elif not set(fsdp) & set(grad_axes):
                g = block(g, mesh, fsdp, ctx.dim).contiguous()
            else:
                raise NotImplementedError(f"FSDP over {fsdp} with gradients summed over "
                                          f"{grad_axes}")
        rest = tuple(a for a in grad_axes if a not in fsdp)
        if rest:
            g = all_reduce(g.contiguous(), mesh, rest, name="grad_all_reduce")
        return g, None, None, None, None, None


@dataclasses.dataclass
class ShardPlan:
    """One rank's layout of the LM's step: the live ``mesh``, the param
    ``specs`` (``policy.params_shardings``), ``grad_axes`` (the mesh axes
    the batch splits over: gradients sum over them), whether the model
    axis carries tensor parallelism, the compute dtype the FSDP gather of a
    cast leaf moves, and the activation ``rules`` (``policy.rules_for``)."""

    mesh: Mesh
    specs: Dict[str, Any]
    grad_axes: Tuple[str, ...]
    tp: bool
    compute_dtype: torch.dtype
    rules: Any = None

    @property
    def dp(self) -> int:
        """The batch's shard count."""
        return self.mesh.axes_size(self.grad_axes)

    @property
    def tp_size(self) -> int:
        return self.mesh.axes_size(MODEL) if self.tp else 1

    @property
    def tp_index(self) -> int:
        return self.mesh.index(MODEL) if self.tp else 0

    # ---- FSDP ----
    def _fsdp_dim(self, spec: Spec):
        """(dim, axes) of the one dim of ``spec`` that FSDP gathers (the
        model axis is TP's under a TP plan), or (0, ())."""
        found = []
        for d, axes in enumerate(spec):
            axes = tuple(a for a in _axes_tuple(axes) if self.mesh.shape[a] > 1)
            if axes and not (self.tp and axes == (MODEL,)):
                found.append((d, axes))
        if len(found) > 1:
            raise NotImplementedError(f"FSDP over more than one dim of {spec}")
        return found[0] if found else (0, ())

    def view(self, x: torch.Tensor, spec: Spec, cast: Optional[torch.dtype] = None):
        """``x`` (this rank's block) as the model computes with it: whole on
        its FSDP dim, still split on the model axis under TP."""
        if not x.is_floating_point():
            return x
        dim, fsdp = self._fsdp_dim(spec)
        if cast == x.dtype:
            cast = None
        if not fsdp and not (x.requires_grad and self.grad_axes):
            return x if cast is None else x.to(cast)
        return _View.apply(x, self.mesh, dim, fsdp, tuple(self.grad_axes), cast)

    def view_tree(self, tree, specs):
        """``view`` over a param (sub)tree, each leaf cast where the model
        casts it (attention and MLP weights, the head)."""
        def one(path, x, spec):
            if x is None:
                return None
            cast = self.compute_dtype if (path[-1] in _CAST or
                                          (path[-1] == "w" and "attn" in path) or
                                          (path[-1] in _SSM_CAST and "ssm" in path)) else None
            return self.view(x, spec, cast)
        return map_tree(one, tree, specs)

    # ---- tensor parallelism ----
    def enter(self, x):
        return _Enter.apply(x, self.mesh, MODEL) if self.tp_size > 1 else x

    def exit(self, x):
        return _Exit.apply(x, self.mesh, MODEL) if self.tp_size > 1 else x

    def split(self, x, dim: int):
        return _Split.apply(x, self.mesh, MODEL, dim) if self.tp_size > 1 else x

    def stack(self, x):
        return _Stack.apply(x, self.mesh, MODEL) if self.tp_size > 1 else x[None]

    def reduce(self, x):
        return _Reduce.apply(x, self.mesh, MODEL) if self.tp_size > 1 else x

    # ---- the step's sums ----
    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the batch's shards, in rank order (no gradient)."""
        return all_reduce(x.detach().contiguous(), self.mesh, self.grad_axes, name="loss")

    def grad_norm(self, grads) -> torch.Tensor:
        """The global norm of the gradients held as blocks: each block's sum
        of squares counted on the one rank at coordinate 0 of every axis
        the block is not split over, the ranks' partials summed in rank
        order."""
        coords = self.mesh.coords
        part = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        for path, g in leaves_with_path(grads):
            spec = self.specs
            for k in path:
                spec = spec[k]
            used = {a for axes in spec for a in _axes_tuple(axes)}
            if all(coords[a] == 0 for a in self.mesh.axis_names if a not in used):
                part = part + g.float().square().sum()
        total = all_reduce(part[None], self.mesh, self.mesh.axis_names, name="grad_norm")
        return torch.sqrt(total[0])


_ACTIVE = threading.local()


@contextlib.contextmanager
def use_plan(plan: Optional[ShardPlan]):
    """Make ``plan`` the one ``lm_loss`` of this thread runs under."""
    prev = getattr(_ACTIVE, "plan", None)
    _ACTIVE.plan = plan
    try:
        yield
    finally:
        _ACTIVE.plan = prev


def active_plan() -> Optional[ShardPlan]:
    return getattr(_ACTIVE, "plan", None)


def layer_specs(specs):
    """The specs of one layer of stacked leaves (the leading dim dropped)."""
    return map_tree(lambda _, s: None if s is None else tuple(s[1:]), specs)
