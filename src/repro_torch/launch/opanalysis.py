"""The dry run's counter (counterpart of ``repro/launch/hloanalysis.py``).

The JAX package reads per-chip totals out of XLA's compiled HLO text.
PyTorch compiles no program to read, so the port counts the ops of one
rank's step as they run: ``OpAnalyzer`` is a ``TorchDispatchMode`` that
sees every aten op of the step (under ``FakeTensorMode``, on tensors
without storage) and keeps the same ``CompAnalysis`` fields:

  flops:      ``torch.utils.flop_counter``'s formulas (matmuls, batched
              matmuls, convolutions, attention); the remat recompute counts
              as it runs (the port runs no scan to weight by a trip count)
  hbm bytes:  each op's operand and result bytes, unfused: views are free
              (as ``_FREE_OPS``), and the indexing ops count as
              ``HLOAnalyzer._op_bytes`` counts them (a read of the window
              and a write of the result; a write of the update twice)
  collective: the virtual mesh's calls (``parallel.sharding.VirtualMesh``)
              through ``_wire_bytes``'s ring model, by JAX's collective names

and the peak of the live storage bytes over the step (``peak_bytes``):
the storages of the step's arguments (``hold``) plus every storage an op
made, each released when its last tensor dies (autograd's saved tensors
keep theirs alive until the backward frees them).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ops that move no bytes: metadata and fresh buffers not yet written
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "detach", "alias", "lift_fresh", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size", "_local_scalar_dense"}
# reads of a window: the window read and the result written (2 x result)
_WINDOW = {"slice", "select", "index", "index_select", "gather", "narrow", "embedding"}
# writes of an update into a buffer: the update read and written (2 x update)
_UPDATE = {"index_put", "index_put_", "scatter", "scatter_", "scatter_add", "scatter_add_",
           "index_add", "index_add_", "slice_scatter", "select_scatter", "index_copy",
           "index_copy_"}


_DEVICE = torch.ops.prim.device.default


@dataclasses.dataclass
class CompAnalysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})


def _wire_bytes(opname: str, result_bytes: float, p: int) -> float:
    """``hloanalysis._wire_bytes``: a ring's bytes per rank for one call
    of ``opname`` whose result holds ``result_bytes`` on a line of ``p``."""
    ring = (p - 1) / p
    if opname == "all-reduce":
        return 2.0 * result_bytes * ring
    if opname == "all-gather":
        return result_bytes * ring
    if opname == "reduce-scatter":
        return result_bytes * (p - 1)
    if opname == "all-to-all":
        return result_bytes * ring
    return float(result_bytes)       # collective-permute


def coll_from_calls(calls: Iterable[Tuple[str, str, int, int]]) -> Dict[str, float]:
    """Wire bytes by collective from a ``VirtualMesh``'s calls."""
    out = {c: 0.0 for c in COLLECTIVES}
    for primitive, _, result_bytes, n in calls:
        out[primitive] += _wire_bytes(primitive, result_bytes, n)
    return out


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _flat_tensors(x, out):
    """The tensors of an op's arguments or results (tensors, and lists and
    tuples of them)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _flat_tensors(y, out)
    return out


class OpAnalyzer(TorchDispatchMode):
    """Counts one rank's step (module docstring).  Enter it inside
    ``FakeTensorMode``; ``hold`` the step's arguments first; read
    ``totals(mesh)`` after."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._composite: Dict[Any, bool] = {}

    # ---- live storage bytes ----
    def _track(self, t: torch.Tensor, finalize: bool = True) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        if finalize:
            weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        n = self._storages.pop(key, 0)
        self.live -= n

    def hold(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live (the step's
        arguments); returns their bytes."""
        before = self.live
        leaves, _ = tree_flatten(tree)
        for t in leaves:
            if isinstance(t, torch.Tensor):
                self._track(t, finalize=False)
        return self.live - before

    # ---- the ops ----
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _DEVICE:               # a tensor's .device read: no op
            return func(*args, **kwargs)
        if self._is_composite(func):
            # a composite op (under inference mode no autograd key decomposes
            # it): run its decomposition, whose ops come back here
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in self._flop_registry:
            self.flops += float(self._flop_registry[packet](*args, **kwargs, out_val=out))
        outs = _flat_tensors(out, [])
        self.hbm_bytes += self._op_bytes(func, args, kwargs, outs)
        for t in outs:
            self._track(t)
        return out

    def _is_composite(self, func) -> bool:
        known = self._composite.get(func)
        if known is None:
            known = (func._overloadpacket not in self._flop_registry
                     and func.namespace == "aten"
                     and torch._C._dispatch_has_kernel_for_dispatch_key(
                         func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))
            self._composite[func] = known
        return known

    def _op_bytes(self, func, args, kwargs, outs) -> float:
        name = func._overloadpacket.__name__
        if func.is_view or name in _FREE:
            return 0.0
        result = float(sum(_nbytes(t) for t in outs))
        if name in _WINDOW:
            return 2.0 * result
        ins = _flat_tensors(list(kwargs.values()), _flat_tensors(args, []))
        if name in _UPDATE or name in ("copy_", "copy"):
            # the update (or copy source) is the op's last tensor operand
            return 2.0 * _nbytes(ins[-1])
        return result + float(sum(_nbytes(t) for t in ins))

    def totals(self, mesh=None) -> CompAnalysis:
        """The step's ``CompAnalysis``: the counted flops and bytes, the
        collectives from ``mesh``'s recorded calls."""
        coll = coll_from_calls(mesh.calls) if mesh is not None else \
            {c: 0.0 for c in COLLECTIVES}
        return CompAnalysis(flops=self.flops, hbm_bytes=self.hbm_bytes, coll=coll)

    @property
    def peak_bytes(self) -> int:
        return self.peak

