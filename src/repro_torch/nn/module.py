"""Functional module conventions (counterpart of ``repro/nn/module.py``).

Parameters are nested dicts of tensors.  Every layer exposes
``init_<layer>(generator, ...) -> params`` and ``<layer>(params, x, ...)``.
Non-trainable buffers live under keys ending in ``_buf`` (packed codes,
frozen codebooks of the light decoder); they and non-float leaves are
masked out of the optimizer (``trainable_mask``).  Params are stored f32
("master" copies) and cast at the use site.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from repro_torch.stages import stage

Params = Dict[str, Any]


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None
               ) -> torch.Tensor:
    """LeCun-normal (fan-in) initialisation by default."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(*shape, generator=generator,
                       device=generator.device) * s


def leaves_with_path(tree: Params, prefix: Tuple[str, ...] = ()
                     ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs in insertion order; ``None`` leaves skipped."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves_with_path(v, prefix + (k,))
        elif v is not None:
            yield prefix + (k,), v


def map_tree(fn, tree: Params, *others: Params, prefix: Tuple[str, ...] = ()) -> Params:
    """``fn(path, leaf, *other_leaves)`` over matching nested dicts."""
    out = {}
    for k, v in tree.items():
        rest = [o[k] if o is not None else None for o in others]
        if isinstance(v, dict):
            out[k] = map_tree(fn, v, *rest, prefix=prefix + (k,))
        else:
            out[k] = fn(prefix + (k,), v, *rest)
    return out


def is_trainable(path: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    """False for ``*_buf`` buffers and non-float leaves."""
    if any(k.endswith("_buf") for k in path):
        return False
    return leaf.is_floating_point()


def trainable_mask(params: Params) -> Params:
    """Same-shaped tree of bools: True for trainable leaves."""
    return map_tree(is_trainable, params)


def param_count(params: Params, trainable_only: bool = False) -> int:
    return sum(leaf.numel() for path, leaf in leaves_with_path(params)
               if not trainable_only or not any(k.endswith("_buf") for k in path))


def param_bytes(params: Params, trainable_only: bool = False) -> int:
    return sum(leaf.numel() * leaf.element_size() for path, leaf in leaves_with_path(params)
               if not trainable_only or not any(k.endswith("_buf") for k in path))


def cast_floats(tree: Params, dtype: torch.dtype) -> Params:
    """The tree with every float leaf cast to ``dtype``; other leaves as
    they are."""
    return map_tree(lambda path, x: x.to(dtype) if torch.is_tensor(x) and x.is_floating_point()
                    else x, tree)


def value_and_grad(fn, params: Params):
    """(fn(params) detached, grads): grads has the params' structure, f32
    tensors on the trainable leaves and None elsewhere.  The stored params
    never require grad: ``fn`` sees detached views of the trainable leaves,
    and ``torch.autograd.grad`` over them raises if one got no gradient, so
    a path that drops a gradient cannot pass unnoticed."""
    paths, leaves = [], []

    def attach(path, p):
        if not is_trainable(path, p):
            return p
        leaf = p.detach().requires_grad_(True)
        paths.append(path)
        leaves.append(leaf)
        return leaf

    value = fn(map_tree(attach, params))
    with stage("backward"):
        gs = dict(zip(paths, torch.autograd.grad(value, leaves)))
    return value.detach(), map_tree(lambda path, p: gs.get(path), params)
