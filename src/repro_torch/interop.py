"""Bring the JAX package's parameters across as port parameters.

``params_from_jax`` takes the pytree of ``repro.models.gnn.init_gnn`` or
``repro.models.lm.init_lm`` (or a runtime's / train state's ``params``) as
numpy arrays — nested dicts of arrays, the packed ``embed.codes_buf`` as
uint32 — and returns the same tree as tensors on ``device``.  The layouts
are the same in both packages (``x @ w`` with w of shape (in, out); the
LM's ``blocks`` stacked on a leading layer axis), so nothing is transposed;
the code words become int64 tensors holding the uint32 bit patterns;
0-d leaves (GIN's ``eps1`` / ``eps2``) stay 0-d, nested dicts (GIN's
``mlp1`` / ``mlp2``) stay nested, and ``None`` leaves (an AdamW state's
moments of a ``*_buf`` buffer) stay ``None``.

``cache_state_from_jax`` takes a JAX ``CacheState`` (or any object or dict
with its eight fields, as numpy arrays) and returns the port's, so both
packages can start from one cache state; ``params_from_jax`` converts a
train state's ``"cache"`` entry the same way.

``lm_cache_from_jax`` takes a JAX ``LMCache`` (``pos``, ``kv_k``, ``kv_v``
as numpy; the same stacked (sites, B, S_max, K, Dh) layout) and returns the
port's, so a decode step can start from JAX's own state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.backend import CacheState
from repro_torch.core.codes import from_uint32
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import LMCache


def cache_state_from_jax(state, device: DeviceLike = None) -> CacheState:
    dev = resolve_device(device)
    get = state.get if isinstance(state, dict) else lambda f: getattr(state, f)
    return CacheState(*(torch.from_numpy(np.array(get(f.name))).to(dev)
                        for f in dataclasses.fields(CacheState)))


def lm_cache_from_jax(cache, device: DeviceLike = None) -> LMCache:
    dev = resolve_device(device)
    get = cache.get if isinstance(cache, dict) else lambda f: getattr(cache, f, None)
    if get("ssm_state") is not None or get("conv") is not None:
        raise NotImplementedError("an LMCache with ssm state comes with the ssm family "
                                  "(ROADMAP A.18)")
    return LMCache(pos=int(np.asarray(get("pos"))),
                   kv_k=torch.from_numpy(np.array(get("kv_k"))).to(dev),
                   kv_v=torch.from_numpy(np.array(get("kv_v"))).to(dev))


def params_from_jax(tree: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    dev = resolve_device(device)

    def convert(key: str, value):
        if value is None:            # a train state's moments of a buffer
            return None
        if key == "cache":
            return cache_state_from_jax(value, dev)
        if isinstance(value, dict):
            return {k: convert(k, v) for k, v in value.items()}
        arr = np.asarray(value)
        if key == "codes_buf":
            return from_uint32(arr).to(dev)
        return torch.from_numpy(np.array(arr)).to(dev)

    return {k: convert(k, v) for k, v in tree.items()}
