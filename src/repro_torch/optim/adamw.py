"""AdamW (Loshchilov & Hutter 2018), counterpart of ``repro/optim/adamw.py``.

Decoupled weight decay, optional global-norm clip, bias correction from the
integer step.  Buffer leaves (``*_buf``) and non-float leaves are masked
out: they carry no moments and are never updated.

Unlike the JAX version, ``adamw_update`` updates the params and moments in
place (under ``torch.no_grad``) and returns the same tensors: at
qwen1.5-0.5b's 467 M trainable parameters a functional update would hold a
second f32 copy (1.9 GB) of the params and of each moment.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.nn.module import is_trainable, leaves_with_path, map_tree

@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = None
    # Storage type of the moments in the JAX package's configs ("bfloat16"
    # halves optimizer memory there).  The port keeps f32 moments, as the
    # JAX package's GNN state does; the field makes specs round-trip.
    moments_dtype: str = "float32"


def adamw_init(params) -> dict:
    """f32 moments for the trainable leaves, None elsewhere."""
    def zeros(path, p):
        return torch.zeros_like(p, dtype=torch.float32) if is_trainable(path, p) else None

    return {"step": 0, "mu": map_tree(zeros, params), "nu": map_tree(zeros, params)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of float tensors, in f32."""
    sq = [t.float().square().sum() for t in tensors
          if t is not None and t.is_floating_point()]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale: float = 1.0):
    """Returns (params, state), both updated in place.  ``grads`` has the
    params' structure; its entries for masked leaves are ignored."""
    step = state["step"] + 1
    lr = cfg.lr * lr_scale
    trainable = [(path, p) for path, p in leaves_with_path(params) if is_trainable(path, p)]

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    gs = [at(grads, path) for path, _ in trainable]
    if cfg.clip_norm is not None:
        gn = global_norm(gs)
        scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    else:
        scale = None
    b1t = 1.0 - cfg.b1 ** step
    b2t = 1.0 - cfg.b2 ** step
    for (path, p), g in zip(trainable, gs):
        mu, nu = at(state["mu"], path), at(state["nu"], path)
        g = g.float()
        if scale is not None:
            g = g * scale
        mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        nu.mul_(cfg.b2).add_(g * g, alpha=1 - cfg.b2)
        upd = (mu / b1t) / (torch.sqrt(nu / b2t) + cfg.eps) + cfg.weight_decay * p
        p.sub_(lr * upd)
    state["step"] = step
    return params, state
