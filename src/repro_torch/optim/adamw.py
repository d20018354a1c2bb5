"""AdamW (Loshchilov & Hutter 2018), counterpart of ``repro/optim/adamw.py``.

Decoupled weight decay, optional global-norm clip, bias correction from the
integer step.  Buffer leaves (``*_buf``) and non-float leaves are masked
out: they carry no moments and are never updated.

Unlike the JAX version, ``adamw_update`` updates the params and moments in
place (under ``torch.no_grad``) and returns the same tensors: at
qwen1.5-0.5b's 467 M trainable parameters a functional update would hold a
second f32 copy (1.9 GB) of the params and of each moment.

The moments may be stored in bf16 (``adamw_init(moments_dtype=)``, the JAX
package's per-arch training profiles' memory knob): as in JAX, each update
reads them into f32, steps the param from the f32 values and stores them
rounded, one leaf at a time.
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
    # Storage type of the moments in the JAX package's configs; the state
    # takes it from ``adamw_init(moments_dtype=)``, as JAX's does.
    moments_dtype: str = "float32"


def adamw_init(params, moments_dtype: torch.dtype = torch.float32) -> dict:
    """Moments in ``moments_dtype`` for the trainable leaves, None elsewhere."""
    def zeros(path, p):
        return torch.zeros_like(p, dtype=moments_dtype) if is_trainable(path, p) else None

    return {"step": 0, "mu": map_tree(zeros, params), "nu": map_tree(zeros, params)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of float tensors, in f32."""
    sq = [t.float().square().sum() for t in tensors
          if t is not None and t.is_floating_point()]
    return torch.sqrt(torch.stack(sq).sum()) if sq else torch.zeros(())


UPDATE_PART = 1 << 26     # elements of a leaf updated at once


def _parts(p, g, mu, nu):
    """A leaf's (p, g, mu, nu) in slices of ``UPDATE_PART`` elements (views
    of the flat tensors), so the update's f32 temporaries stay a slice's
    size (granite's stacked expert weights are 4.8 GB a leaf).  The update
    is elementwise, so the slices give the whole leaf's bits."""
    if p.numel() <= UPDATE_PART or not all(t.is_contiguous() for t in (p, mu, nu)):
        return [(p, g, mu, nu)]
    flat = [t.reshape(-1) for t in (p, g, mu, nu)]
    return zip(*(t.split(UPDATE_PART) for t in flat))


def _update_part(p, g, mu, nu, scale, cfg: AdamWConfig, lr: float, b1t: float, b2t: float):
    g = g.float()
    if scale is not None:
        g = g * scale
    mu_f = mu if mu.dtype == torch.float32 else mu.float()
    nu_f = nu if nu.dtype == torch.float32 else nu.float()
    mu_f.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    nu_f.mul_(cfg.b2).add_(g * g, alpha=1 - cfg.b2)
    upd = (mu_f / b1t) / (torch.sqrt(nu_f / b2t) + cfg.eps) + cfg.weight_decay * p
    p.sub_(lr * upd)
    if mu_f is not mu:
        mu.copy_(mu_f)
        nu.copy_(nu_f)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale: float = 1.0,
                 grad_norm=None):
    """Returns (params, state), both updated in place.  ``grads`` has the
    params' structure; its entries for masked leaves are ignored.
    ``grad_norm(grads)``: the clip's global norm (across ranks, the blocks'
    ``ShardPlan.grad_norm``); ``global_norm`` of the leaves by default."""
    step = state["step"] + 1
    lr = cfg.lr * lr_scale
    trainable = [(path, p) for path, p in leaves_with_path(params) if is_trainable(path, p)]

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    gs = [at(grads, path) for path, _ in trainable]
    if cfg.clip_norm is not None:
        gn = global_norm(gs) if grad_norm is None else grad_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    else:
        scale = None
    b1t = 1.0 - cfg.b1 ** step
    b2t = 1.0 - cfg.b2 ** step
    for (path, p), g in zip(trainable, gs):
        mu, nu = at(state["mu"], path), at(state["nu"], path)
        for part in _parts(p, g, mu, nu):
            _update_part(*part, scale, cfg, lr, b1t, b2t)
    state["step"] = step
    return params, state
