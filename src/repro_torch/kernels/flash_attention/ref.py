"""Plain PyTorch version of the flash-attention kernel (a port of the JAX
package's ``mha_ref``).

q (B, H, Sq, D), k/v (B, K, Skv, D), GQA with G = H // K (q head h reads kv
head h // G); the scores are taken in q's dtype and widened to f32, scaled
by 1/sqrt(D), causally masked at -1e30 (key position > query position),
softmaxed in f32, cast back to q's dtype and applied to v.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True) -> torch.Tensor:
    B, H, Sq, D = q.shape
    K = k.shape[1]
    G = H // K
    qg = q.reshape(B, K, G, Sq, D)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k).float()
    s = s * (1.0 / math.sqrt(D))
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        kpos = torch.arange(k.shape[2], device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v)
    return out.reshape(B, H, Sq, D)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """``mha_ref`` in the (B, S, heads, D) layout of ``nn.attention``."""
    out = mha_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  causal=causal)
    return out.transpose(1, 2)
