"""Rotary position embeddings, rotate-half convention over the rotated
fraction of the head dims (counterpart of ``repro/nn/rope.py``).

``standard`` rotates every head dim, ``half`` (chatglm3's "2d") the first
half; ``none`` has no rotary.  Positions are int (B, S), or for M-RoPE
(qwen2-vl) (3, B, S): temporal, height and width streams, the rotary
frequencies split into ``mrope_sections`` and each section read from its
own stream (arXiv:2409.12191).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def _freqs(d_rot: int, theta: float, device) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                        device=device) / d_rot)


def rope_cos_sin(positions: torch.Tensor, d_head: int, *, theta: float = 10000.0,
                 fraction: float = 1.0,
                 mrope_sections: Optional[Sequence[int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S), or (3, B, S) with ``mrope_sections``, int -> (cos,
    sin) of shape (B, S, d_rot/2) in f32."""
    d_rot = int(d_head * fraction) // 2 * 2
    inv = _freqs(d_rot, theta, positions.device)
    ang = positions[..., None].float() * inv
    if mrope_sections is not None:
        if sum(mrope_sections) != d_rot // 2:
            raise ValueError(f"mrope sections {mrope_sections} != d_rot/2 {d_rot // 2}")
        ang = torch.cat([part[i] for i, part in
                         enumerate(ang.split(list(mrope_sections), dim=-1))], dim=-1)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, d_head); rotates the first 2*cos.shape[-1] dims.  cos and
    sin are cast to x's dtype before the multiply."""
    d_rot = 2 * cos.shape[-1]
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    x1, x2 = xr.chunk(2, dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    if xp.shape[-1]:
        out = torch.cat([out, xp], dim=-1)
    return out


def default_positions(batch: int, seq: int, variant: str,
                      device=None) -> torch.Tensor:
    """Text-only position ids (B, S) int32; for M-RoPE (3, B, S), the three
    streams equal (a text sequence's)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(batch, seq)
    if variant == "mrope":
        return pos[None].expand(3, batch, seq)
    return pos
