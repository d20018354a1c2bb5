"""Rotary position embeddings, rotate-half convention over the rotated
fraction of the head dims (counterpart of ``repro/nn/rope.py``).

``standard`` rotates every head dim, ``half`` (chatglm3's "2d") the first
half; ``none`` has no rotary.  Multimodal M-RoPE (qwen2-vl) raises: it
comes with the LM side-path slice.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

MROPE_SLICE = "the LM side-path slice (ROADMAP A.18)"


def _freqs(d_rot: int, theta: float, device) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, d_rot, 2, dtype=torch.float32,
                                        device=device) / d_rot)


def rope_cos_sin(positions: torch.Tensor, d_head: int, *, theta: float = 10000.0,
                 fraction: float = 1.0,
                 mrope_sections: Optional[Sequence[int]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (B, S) int -> (cos, sin) of shape (B, S, d_rot/2) in f32."""
    if mrope_sections is not None:
        raise NotImplementedError(f"M-RoPE is not ported yet; it comes with {MROPE_SLICE}")
    d_rot = int(d_head * fraction) // 2 * 2
    inv = _freqs(d_rot, theta, positions.device)
    ang = positions[..., None].float() * inv
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
    """Text-only position ids (B, S) int32."""
    if variant == "mrope":
        raise NotImplementedError(f"M-RoPE is not ported yet; it comes with {MROPE_SLICE}")
    return torch.arange(seq, dtype=torch.int32, device=device)[None].expand(batch, seq)
