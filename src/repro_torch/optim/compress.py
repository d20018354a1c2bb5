"""int8 gradient compression for data parallelism (counterpart of
``repro/optim/compress.py``).

Block-quantised all-reduce with error feedback:

  q, scale   = quantize(g + residual)        # per-block absmax int8
  g_hat      = sum over ranks of dequant(q) / n_ranks
  residual'  = (g + residual) - dequant(q)

The ranks first agree on a shared scale per block of 256 (the max of the
blocks' absolute maxima, over an ``all_gather`` of them), so the int8
payloads can be summed as integers: the payload crosses the wire as int8
(a quarter of f32's bytes) and is summed as int32 in rank order, which is
exact.  Every division is by a tensor (CUDA divides by a Python scalar as a
product with its reciprocal), and ``torch.round`` rounds half to even as
``jnp.round`` does, so the CPU and the card give the same bits.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), n


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    q = torch.tensor(127.0, device=absmax.device)
    return torch.where(absmax > 0, absmax / q, torch.ones_like(absmax))


def _quantize(blocks: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)


def compress_gradients_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """g (any shape) -> (int8 blocks (n_blocks, 256), f32 scales (n_blocks,))."""
    blocks, _ = _pad_to_block(g.float())
    scale = _scale_of(blocks.abs().amax(dim=1))
    return _quantize(blocks, scale), scale


def decompress_gradients_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    deq = q.float() * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return deq.reshape(-1)[:n].reshape(shape)


def _finish(g, q_sum_int32, scale, n_ranks: int):
    deq = (q_sum_int32.float() * scale[:, None]).reshape(-1)[: g.numel()]
    n = torch.tensor(float(n_ranks), device=g.device)
    return (deq.reshape(g.shape) / n).to(g.dtype)


def psum_compressed(g: torch.Tensor, residual: torch.Tensor, mesh, axes):
    """Error-feedback quantised mean of ``g`` over the line of ``axes`` of
    the live ``mesh``.  Returns (mean gradient, new residual), the mean the
    same bits on every rank of the line."""
    g_comp = g.float() + residual
    blocks, _ = _pad_to_block(g_comp)
    absmax = blocks.abs().amax(dim=1)
    gmax = torch.stack(mesh.all_gather(absmax, axes, name="compress_scale")).amax(dim=0)
    scale = _scale_of(gmax)
    q = _quantize(blocks, scale)
    deq_local = (q.float() * scale[:, None]).reshape(-1)[: g.numel()]
    new_residual = g_comp - deq_local.reshape(g.shape)
    parts = mesh.all_gather(q, axes, name="compress_int8")
    summed = parts[0].to(torch.int32)
    for p in parts[1:]:
        summed = summed + p.to(torch.int32)
    return _finish(g, summed, scale, len(parts)), new_residual


def psum_compressed_reference(gs: Sequence[torch.Tensor], residuals: Sequence[torch.Tensor]
                              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``psum_compressed``'s plain one-process version over every rank's
    ``g`` and residual, in rank order: (the mean, each rank's residual)."""
    comps = [g.float() + r for g, r in zip(gs, residuals)]
    blocks = [_pad_to_block(c)[0] for c in comps]
    scale = _scale_of(torch.stack([b.abs().amax(dim=1) for b in blocks]).amax(dim=0))
    qs = [_quantize(b, scale) for b in blocks]
    new_res = [c - (q.float() * scale[:, None]).reshape(-1)[: c.numel()].reshape(c.shape)
               for c, q in zip(comps, qs)]
    summed = qs[0].to(torch.int32)
    for q in qs[1:]:
        summed = summed + q.to(torch.int32)
    return _finish(gs[0], summed, scale, len(gs)), new_res
