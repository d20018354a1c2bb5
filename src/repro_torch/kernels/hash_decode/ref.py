"""Plain PyTorch version of the hash-decode kernel.

Semantics: codes (B, m) int32 in [0, c) index m codebooks (m, c, d_c); the
selected rows are widened to f32 and summed in codebook order j = 0..m-1,
starting from the j=0 term; the sum is optionally rescaled by w0 (d_c,).
With ``scales`` (m, c) the codebooks hold int8 values and each term is
``float(q) * scales[j, code]``.  Output (B, d_c) f32.

This is the m-term gather-sum of the JAX package's ``GatherBackend``, in
the same order, so both give the same bits; the CUDA kernel repeats it
with unfused adds and multiplies and gives the same bits too.

``hash_decode_backward_ref`` is the plain version of the backward kernel,
the codebook gradient: ``g * w0`` rounded in f32, then for each codebook j
an ``index_add_`` of its rows into a zero (c, d_c) f32 table at the
(clamped) codes, which on the CPU adds in ascending row order (the tests
hold it to a Python loop), then one rounding to the codebooks' dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def hash_decode_ref(codes: torch.Tensor, codebooks: torch.Tensor,
                    w0: Optional[torch.Tensor] = None,
                    scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    idx = codes.to(torch.int64)

    def term(j: int) -> torch.Tensor:
        t = codebooks[j].float()[idx[:, j]]
        if scales is not None:
            t = t * scales[j].float()[idx[:, j]][:, None]
        return t

    acc = term(0)
    for j in range(1, codebooks.shape[0]):
        acc = acc + term(j)
    if w0 is not None:
        acc = acc * w0.float()[None, :]
    return acc


def hash_decode_backward_ref(codes: torch.Tensor, g: torch.Tensor,
                             w0: Optional[torch.Tensor], c: int,
                             dtype: torch.dtype) -> torch.Tensor:
    """codes (B, m), g (B, d_c), w0 (d_c,) or None -> d_cb (m, c, d_c) in
    ``dtype``: each (j, k) row the sum, in ascending b, of ``g[b] * w0``
    over the rows b whose code j is k."""
    gw = g.float() * w0.float()[None, :] if w0 is not None else g.float()
    idx = codes.to(torch.int64).clamp(0, c - 1)
    m = codes.shape[1]
    out = torch.zeros((m, c, g.shape[1]), dtype=torch.float32, device=g.device)
    for j in range(m):
        out[j].index_add_(0, idx[:, j], gw)
    return out.to(dtype)
