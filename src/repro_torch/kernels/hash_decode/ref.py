"""Plain PyTorch version of the hash-decode kernel.

Semantics: codes (B, m) int32 in [0, c) index m codebooks (m, c, d_c); the
selected rows are widened to f32 and summed in codebook order j = 0..m-1,
starting from the j=0 term; the sum is optionally rescaled by w0 (d_c,).
With ``scales`` (m, c) the codebooks hold int8 values and each term is
``float(q) * scales[j, code]``.  Output (B, d_c) f32.

This is the m-term gather-sum of the JAX package's ``GatherBackend``, in
the same order, so both give the same bits; the CUDA kernel repeats it
with unfused adds and multiplies and gives the same bits too.
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
