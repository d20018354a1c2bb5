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
``code_order`` is the plain version of the backward kernel's first step, a
stable counting sort of each codebook's rows by their (clamped) code;
``code_set`` makes the code sets, uniform and skewed, that the backward
and its sort are held to these plain versions on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def code_order(codes: torch.Tensor, c: int):
    """codes (B, m) -> (offsets (m, c + 1) int32, rows (m, B) int32): for
    each codebook j, ``rows[j, offsets[j, k]:offsets[j, k + 1]]`` are the
    rows b whose code j, clamped to [0, c), is k, in ascending b."""
    idx = codes.to(torch.int64).clamp(0, c - 1).t()
    m, B = idx.shape
    rows = torch.sort(idx, dim=1, stable=True).indices.to(torch.int32)
    counts = torch.zeros((m, c), dtype=torch.int64, device=codes.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx))
    offsets = torch.zeros((m, c + 1), dtype=torch.int32, device=codes.device)
    offsets[:, 1:] = counts.cumsum(1)
    return offsets, rows


def code_set(kind: str, B: int, m: int, c: int, rng: np.random.Generator) -> np.ndarray:
    """(B, m) int32 codes drawn from ``rng``: ``uniform`` in [0, c);
    ``clamped``, uniform in [-5, c + 5), so that some clamp; ``one_code``,
    every row one code per codebook (codebook 0's above the range, 1's
    below, both clamped); ``zipf``, Zipf-distributed (a = 1.3), mostly the
    smallest codes."""
    if kind == "one_code":
        codes = np.broadcast_to((7 * np.arange(m)) % c, (B, m)).copy()
        codes[:, 0] = c + 5
        if m > 1:
            codes[:, 1] = -3
    elif kind == "zipf":
        codes = np.minimum(rng.zipf(1.3, (B, m)) - 1, c - 1)
    elif kind == "clamped":
        codes = rng.integers(-5, c + 5, (B, m))
    elif kind == "uniform":
        codes = rng.integers(0, c, (B, m))
    else:
        raise ValueError(f"unknown code set {kind!r}")
    return codes.astype(np.int32)
