"""Plain PyTorch version of the LSH encode kernel, and the plain pieces of
Algorithm 1's dense step around it (counterpart of
``repro/kernels/lsh_encode/ref.py``).

Semantics: 32-bit code words per entity,

    U    = A @ V              A (n, d), V (d, W), f32
    bits = U > t              t (W,) thresholds, typically the column median
    word = sum_i bits_i << i  little-endian within the word; columns
                              32 k .. 32 k + 31 make word k

held in an int64 tensor (the uint32 bit pattern in the low 32 bits; the
port keeps packed words in int64 because torch's uint32 supports few ops).
"""

from __future__ import annotations

from typing import Optional

import torch


def project_rows(A: torch.Tensor, V: torch.Tensor,
                 row_block: Optional[int] = None) -> torch.Tensor:
    """U = A @ V, in row blocks of ``row_block`` to bound live memory."""
    if row_block is None or A.shape[0] <= row_block:
        return A @ V
    return torch.cat([A[s:s + row_block] @ V
                      for s in range(0, A.shape[0], row_block)])


def median0(U: torch.Tensor) -> torch.Tensor:
    """Median over dim 0, averaging the two middle values for even n —
    ``jnp.median``'s midpoint rule, bit for bit (``torch.median`` returns
    the lower middle value and ``torch.quantile`` refuses inputs above
    2**24 elements).  The two middle order statistics are selected
    (``torch.kthvalue``) along the rows of U's transposed copy: the same
    bits as sorting, and on an H100 at (200,000, 128) 2.5 ms against the
    sort's 3.5 ms."""
    n = U.shape[0]
    Ut = U.t().contiguous()
    lo = torch.kthvalue(Ut, (n - 1) // 2 + 1, dim=1).values
    hi = lo if n % 2 else torch.kthvalue(Ut, n // 2 + 1, dim=1).values
    return (lo + hi) * 0.5


def pack_word(U: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(n, w) projections, (w,) thresholds -> (n,) int64 packed word."""
    bits = (U > t[None, :]).to(torch.int64)
    shifts = torch.arange(U.shape[1], dtype=torch.int64, device=U.device)
    return (bits << shifts).sum(dim=-1)


def pack_words(U: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(n, W) projections, (W,) thresholds -> (n, ceil(W / 32)) int64 words."""
    return torch.stack([pack_word(U[:, s:s + 32], t[s:s + 32])
                        for s in range(0, U.shape[1], 32)], dim=1)


def lsh_encode_word_ref(A: torch.Tensor, V: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    return pack_word(A.float() @ V.float(), t.float())


def lsh_encode_words_ref(A: torch.Tensor, V: torch.Tensor,
                         t: torch.Tensor) -> torch.Tensor:
    return pack_words(A.float() @ V.float(), t.float())
