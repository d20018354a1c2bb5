"""Algorithm 1 — Encode with Random Projection (counterpart of
``repro/core/lsh.py``).

For each output bit: a random Gaussian direction ``V ∈ R^d`` projects every
entity's auxiliary row (``U = A·V``), and the bit is ``U`` above its median
over the entities (``threshold="median"``, the paper's choice) or above zero
(``"zero"``, Charikar's LSH baseline).  Bits are produced 32 at a time, one
``(d, 32)`` projection block per packed word.  ``hops > 1`` pushes the
projection through the graph k times (``U = Aᵏ·V``) without forming Aᵏ.

The projections come from a ``torch.Generator`` or are passed in
(``projections``), which is how the parity tests hand both packages the same
draws: JAX's threefry and torch's generators give different numbers.

A dense A takes its last hop through ``kernels.lsh_encode`` with every
word's projections at once (``encode_dense``: the hand-written kernels on a
CUDA device, their plain versions on the CPU), so A is read once per 128
bits; ``hops > 1`` pushes all words' projections through the earlier hops
together too.  The exact median comes from the kernel's own product.  A CSR
A (the adjacency) projects each word with its deterministic segment sum
(``CSRMatrix.matmat``, whose (nnz, w) gather a word at a time bounds) and
binarises here: the JAX package never sends CSR through the kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import codes as codes_lib
from repro_torch.graph.csr import CSRMatrix
from repro_torch.kernels.lsh_encode import ops as lsh_ops
from repro_torch.kernels.lsh_encode.ref import median0, pack_word, project_rows


def binarize_word(U: torch.Tensor, threshold: str) -> torch.Tensor:
    """(n, w) projections -> (n,) int64 packed word."""
    if threshold == "median":
        t = median0(U)
    elif threshold == "zero":
        t = torch.zeros(U.shape[1], dtype=U.dtype, device=U.device)
    else:
        raise ValueError(f"unknown threshold {threshold!r}")
    return pack_word(U, t)


def encode_lsh(
    A: Union[torch.Tensor, np.ndarray, CSRMatrix],
    c: int,
    m: int,
    *,
    generator: Optional[torch.Generator] = None,
    projections: Optional[Sequence[torch.Tensor]] = None,
    threshold: str = "median",
    row_block: Optional[int] = 65536,
    hops: int = 1,
) -> torch.Tensor:
    """Algorithm 1.  Returns packed codes ``(n, n_words)`` int64 words.

    ``projections`` (one ``(d, w)`` f32 tensor per word, ``w`` = the word's
    bit count) replaces the draws from ``generator``; the computation runs
    on their device (or the generator's).  Bits are generated a word (CSR)
    or up to four words (dense) at a time instead of 1 at a time — identical
    semantics, far fewer passes over A.  ``row_block`` bounds the rows of
    each plain dense product; a dense encode also holds its (n, 128) f32
    projections on A's device (``kernels.lsh_encode.ops.encode_dense``)."""
    n, d = A.shape
    if hops > 1 and n != d:
        raise ValueError("hops>1 needs a square (adjacency) auxiliary matrix")
    V, _ = lsh_ops.draw_projections(d, c, m, generator=generator, projections=projections)
    if isinstance(A, CSRMatrix):
        words = []
        for s in range(0, V.shape[1], codes_lib.WORD_BITS):
            U = V[:, s:s + codes_lib.WORD_BITS]
            for _ in range(hops):
                U = A.matmat(U)
            words.append(binarize_word(U, threshold))
        return torch.stack(words, dim=1)
    A = torch.as_tensor(A, dtype=torch.float32).to(V.device).contiguous()
    for _ in range(hops - 1):
        V = project_rows(A, V, row_block)
    return lsh_ops.encode_dense(A, V, threshold, row_block=row_block)


def encode_lsh_codes(A, c: int, m: int, **kw) -> torch.Tensor:
    """Algorithm 1, returning integer codes ``(n, m)`` in [0, c)."""
    return codes_lib.unpack_codes(encode_lsh(A, c, m, **kw), c, m)


def encode_random(generator: torch.Generator, n: int, c: int, m: int) -> torch.Tensor:
    """ALONE's random coding scheme (the paper's baseline): uniform i.i.d.
    codes, packed in the same storage layout."""
    codes = torch.randint(0, c, (n, m), generator=generator,
                          device=generator.device, dtype=torch.int32)
    return codes_lib.pack_codes(codes, c, m)


def collision_experiment(
    A, c: int, m: int, threshold: str, *,
    generators: Optional[Sequence[torch.Generator]] = None,
    projections: Optional[Sequence[Sequence[torch.Tensor]]] = None,
) -> np.ndarray:
    """Paper Fig. 3 / Appendix A: encode once per trial and count the code
    collisions of each.  A trial is one generator (``generators``) or one
    list of projection blocks (``projections``) — the port's stand-in for
    the JAX package's ``fold_in(key, trial)`` — so the same trial gives the
    same projection basis under both thresholds when the caller passes
    equally seeded generators (or the same blocks) for each."""
    if (generators is None) == (projections is None):
        raise ValueError("collision_experiment takes generators or projections, one of them")
    trials = ([{"generator": g} for g in generators] if generators is not None
              else [{"projections": p} for p in projections])
    return np.asarray([codes_lib.count_collisions(
        encode_lsh(A, c, m, threshold=threshold, **kw)) for kw in trials])
