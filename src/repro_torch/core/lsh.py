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

A dense A takes its last hop through ``kernels.lsh_encode`` (the
hand-written kernel on a CUDA device, its plain version on the CPU), with
the thresholds from the plain product, as the JAX package's
``lsh_encode_packed`` does.  A CSR A (the adjacency) projects with its
deterministic segment sum (``CSRMatrix.matmat``) and binarises here: the
JAX package never sends CSR through the kernel.
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
    on their device (or the generator's).  Bits are generated 32 at a time
    instead of 1 at a time — identical semantics, 32x fewer passes over A."""
    nb = codes_lib.n_bits(c, m)
    nw = codes_lib.n_words(c, m)
    n, d = A.shape
    if hops > 1 and n != d:
        raise ValueError("hops>1 needs a square (adjacency) auxiliary matrix")
    if projections is None and generator is None:
        raise ValueError("encode_lsh needs a generator or explicit projections")
    if projections is not None and len(projections) != nw:
        raise ValueError(f"expected {nw} projection blocks, got {len(projections)}")
    device = (projections[0].device if projections is not None
              else generator.device)
    if not isinstance(A, CSRMatrix):
        A = torch.as_tensor(A, dtype=torch.float32).to(device).contiguous()

    words = []
    for w in range(nw):
        wbits = min(codes_lib.WORD_BITS, nb - w * codes_lib.WORD_BITS)
        if projections is not None:
            V = projections[w].to(device, torch.float32)
            if tuple(V.shape) != (d, wbits):
                raise ValueError(f"projection {w} has shape {tuple(V.shape)}, "
                                 f"expected {(d, wbits)}")
        else:
            V = torch.randn(d, wbits, generator=generator, device=device)
        U = V
        for _ in range(hops - 1):
            U = (A.matmat(U) if isinstance(A, CSRMatrix)
                 else project_rows(A, U, row_block))
        words.append(binarize_word(A.matmat(U), threshold) if isinstance(A, CSRMatrix)
                     else lsh_ops.encode_word(A, U, threshold, row_block=row_block))
    return torch.stack(words, dim=1)


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
