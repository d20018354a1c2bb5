"""Wrapper of the Hopper LSH encode kernel (``csrc/lsh_encode.cu``), and the
dense Algorithm 1 built on it (counterpart of
``repro/kernels/lsh_encode/ops.py``).

``lsh_encode_word`` checks its operands, then either launches the CUDA
kernel (CUDA tensors) or runs the plain PyTorch version
``ref.lsh_encode_word_ref`` (CPU tensors, which is how the tests reach it
on a machine without a card).  There is no other route: a CUDA call
launches the kernel or raises, whatever the shape (ragged n, d and w are
handled inside the kernel).

``lsh_encode_packed`` is Algorithm 1 for a dense auxiliary matrix, word by
word: it draws each word's projections in the order ``core.lsh.encode_lsh``
draws them, takes the thresholds from the plain product ``A @ V`` (the
median, ``jnp.median``'s midpoint rule, or zero), and packs the bits
through ``lsh_encode_word``.  The thresholds and the kernel's bits come
from two summation orders (cuBLAS, then the kernel), as in the JAX
wrapper, so an entry within rounding of its column's median may flip
against the plain version.  Encode-time only: no autograd (Algorithm 1 is
training-free).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import codes as codes_lib
from repro_torch.kernels.build import build_shared_library, load_library
from repro_torch.kernels.lsh_encode.ref import (lsh_encode_word_ref, median0,
                                                project_rows)

SOURCE = Path(__file__).resolve().parent / "csrc" / "lsh_encode.cu"
NAME = "lsh_encode"
ROW_BLOCK = 65536   # rows per block of the threshold product (core.lsh's default)


def build() -> Tuple[Path, str]:
    """Compile the kernel library (if not built yet); ``(path, nvcc log)``."""
    return build_shared_library(NAME, SOURCE)


def _entry():
    fn = load_library(NAME, SOURCE).lsh_encode_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(A: torch.Tensor, V: torch.Tensor, t: torch.Tensor) -> None:
    if A.dim() != 2 or V.dim() != 2 or t.dim() != 1:
        raise ValueError(f"need A (n, d), V (d, w), t (w,); got "
                         f"{tuple(A.shape)}, {tuple(V.shape)}, {tuple(t.shape)}")
    if any(x.dtype != torch.float32 for x in (A, V, t)):
        raise TypeError(f"lsh_encode_word takes float32 operands, got "
                        f"{A.dtype}, {V.dtype}, {t.dtype}")
    d, w = V.shape
    if A.shape[1] != d:
        raise ValueError(f"A has d={A.shape[1]}, V has d={d}")
    if not 1 <= w <= codes_lib.WORD_BITS:
        raise ValueError(f"a word holds 1..32 bits, V has w={w}")
    if t.shape[0] != w:
        raise ValueError(f"t has {t.shape[0]} thresholds for w={w}")
    if len({x.device for x in (A, V, t)}) != 1:
        raise ValueError(f"operands on several devices: "
                         f"{[str(x.device) for x in (A, V, t)]}")
    if not all(x.is_contiguous() for x in (A, V, t)):
        raise ValueError("lsh_encode_word operands must be contiguous")


@torch.no_grad()
def lsh_encode_word(A: torch.Tensor, V: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A (n, d), V (d, w <= 32), t (w,), all f32 -> (n,) int64 words (the
    uint32 pattern in the low 32 bits).

    CUDA operands launch the kernel on the current stream (no
    synchronisation; ``lsh_encode_word.launches`` counts the launches);
    CPU operands run the plain version."""
    _check(A, V, t)
    dev = A.device
    if dev.type == "cpu":
        return lsh_encode_word_ref(A, V, t)
    if dev.type != "cuda":
        raise ValueError(f"lsh_encode_word runs on cuda (kernel) or cpu (plain), got {dev}")
    n, d = A.shape
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _entry()(A.data_ptr(), V.data_ptr(), t.data_ptr(), out.data_ptr(),
                       n, d, V.shape[1],
                       dev.index if dev.index is not None else torch.cuda.current_device(),
                       stream)
        if err != 0:
            raise RuntimeError(f"lsh_encode kernel launch failed: cudaError {err}")
        lsh_encode_word.launches += 1
    return out.to(torch.int64) & 0xFFFFFFFF


lsh_encode_word.launches = 0


def thresholds(A: torch.Tensor, V: torch.Tensor, threshold: str = "median", *,
               rows: Optional[torch.Tensor] = None,
               row_block: Optional[int] = ROW_BLOCK) -> torch.Tensor:
    """(w,) f32 thresholds of one word: the column median of the plain
    product (``A[rows] @ V`` when ``rows`` samples the entities), or 0."""
    if threshold == "zero":
        return torch.zeros(V.shape[1], dtype=torch.float32, device=V.device)
    if threshold != "median":
        raise ValueError(f"unknown threshold {threshold!r}")
    return median0(project_rows(A if rows is None else A[rows], V, row_block))


def encode_word(A: torch.Tensor, V: torch.Tensor, threshold: str = "median", *,
                rows: Optional[torch.Tensor] = None,
                row_block: Optional[int] = ROW_BLOCK) -> torch.Tensor:
    """One word of Algorithm 1 for dense A: thresholds, then the kernel."""
    V = V.contiguous()
    t = thresholds(A, V, threshold, rows=rows, row_block=row_block)
    return lsh_encode_word(A, V, t)


@torch.no_grad()
def lsh_encode_packed(
    A: torch.Tensor,
    c: int,
    m: int,
    *,
    generator: Optional[torch.Generator] = None,
    projections: Optional[Sequence[torch.Tensor]] = None,
    threshold: str = "median",
    median_sample: Optional[int] = None,
) -> torch.Tensor:
    """(n, d) dense aux -> (n, n_words) int64 packed codes.

    Each word's projections ``V`` (d, w) come from ``generator`` (drawn as
    ``core.lsh.encode_lsh`` draws them, so one generator state gives the
    same codes through both) or from ``projections``.  ``median_sample``
    takes each word's median over that many rows drawn without replacement
    from ``generator`` right after the word's projections."""
    nb = codes_lib.n_bits(c, m)
    nw = codes_lib.n_words(c, m)
    if projections is None and generator is None:
        raise ValueError("lsh_encode_packed needs a generator or explicit projections")
    if projections is not None and len(projections) != nw:
        raise ValueError(f"expected {nw} projection blocks, got {len(projections)}")
    sample = median_sample is not None and median_sample < A.shape[0]
    if sample and (generator is None or threshold != "median"):
        raise ValueError("median_sample draws rows from the generator for the median")
    device = projections[0].device if projections is not None else generator.device
    A = torch.as_tensor(A, dtype=torch.float32).to(device).contiguous()
    n, d = A.shape
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
        rows = (torch.randperm(n, generator=generator, device=device)[:median_sample]
                if sample else None)
        words.append(encode_word(A, V, threshold, rows=rows))
    return torch.stack(words, dim=1)
