"""Wrappers of the Hopper LSH encode kernels (``csrc/lsh_encode.cu``), and
the dense Algorithm 1 built on them (counterpart of
``repro/kernels/lsh_encode/ops.py``).

Three wrappers, one per launch:

- ``project(A, V)``: U = A @ V for up to 128 projection columns, stored;
- ``pack(U, t)``: the words of U > t;
- ``lsh_encode_words(A, V, t)``: the words of (A @ V) > t in one launch,
  U never stored.  ``lsh_encode_word`` (w <= 32, one word) is the TPU
  kernel's counterpart and goes through it.

Each checks its operands, then either launches its CUDA kernel (CUDA
tensors) or runs the plain PyTorch version in ``ref.py`` (CPU tensors,
which is how the tests reach it on a machine without a card).  There is no
other route: a CUDA call launches the kernel or raises, whatever the shape
(ragged n, d and W are handled inside the kernel).  ``launches_by_kernel``
counts the launches of each.  Operands may be float32, bfloat16 or
float16, in any layout: the kernels read f32, so on the card a 16-bit or
strided operand is widened (exactly) or copied once to a contiguous f32
tensor, and ``copies`` counts those copies; the plain version widens them
as the JAX kernel's body does.

``encode_dense`` is Algorithm 1 for a dense auxiliary matrix with every
word's projections at once, (d, n_bits), so A is read once for up to 128
bits (four words): with the exact median, one ``project``, the median of
U's columns and one ``pack``; with zero thresholds or a sampled median,
one ``lsh_encode_words``.  The exact median comes from the same U the bits
come from, so within a run a column's bits agree with its median.  A
sampled median comes from the plain product of the sampled rows, as in the
JAX wrapper, so an entry within rounding of it may flip against the plain
version.  ``lsh_encode_packed`` draws the projections as
``core.lsh.encode_lsh`` does and calls ``encode_dense``, so one generator
state gives the same codes through both.  Encode-time only: no autograd
(Algorithm 1 is training-free).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import codes as codes_lib
from repro_torch.kernels.build import build_shared_library, load_library
from repro_torch.kernels.lsh_encode.ref import (lsh_encode_words_ref, median0,
                                                pack_words, project_rows)

SOURCE = Path(__file__).resolve().parent / "csrc" / "lsh_encode.cu"
NAME = "lsh_encode"
ROW_BLOCK = 65536     # rows per block of a plain product (core.lsh's default)
MAX_COLUMNS = 128     # projection columns one launch takes (four words)

KERNELS = ("project", "pack", "fused")
launches_by_kernel = dict.fromkeys(KERNELS, 0)
copies = 0            # operands widened or made contiguous for a kernel
_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {  # entry point: argument types (pointers, then ints, then the stream)
    "project": ("lsh_project_launch", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "pack": ("lsh_pack_launch", [_P, _P, _P, _I, _I, _I, _P]),
    "fused": ("lsh_encode_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
}


def build() -> Tuple[Path, str]:
    """Compile the kernel library (if not built yet); ``(path, nvcc log)``."""
    return build_shared_library(NAME, SOURCE)


def _launch(kernel: str, dev: torch.device, *args) -> None:
    name, argtypes = _ENTRIES[kernel]
    fn = getattr(load_library(NAME, SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = fn(*args, index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lsh_encode {kernel} kernel launch failed: cudaError {err}")
    launches_by_kernel[kernel] += 1


def _check(who: str, tensors: Sequence[torch.Tensor], max_w: int) -> None:
    """A (n, d), V (d, w), and t (w,) if given: f32, bf16 or f16, one
    device, 1 <= w <= max_w."""
    A, V = tensors[0], tensors[1]
    t = tensors[2] if len(tensors) > 2 else None
    if A.dim() != 2 or V.dim() != 2 or (t is not None and t.dim() != 1):
        raise ValueError(f"{who} needs A (n, d), V (d, w)"
                         + (", t (w,)" if t is not None else "") + "; got "
                         + ", ".join(str(tuple(x.shape)) for x in tensors))
    if any(x.dtype not in _FLOATS for x in tensors):
        raise TypeError(f"{who} takes float32, bfloat16 or float16 operands, got "
                        + ", ".join(str(x.dtype) for x in tensors))
    d, w = V.shape
    if A.shape[1] != d:
        raise ValueError(f"A has d={A.shape[1]}, V has d={d}")
    if not 1 <= w <= max_w:
        raise ValueError(f"{who} takes 1..{max_w} projection columns, V has w={w}")
    if t is not None and t.shape[0] != w:
        raise ValueError(f"t has {t.shape[0]} thresholds for w={w}")
    _same_device(who, tensors)


def _same_device(who: str, tensors: Sequence[torch.Tensor]) -> None:
    if len({x.device for x in tensors}) != 1:
        raise ValueError(f"operands on several devices: {[str(x.device) for x in tensors]}")
    dev = tensors[0].device
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{who} runs on cuda (kernel) or cpu (plain), got {dev}")


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a kernel reads it: contiguous f32, itself if it is one,
    else one exact copy, counted in ``copies``."""
    global copies
    if x.dtype == torch.float32 and x.is_contiguous():
        return x
    copies += 1
    return torch.empty_like(x, dtype=torch.float32, memory_format=torch.contiguous_format).copy_(x)


def _words(n: int, w: int, dev: torch.device) -> torch.Tensor:
    return torch.empty((n, -(-w // codes_lib.WORD_BITS)), dtype=torch.int32, device=dev)


def _as_uint32(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.int64) & 0xFFFFFFFF


@torch.no_grad()
def project(A: torch.Tensor, V: torch.Tensor, *,
            row_block: Optional[int] = ROW_BLOCK) -> torch.Tensor:
    """A (n, d), V (d, w <= 128), f32/bf16/f16 -> U = A @ V (n, w) f32.
    CUDA operands launch the kernel (every sum in ascending k, one FMA a
    term); CPU operands run the plain product, widened to f32, in row
    blocks of ``row_block``."""
    _check("project", (A, V), MAX_COLUMNS)
    if A.device.type == "cpu":
        return project_rows(A.float(), V.float(), row_block)
    A, V = _f32(A), _f32(V)
    (n, d), w = A.shape, V.shape[1]
    U = torch.empty((n, w), dtype=torch.float32, device=A.device)
    if n:
        _launch("project", A.device, A.data_ptr(), V.data_ptr(), U.data_ptr(), n, d, w)
    return U


@torch.no_grad()
def pack(U: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """U (n, w <= 128), t (w,), f32/bf16/f16 -> (n, ceil(w / 32)) int64
    words of U > t (the uint32 pattern in the low 32 bits), compared in
    f32."""
    if U.dim() != 2 or t.dim() != 1 or t.shape[0] != U.shape[1]:
        raise ValueError(f"pack needs U (n, w), t (w,); got {tuple(U.shape)}, {tuple(t.shape)}")
    if U.dtype not in _FLOATS or t.dtype not in _FLOATS:
        raise TypeError(f"pack takes float32, bfloat16 or float16 operands, got "
                        f"{U.dtype}, {t.dtype}")
    if not 1 <= U.shape[1] <= MAX_COLUMNS:
        raise ValueError(f"pack takes 1..{MAX_COLUMNS} columns, U has {U.shape[1]}")
    _same_device("pack", (U, t))
    if U.device.type == "cpu":
        return pack_words(U.float(), t.float())
    U, t = _f32(U), _f32(t)
    n, w = U.shape
    out = _words(n, w, U.device)
    if n:
        _launch("pack", U.device, U.data_ptr(), t.data_ptr(), out.data_ptr(), n, w)
    return _as_uint32(out)


def _encode_words(who: str, A: torch.Tensor, V: torch.Tensor, t: torch.Tensor,
                  max_w: int) -> torch.Tensor:
    _check(who, (A, V, t), max_w)
    if A.device.type == "cpu":
        return lsh_encode_words_ref(A, V, t)
    A, V, t = _f32(A), _f32(V), _f32(t)
    (n, d), w = A.shape, V.shape[1]
    out = _words(n, w, A.device)
    if n:
        _launch("fused", A.device, A.data_ptr(), V.data_ptr(), t.data_ptr(),
                out.data_ptr(), n, d, w)
    return _as_uint32(out)


@torch.no_grad()
def lsh_encode_words(A: torch.Tensor, V: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A (n, d), V (d, w <= 128), t (w,), f32/bf16/f16 (widened to f32)
    -> (n, ceil(w / 32)) int64 words of (A @ V) > t, in one launch on a
    CUDA device (no synchronisation), the plain version on the CPU."""
    return _encode_words("lsh_encode_words", A, V, t, MAX_COLUMNS)


@torch.no_grad()
def lsh_encode_word(A: torch.Tensor, V: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """A (n, d), V (d, w <= 32), t (w,), f32/bf16/f16 (widened to f32) ->
    (n,) int64 words: the TPU kernel's function, through the same launch as
    ``lsh_encode_words``."""
    return _encode_words("lsh_encode_word", A, V, t, codes_lib.WORD_BITS)[:, 0]


def draw_projections(
    d: int, c: int, m: int, *,
    generator: Optional[torch.Generator] = None,
    projections: Optional[Sequence[torch.Tensor]] = None,
    n: int = 0,
    median_sample: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
    """Every word's projections as one (d, n_bits) f32 matrix, and the rows
    each word samples for its median (or None).  From ``generator``, per
    word: ``randn(d, w)``, then that word's ``randperm(n)[:median_sample]``
    when sampling; or the given ``projections``, one (d, w) block a word."""
    nb, nw = codes_lib.n_bits(c, m), codes_lib.n_words(c, m)
    if projections is None and generator is None:
        raise ValueError("Algorithm 1 needs a generator or explicit projections")
    if projections is not None and len(projections) != nw:
        raise ValueError(f"expected {nw} projection blocks, got {len(projections)}")
    sample = median_sample is not None and median_sample < n
    if sample and generator is None:
        raise ValueError("median_sample draws rows from the generator for the median")
    device = projections[0].device if projections is not None else generator.device
    blocks, rows = [], [] if sample else None
    for w in range(nw):
        wbits = min(codes_lib.WORD_BITS, nb - w * codes_lib.WORD_BITS)
        if projections is not None:
            V = projections[w].to(device, torch.float32)
            if tuple(V.shape) != (d, wbits):
                raise ValueError(f"projection {w} has shape {tuple(V.shape)}, "
                                 f"expected {(d, wbits)}")
        else:
            V = torch.randn(d, wbits, generator=generator, device=device)
        blocks.append(V)
        if sample:
            rows.append(torch.randperm(n, generator=generator, device=device)[:median_sample])
    return torch.cat(blocks, dim=1).contiguous(), rows


@torch.no_grad()
def encode_dense(A: torch.Tensor, V: torch.Tensor, threshold: str = "median", *,
                 rows: Optional[Sequence[torch.Tensor]] = None,
                 row_block: Optional[int] = ROW_BLOCK) -> torch.Tensor:
    """Algorithm 1's binarise-pack for dense A (n, d) f32 and all words'
    projections V (d, n_bits) -> (n, n_words) int64 words.

    Up to 128 columns (four words) a launch.  ``threshold="median"``
    without ``rows``: ``project``, the column median of that U (the
    midpoint rule of ``jnp.median``), ``pack``.  With ``rows`` (one index
    tensor a word) each word's median is taken over the plain product of
    its sampled rows; with ``"zero"`` the thresholds are 0; both then take
    one ``lsh_encode_words``.

    Memory: the exact median holds U, n * 128 * 4 bytes on A's device (102
    MB at n = 200,000; 78 MB at the 152,064-token vocabulary), plus the
    sort's copy of it and its int64 indices.  ``row_block`` bounds the
    plain products: the CPU's U and the sampled medians'."""
    if threshold not in ("median", "zero"):
        raise ValueError(f"unknown threshold {threshold!r}")
    if rows is not None and threshold != "median":
        raise ValueError("sampled rows are for the median")
    A = A.contiguous()
    out = []
    for c0 in range(0, V.shape[1], MAX_COLUMNS):
        Vc = V[:, c0:c0 + MAX_COLUMNS].contiguous()
        if threshold == "zero":
            t = torch.zeros(Vc.shape[1], dtype=torch.float32, device=V.device)
        elif rows is None:
            U = project(A, Vc, row_block=row_block)
            out.append(pack(U, median0(U)))
            del U
            continue
        else:
            w0 = c0 // codes_lib.WORD_BITS
            t = torch.cat([
                median0(project_rows(A[r], Vc[:, s:s + codes_lib.WORD_BITS].contiguous(),
                                     row_block))
                for r, s in zip(rows[w0:], range(0, Vc.shape[1], codes_lib.WORD_BITS))])
        out.append(lsh_encode_words(A, Vc, t))
    return torch.cat(out, dim=1)


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

    The projections come from ``generator`` (drawn as
    ``core.lsh.encode_lsh`` draws them, so one generator state gives the
    same codes through both) or from ``projections``.  ``median_sample``
    takes each word's median over that many rows drawn without replacement
    from ``generator`` right after the word's projections."""
    if (median_sample is not None and median_sample < A.shape[0]
            and (generator is None or threshold != "median")):
        raise ValueError("median_sample draws rows from the generator for the median")
    n, d = A.shape
    V, rows = draw_projections(d, c, m, generator=generator, projections=projections,
                               n=n, median_sample=median_sample)
    A = torch.as_tensor(A, dtype=torch.float32).to(V.device).contiguous()
    return encode_dense(A, V, threshold, rows=rows)
