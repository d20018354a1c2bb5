"""Wrapper of the Hopper hash-decode kernel (``csrc/hash_decode.cu``).

``hash_decode`` checks its operands, then either launches the CUDA kernel
(CUDA tensors) or runs the plain PyTorch version ``ref.hash_decode_ref``
(CPU tensors, which is how the tests reach it on a machine without a card).
There is no other route: a CUDA call launches the kernel or raises.  The
kernel has two variants (``launch_shape``): from ``STAGED_MIN_ROWS`` rows
on, a slice of every codebook is staged in shared memory and a persistent
grid walks the rows; below it, or where a slice of every codebook does not
fit, each row's codebook rows are read directly.  Both give the plain
version's bits.  Codebooks are stored float32, bfloat16, float16 or int8;
any (m, c); any layout: on the card a strided operand is copied once to a
contiguous one (``hash_decode.copies`` counts the copies), and an
unaligned one is read element by element, uncopied.

Every call goes through ``_HashDecode`` (a ``torch.autograd.Function``) on
either device.  Its backward computes what the JAX package's ``_bwd``
(``kernels/hash_decode/ops.py``, XLA) does:

    d_cb[j, k] = sum_b [codes[b, j] = k] * (g[b] * w0)   summed in ascending b
    d_w0       = sum_b g[b] * sum_j cb[j, codes[b, j]]   the sum re-decoded

in f32, cast to the operands' dtypes.  ``d_cb`` comes from the CUDA
backward kernels (CUDA operands; ``hash_decode_backward.launches`` counts
a call): a stable counting sort of each codebook's rows by code (two
launches, over ranges of codes where an (m, c) histogram outgrows shared
memory), then one warp a (feature slice, codebook, code) sums its rows in
registers.  On CPU operands it is the plain version
``ref.hash_decode_backward_ref`` (``index_add_`` on the CPU).  Both sum
each (j, k, feature) in ascending b with no atomics, so they agree bit for
bit and two passes give the same bits.  ``code_order`` runs the sort alone
(the kernel, or ``ref.code_order`` on the CPU).  ``d_w0`` is
a decode through the forward kernel and a reduction.

int8 storage (the JAX package's ``_hash_decode_int8`` / ``_bwd_int8``):
the kernel decodes the int8 values and their (m, c) scales, and the
gradient goes straight through to the float ``masters`` they were
quantized from.  ``d_cb`` never reads codebook values, so it is the
unquantized ``d_cb`` bit for bit, in the masters' dtype; ``d_w0`` sums
``g`` against what the forward decoded, the int8 decode without w0.

``quantize_codebooks`` / ``dequantize_codebooks`` are the per-(codebook,
code) absmax int8 scheme of the JAX package, bit for bit;
``quantize_dequantize`` is their composition with an identity backward,
the straight-through int8 of the plain decode backends.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.build import build_shared_library, load_library
from repro_torch.kernels.hash_decode.ref import (code_order as code_order_ref,
                                                 hash_decode_backward_ref, hash_decode_ref)

SOURCE = Path(__file__).resolve().parent / "csrc" / "hash_decode.cu"
NAME = "hash_decode"

_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float16: 3}
_GRAD_DTYPES = (torch.float32, torch.bfloat16, torch.float16)   # the backward's d_cb types
SLICE_BYTES = 32               # bytes of a codebook row's feature slice (staged)
SMEM_LIMIT = 227 * 1024        # dynamic shared memory a block may have (H100)
_DIRECT_SMEM = 48 * 1024
_DIRECT_THREADS = 256
# Below this many rows the staged variant's 128 KiB load a block costs more
# than it saves, and the direct variant decodes: on an H100 (m = 16, c =
# 256, d_c = 512) the direct one is faster at 4,096 rows and the staged one
# at 6,144, in f32 and bf16 (chip_smoke.py's variant times).
STAGED_MIN_ROWS = 6144


def build() -> Tuple[Path, str]:
    """Compile the kernel library (if not built yet); ``(path, nvcc log)``."""
    return build_shared_library(NAME, SOURCE)


def _entry(name: str, n_int: int):
    fn = getattr(load_library(NAME, SOURCE), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, p] + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    return fn


def _backward_entry():
    fn = load_library(NAME, SOURCE).hash_decode_backward_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p] + [i] * 5 + [p, i, p]
        fn.restype = ctypes.c_int
    return fn


def _sort_entry():
    fn = load_library(NAME, SOURCE).hash_decode_sort_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, p, i, p]
        fn.restype = ctypes.c_int
    return fn


def _sizes_entry():
    fn = load_library(NAME, SOURCE).hash_decode_backward_sizes
    if fn.argtypes is None:
        i = ctypes.c_int
        fn.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = None
    return fn


def _launches_entry():
    fn = load_library(NAME, SOURCE).hash_decode_backward_kernel_launches
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        fn.restype = None
    return fn


def quantize_codebooks(codebooks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """codebooks (m, c, d_c) any float -> (q int8 (m, c, d_c), scales f32
    (m, c)); all-zero code vectors get scale 1 so dequant is exact."""
    cb = codebooks.float()
    absmax = cb.abs().amax(dim=2)
    # divide by a tensor: CUDA turns a division by a Python scalar into a
    # product with its reciprocal, which rounds differently from the CPU's
    # and JAX's division
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0),
                         torch.ones_like(absmax))
    q = torch.clamp(torch.round(cb / scales[:, :, None]), -127, 127).to(torch.int8)
    return q, scales


def dequantize_codebooks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(q int8 (m, c, d_c), scales f32 (m, c)) -> f32 (m, c, d_c)."""
    return q.float() * scales.float()[:, :, None]


class _QuantizeDequantize(torch.autograd.Function):

    @staticmethod
    def forward(ctx, codebooks):
        ctx.dtype = codebooks.dtype
        return dequantize_codebooks(*quantize_codebooks(codebooks))

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def quantize_dequantize(codebooks: torch.Tensor) -> torch.Tensor:
    """dequant(quantize(cb)) in f32, the values an int8 decode sees, with a
    straight-through (identity) backward to the float masters, cast to
    their dtype (the JAX package's ``quantize_dequantize``)."""
    return _QuantizeDequantize.apply(codebooks)


class Launch(NamedTuple):
    """How one decode launches.  ``staged``: ``grid`` persistent blocks of
    ``threads``, ``smem`` bytes of codebook slices (and int8 scales), units
    of one feature slice (``slices`` a row) x ``rows`` rows.  ``direct``:
    ``grid`` blocks of (``tx``, ``rows``) threads, ``smem`` bytes of codes
    (0: each code is read where it is used)."""
    variant: str
    grid: int
    threads: int
    smem: int
    slices: int = 0
    rows: int = 0
    tx: int = 0


def launch_shape(B: int, m: int, c: int, d_c: int, elem: int, quantized: bool,
                 sms: int, variant: Optional[str] = None) -> Launch:
    """The staged variant when B >= ``STAGED_MIN_ROWS`` and a slice of
    every codebook fits in shared memory: one 32-byte slice of each of the
    m*c rows (8 f32, 16 bf16 or 32 int8 features), ``sms // slices`` row
    ranges so the units fill the card once.  Otherwise the direct variant:
    each thread owns 4 consecutive features, up to 128 threads (512
    features) a row pass, the rest of the 256-thread block further rows, as
    many as have room for their m codes in 48 KiB of shared memory (none
    staged where one row's do not fit).  ``variant`` forces one of the two
    (to time them against each other)."""
    staged_smem = m * c * SLICE_BYTES + (m * c * 4 if quantized else 0)
    if variant is None:
        variant = ("staged" if B >= STAGED_MIN_ROWS and staged_smem <= SMEM_LIMIT
                   else "direct")
    if variant == "staged":
        if staged_smem > SMEM_LIMIT:
            raise ValueError(f"a slice of m={m} x c={c} codebook rows needs "
                             f"{staged_smem} B of shared memory, above {SMEM_LIMIT}")
        slices = -(-d_c // (SLICE_BYTES // elem))
        rows = -(-B // max(1, sms // slices))
        units = slices * -(-B // rows)
        return Launch("staged", min(units, sms), 512 if elem == 1 else 1024,
                      staged_smem, slices, rows)
    if variant != "direct":
        raise ValueError(f"unknown hash_decode variant {variant!r}")
    quads = -(-d_c // 4)
    tx = min(128, -(-quads // 32) * 32)
    ty = max(1, _DIRECT_THREADS // tx)
    if ty * m * 4 > _DIRECT_SMEM:
        ty = _DIRECT_SMEM // (m * 4) or ty
    smem = ty * m * 4 if ty * m * 4 <= _DIRECT_SMEM else 0
    return Launch("direct", -(-B // ty), tx * ty, smem, rows=ty, tx=tx)


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(codes, codebooks, w0, scales) -> None:
    if codes.dim() != 2 or codes.dtype != torch.int32:
        raise TypeError(f"codes must be (B, m) int32, got {tuple(codes.shape)} {codes.dtype}")
    if codebooks.dim() != 3 or codebooks.dtype not in _STORAGE:
        raise TypeError(f"codebooks must be (m, c, d_c) float32/bfloat16/float16/int8, "
                        f"got {tuple(codebooks.shape)} {codebooks.dtype}")
    m, c, d_c = codebooks.shape
    if codes.shape[1] != m:
        raise ValueError(f"codes have m={codes.shape[1]}, codebooks m={m}")
    quantized = codebooks.dtype == torch.int8
    if quantized != (scales is not None):
        raise ValueError("int8 codebooks need scales (m, c), and only they take scales")
    if scales is not None and (scales.dtype != torch.float32
                               or tuple(scales.shape) != (m, c)):
        raise TypeError(f"scales must be (m, c) = {(m, c)} float32, got "
                        f"{tuple(scales.shape)} {scales.dtype}")
    if w0 is not None and (w0.dtype != torch.float32 or tuple(w0.shape) != (d_c,)):
        raise TypeError(f"w0 must be ({d_c},) float32, got {tuple(w0.shape)} {w0.dtype}")
    operands = [t for t in (codes, codebooks, w0, scales) if t is not None]
    if len({t.device for t in operands}) != 1:
        raise ValueError(f"operands on several devices: {[str(t.device) for t in operands]}")


def _contiguous(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """``t`` as the kernels read it: itself if contiguous (or None), else
    one contiguous copy, counted in ``hash_decode.copies``.  The copy is
    differentiable, so a gradient reaches the strided original."""
    if t is None or t.is_contiguous():
        return t
    hash_decode.copies += 1
    return t.contiguous()


def _forward(codes, codebooks, w0, scales, variant: Optional[str] = None) -> torch.Tensor:
    """The decode; ``variant`` ("staged" or "direct") overrides
    ``launch_shape``'s choice, for timing the two against each other."""
    dev = codes.device
    if dev.type == "cpu":
        return hash_decode_ref(codes, codebooks, w0, scales)
    if dev.type != "cuda":
        raise ValueError(f"hash_decode runs on cuda (kernel) or cpu (plain), got {dev}")
    B = codes.shape[0]
    m, c, d_c = codebooks.shape
    out = torch.empty((B, d_c), dtype=torch.float32, device=dev)
    if B == 0 or d_c == 0:
        return out
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    elem = codebooks.element_size()
    shape = launch_shape(B, m, c, d_c, elem, scales is not None, _sm_count(index), variant)
    ptrs = (codes.data_ptr(), codebooks.data_ptr(), _STORAGE[codebooks.dtype],
            None if w0 is None else w0.data_ptr(),
            None if scales is None else scales.data_ptr(), out.data_ptr())
    w0_aligned = w0 is None or w0.data_ptr() % 16 == 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    if shape.variant == "staged":
        vec = int(d_c % (16 // elem) == 0 and m % 4 == 0 and m <= 16 and w0_aligned
                  and all(p % 16 == 0 for p in ptrs[:2] + ptrs[5:]))
        err = _entry("hash_decode_staged_launch", 10)(
            *ptrs, B, m, c, d_c, vec, shape.grid, shape.smem, shape.slices, shape.rows,
            index, stream)
    else:
        vec = int(d_c % 4 == 0 and codebooks.data_ptr() % (4 * elem) == 0
                  and out.data_ptr() % 16 == 0 and w0_aligned)
        err = _entry("hash_decode_launch", 9)(
            *ptrs, B, m, c, d_c, vec, shape.tx, shape.rows, int(shape.smem > 0), index, stream)
    if err != 0:
        raise RuntimeError(f"hash_decode kernel launch failed: cudaError {err}")
    hash_decode.launches += 1
    return out


BACKWARD_KERNELS = ("count", "place", "sum")     # the backward's launches, in order


def sort_sizes(B: int, m: int, c: int) -> Tuple[int, int]:
    """(int32 elements of the backward's scratch, of the sort's counts in
    it), as the library lays them out; raises ValueError, before any
    launch, where the sort cannot run: B*m codes beyond its int32 indices.
    Any (m, c): the sort's blocks take the codes in ranges that fit in
    shared memory."""
    if B * m >= 2 ** 31:
        raise ValueError(f"B*m = {B * m} codes are beyond the sort's int32 indices")
    sizes = (ctypes.c_longlong * 2)()
    _sizes_entry()(B, m, c, sizes)
    return sizes[0], sizes[1]


def backward_kernel_launches(reset: bool = False) -> dict:
    """The backward's CUDA launches by kernel (``BACKWARD_KERNELS``: the
    sort's count and place, then the sum) since the library was loaded or
    last reset, as the library counts them where it launches each; ``reset``
    sets them to 0 after reading.  ``hash_decode_backward.launches`` counts
    calls (one a call, which launches each of the three once)."""
    out = (ctypes.c_ulonglong * 3)()
    _launches_entry()(out, int(reset))
    return dict(zip(BACKWARD_KERNELS, map(int, out)))


def code_order(codes: torch.Tensor, c: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(offsets (m, c + 1) int32, rows (m, B) int32): each codebook's rows
    in a stable counting sort by their clamped code, as the backward kernel
    sorts them first; the sort kernel on CUDA codes, ``ref.code_order`` on
    CPU ones."""
    dev = codes.device
    if dev.type == "cpu":
        return code_order_ref(codes, c)
    if dev.type != "cuda":
        raise ValueError(f"code_order runs on cuda (kernel) or cpu (plain), got {dev}")
    if codes.dim() != 2 or codes.dtype != torch.int32:
        raise TypeError(f"codes must be (B, m) int32, got {tuple(codes.shape)} {codes.dtype}")
    codes = _contiguous(codes)
    B, m = codes.shape
    _, n_counts = sort_sizes(B, m, c)
    offsets = torch.zeros((m, c + 1), dtype=torch.int32, device=dev)
    rows = torch.empty((m, B), dtype=torch.int32, device=dev)
    if B == 0 or m == 0:
        return offsets, rows
    counts = torch.empty(n_counts, dtype=torch.int32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    err = _sort_entry()(codes.data_ptr(), B, m, c, offsets.data_ptr(), rows.data_ptr(),
                        counts.data_ptr(), index, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_decode sort kernel launch failed: cudaError {err}")
    return offsets, rows


def codebook_grad(codes: torch.Tensor, g: torch.Tensor, w0: Optional[torch.Tensor],
                  c: int, dtype: torch.dtype) -> torch.Tensor:
    """d_cb (m, c, d_c) in ``dtype`` (float32, bfloat16 or float16) for
    codes (B, m) int32, g (B, d_c) float32 and w0 (d_c,) float32 or None:
    the backward kernels on CUDA operands (one call counted in
    ``hash_decode_backward.launches``, each kernel's launch in
    ``backward_kernel_launches``; the sort's offsets and rows in a scratch
    tensor from the caching allocator; a strided operand copied once,
    counted in ``hash_decode.copies``), its plain version on CPU ones.
    Raises ValueError where the sort cannot run (``sort_sizes``: B*m >=
    2**31)."""
    dev = codes.device
    if dev.type == "cpu":
        return hash_decode_backward_ref(codes, g, w0, c, dtype)
    if dev.type != "cuda":
        raise ValueError(f"hash_decode_backward runs on cuda (kernel) or cpu (plain), got {dev}")
    if dtype not in _GRAD_DTYPES:
        raise TypeError(f"the codebook gradient is float32, bfloat16 or float16, not {dtype}")
    if (codes.dim() != 2 or codes.dtype != torch.int32 or g.dim() != 2
            or g.dtype != torch.float32 or g.shape[0] != codes.shape[0]):
        raise TypeError(f"codes must be (B, m) int32 and g (B, d_c) float32, got "
                        f"{tuple(codes.shape)} {codes.dtype} and {tuple(g.shape)} {g.dtype}")
    B, m = codes.shape
    d_c = g.shape[1]
    if w0 is not None and (w0.dtype != torch.float32 or tuple(w0.shape) != (d_c,)):
        raise TypeError(f"w0 must be ({d_c},) float32, got {tuple(w0.shape)} {w0.dtype}")
    n_work, _ = sort_sizes(B, m, c)
    if g.device != dev or (w0 is not None and w0.device != dev):
        raise ValueError("hash_decode_backward operands must be on one device")
    codes, g, w0 = (_contiguous(t) for t in (codes, g, w0))
    d_cb = torch.empty((m, c, d_c), dtype=dtype, device=dev)
    if B == 0 or d_c == 0 or m == 0:
        return d_cb.zero_()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    work = torch.empty(n_work, dtype=torch.int32, device=dev)
    err = _backward_entry()(
        codes.data_ptr(), g.data_ptr(), None if w0 is None else w0.data_ptr(),
        d_cb.data_ptr(), _STORAGE[dtype], B, m, c, d_c, work.data_ptr(), index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hash_decode backward kernel launch failed: cudaError {err}")
    hash_decode_backward.launches += 1
    return d_cb


def hash_decode_backward(codes: torch.Tensor, codebooks: torch.Tensor,
                         w0: Optional[torch.Tensor], g: torch.Tensor,
                         need_cb: bool = True, need_w0: bool = True,
                         scales: Optional[torch.Tensor] = None,
                         cb_dtype: Optional[torch.dtype] = None):
    """(d_codebooks or None, d_w0 in w0's dtype or None) for the output
    cotangent ``g`` (B, d_c).  ``d_codebooks`` is in ``cb_dtype`` (default:
    the codebooks' dtype).  For int8 ``codebooks`` with their ``scales``,
    ``cb_dtype`` is the float masters' and ``d_w0`` sums ``g`` against the
    int8 decode."""
    g = g.float().contiguous()
    d_cb = d_w0 = None
    if need_cb:
        dtype = cb_dtype or codebooks.dtype
        sums = dtype if dtype in _GRAD_DTYPES else torch.float32
        d_cb = codebook_grad(codes, g, None if w0 is None else w0.float().contiguous(),
                             codebooks.shape[1], sums).to(dtype)
    if need_w0 and w0 is not None:
        summed = _forward(codes, codebooks, None, scales)
        d_w0 = (g * summed).sum(dim=0).to(w0.dtype)
    return d_cb, d_w0


class _HashDecode(torch.autograd.Function):
    """``(codes, codebooks, w0, scales, masters)``: ``masters`` is None, or
    for int8 ``codebooks`` the float tensor they were quantized from, which
    takes the codebook gradient in their place."""

    @staticmethod
    def forward(ctx, codes, codebooks, w0, scales, masters):
        ctx.save_for_backward(codes, codebooks, w0, scales)
        ctx.cb_dtype = None if masters is None else masters.dtype
        return _forward(codes, codebooks, w0, scales)

    @staticmethod
    def backward(ctx, g):
        codes, codebooks, w0, scales = ctx.saved_tensors
        cb_slot = 1 if scales is None else 4
        d_cb, d_w0 = hash_decode_backward(
            codes, codebooks, w0, g, need_cb=ctx.needs_input_grad[cb_slot],
            need_w0=ctx.needs_input_grad[2], scales=scales, cb_dtype=ctx.cb_dtype)
        grads = [None, None, d_w0, None, None]
        grads[cb_slot] = d_cb
        return tuple(grads)


def hash_decode(codes: torch.Tensor, codebooks: torch.Tensor,
                w0: Optional[torch.Tensor] = None,
                scales: Optional[torch.Tensor] = None,
                masters: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes (B, m) int32, codebooks (m, c, d_c) f32/bf16/f16/int8 (+
    scales (m, c) f32 for int8), w0 (d_c,) f32 or None -> (B, d_c) f32, in
    any layout.

    CUDA operands launch the kernel on the current stream (no
    synchronisation; ``hash_decode.launches`` counts the launches, and
    ``hash_decode.copies`` the strided operands copied to contiguous ones
    first); CPU operands run the plain version, which reads them as they
    are.  Differentiable in ``codebooks`` and ``w0``.  int8 codebooks take
    no gradient; ``masters`` (m, c, d_c), the float tensor they were
    quantized from, takes it straight through."""
    _check(codes, codebooks, w0, scales)
    if masters is not None and (scales is None or masters.shape != codebooks.shape):
        raise ValueError("masters go with int8 codebooks and scales, in their shape")
    if codes.device.type == "cuda":
        codes, codebooks, w0, scales = (_contiguous(t) for t in (codes, codebooks, w0, scales))
    return _HashDecode.apply(codes, codebooks, w0, scales, masters)


hash_decode.launches = 0
hash_decode.copies = 0
hash_decode_backward.launches = 0
