"""Wrapper of the Hopper hash-decode kernel (``csrc/hash_decode.cu``).

``hash_decode`` checks its operands, then either launches the CUDA kernel
(CUDA tensors) or runs the plain PyTorch version ``ref.hash_decode_ref``
(CPU tensors, which is how the tests reach it on a machine without a card).
There is no other route: a CUDA call launches the kernel or raises.

``quantize_codebooks`` / ``dequantize_codebooks`` are the per-(codebook,
code) absmax int8 scheme of the JAX package, bit for bit.

The kernel has no backward yet: serving needs none.  The codebook gradient
(a deterministic reduction, not ``index_add_`` atomics) comes with the
training path.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import build_shared_library, load_library
from repro_torch.kernels.hash_decode.ref import hash_decode_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "hash_decode.cu"
NAME = "hash_decode"

_STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_MAX_SMEM = 48 * 1024
_THREADS = 256


def build() -> Tuple[Path, str]:
    """Compile the kernel library (if not built yet); ``(path, nvcc log)``."""
    return build_shared_library(NAME, SOURCE)


def _entry():
    fn = load_library(NAME, SOURCE).hash_decode_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def quantize_codebooks(codebooks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """codebooks (m, c, d_c) any float -> (q int8 (m, c, d_c), scales f32
    (m, c)); all-zero code vectors get scale 1 so dequant is exact."""
    cb = codebooks.float()
    absmax = cb.abs().amax(dim=2)
    scales = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(cb / scales[:, :, None]), -127, 127).to(torch.int8)
    return q, scales


def dequantize_codebooks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(q int8 (m, c, d_c), scales f32 (m, c)) -> f32 (m, c, d_c)."""
    return q.float() * scales.float()[:, :, None]


def launch_shape(d_c: int) -> Tuple[int, int]:
    """(threads over features, rows per block): each thread owns 4
    consecutive features, up to 128 threads (512 features) per row pass;
    the rest of the 256-thread block takes further rows."""
    quads = -(-d_c // 4)
    tx = min(128, -(-quads // 32) * 32)
    return tx, max(1, _THREADS // tx)


def _check(codes, codebooks, w0, scales) -> None:
    if codes.dim() != 2 or codes.dtype != torch.int32:
        raise TypeError(f"codes must be (B, m) int32, got {tuple(codes.shape)} {codes.dtype}")
    if codebooks.dim() != 3 or codebooks.dtype not in _STORAGE:
        raise TypeError(f"codebooks must be (m, c, d_c) float32/bfloat16/int8, "
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
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("hash_decode operands must be contiguous")


def hash_decode(codes: torch.Tensor, codebooks: torch.Tensor,
                w0: Optional[torch.Tensor] = None,
                scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """codes (B, m) int32, codebooks (m, c, d_c) f32/bf16/int8 (+ scales
    (m, c) f32 for int8), w0 (d_c,) f32 or None -> (B, d_c) f32.

    CUDA operands launch the kernel on the current stream (no
    synchronisation; ``hash_decode.launches`` counts the launches); CPU
    operands run the plain version."""
    _check(codes, codebooks, w0, scales)
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
    tx, ty = launch_shape(d_c)
    if ty * m * 4 > _MAX_SMEM:
        raise ValueError(f"m={m} codes per row need {ty * m * 4} B of shared "
                         f"memory, above {_MAX_SMEM}")
    elem = codebooks.element_size()
    vec = int(d_c % 4 == 0 and codebooks.data_ptr() % (4 * elem) == 0
              and out.data_ptr() % 16 == 0
              and (w0 is None or w0.data_ptr() % 16 == 0))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(codes.data_ptr(), codebooks.data_ptr(),
                   _STORAGE[codebooks.dtype],
                   None if w0 is None else w0.data_ptr(),
                   None if scales is None else scales.data_ptr(),
                   out.data_ptr(), B, m, c, d_c, vec, tx, ty,
                   dev.index if dev.index is not None else torch.cuda.current_device(),
                   stream)
    if err != 0:
        raise RuntimeError(f"hash_decode kernel launch failed: cudaError {err}")
    hash_decode.launches += 1
    return out


hash_decode.launches = 0
