"""Wrapper of the Hopper flash-attention kernels (``csrc/flash_attention.cu``).

Public layout is ``nn.attention``'s: q (B, S, H, D), k/v (B, S, K, D).
``flash_attention`` checks its operands and goes through ``_FlashAttention``
(a ``torch.autograd.Function``): the forward launches a CUDA kernel on
CUDA tensors and runs the plain version ``ref.attention_ref`` on CPU
tensors; there is no other route, so a CUDA call launches a kernel or
raises.  The dtype and the head dim pick the kernel (``kernel_of``):
bfloat16 and float16 run the tensor-core kernel (wgmma on TMA-fed tiles),
float32 the CUDA-core kernel (f32 FMAs; on the tensor cores f32 would be
TF32), each at any D <= 256 (``TILE_MAX_HEAD_DIM``); a D above it runs the
panel kernel, which streams D through shared memory, in any of the three.
The plain version takes the same inputs.  Operands may have any layout:
on the card the wrapper copies each that is strided or not 16-byte aligned
to a fresh contiguous tensor, and zero-pads a D % 8 != 0 up to the step
the kernels take (the TMA rows and 16-byte copies), slicing the output back;
``flash_attention.copies`` counts every such copy.  The scale is 1/sqrt(D)
of the true D.  Float64 and mixed dtypes are refused.  The backward
recomputes the plain version under autograd, as the JAX wrapper recomputes
``mha_ref`` in XLA (a backward kernel is later work).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import build_shared_library, load_library
from repro_torch.kernels.flash_attention.ref import attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NAME = "flash_attention"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the tiled kernel each dtype launches, as counted in
# ``flash_attention.launches_by_kernel``; a head dim padded above
# TILE_MAX_HEAD_DIM launches PANELS whatever the dtype
KERNELS = {torch.bfloat16: "bf16_wgmma", torch.float16: "f16_wgmma",
           torch.float32: "f32_cuda_core"}
PANELS = "panels"
# the kernels take D % 8 == 0 (the 16-bit kernel's TMA row stride, D * 2
# bytes, must be a multiple of 16), the tiled ones D <= 256; the wrapper
# pads another D up to the step
TILE_MAX_HEAD_DIM, HEAD_DIM_STEP = 256, 8
ALIGN = 16          # bytes: the tiled kernels' bases (tensor maps; 16-byte copies)


def build() -> Tuple[Path, str]:
    """Compile the kernel library (if not built yet); ``(path, nvcc log)``."""
    return build_shared_library(NAME, SOURCE)


def _entry():
    fn = load_library(NAME, SOURCE).flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn


def kernel_of(dtype: torch.dtype, D: int) -> Tuple[str, int]:
    """(the kernel a CUDA call at head dim D launches, as counted in
    ``launches_by_kernel``; the width it runs D at: the tile of 32, 64,
    128 or 256 that holds D padded to the step, or the padded D itself in
    panels)."""
    padded = -(-D // HEAD_DIM_STEP) * HEAD_DIM_STEP
    if padded > TILE_MAX_HEAD_DIM:
        return PANELS, padded
    return KERNELS[dtype], next(t for t in (32, 64, 128, 256) if padded <= t)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, S, H, D) and k, v (B, S, K, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, D = q.shape
    K = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         f"(batch, head dim, or H % K != 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of float32/bfloat16/float16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v on several devices")


def _operand(t: torch.Tensor, pad: int) -> torch.Tensor:
    """``t`` as the kernels read it: itself if contiguous and 16-byte
    aligned, else one fresh contiguous copy (zero-padded by ``pad`` head-dim
    columns), counted in ``flash_attention.copies``.  The copy is allocated
    row-major whatever ``t``'s strides suggest (``F.pad`` would keep a
    channels_last-like layout, which the kernels would misread)."""
    if not pad and t.is_contiguous() and t.data_ptr() % ALIGN == 0:
        return t
    D = t.shape[-1]
    out = t.new_zeros(*t.shape[:-1], D + pad)
    out[..., :D].copy_(t)
    flash_attention.copies += 1
    return out


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if B == 0 or Sq == 0:
        return torch.empty_like(q, memory_format=torch.contiguous_format)
    if Skv == 0:
        raise ValueError("flash_attention needs at least one key")
    kernel, _ = kernel_of(q.dtype, D)
    pad = -D % HEAD_DIM_STEP
    q, k, v = (_operand(t, pad) for t in (q, k, v))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   _DTYPES[q.dtype], B, H, K, Sq, Skv, D + pad, int(causal),
                   1.0 / math.sqrt(D),
                   dev.index if dev.index is not None else torch.cuda.current_device(),
                   stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {_describe(err)}")
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[kernel] += 1
    if pad:
        out = out[..., :D].contiguous()
        flash_attention.copies += 1
    return out


def _describe(err: int) -> str:
    if err >= 2000:
        return f"cudaGetDriverEntryPoint found no cuTensorMapEncodeTiled (status {err - 2000})"
    if err >= 1000:
        return f"cuTensorMapEncodeTiled failed (CUresult {err - 1000})"
    return f"cudaError {err}"


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return attention_ref(q, k, v, causal=causal)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention runs on cuda (kernel) or cpu "
                             f"(plain), got {q.device}")
        return _launch(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_ref(*qkv, causal=ctx.causal)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, K, D), float32, bfloat16 or float16,
    any D and any layout -> (B, Sq, H, D) in q's dtype, contiguous.
    Differentiable.

    CUDA operands launch a kernel on the current stream (no
    synchronisation; ``flash_attention.launches`` counts the launches,
    ``flash_attention.launches_by_kernel`` splits them by kernel and
    ``flash_attention.copies`` counts the operands copied or padded, and
    the padded outputs cut back, on the way); CPU operands run the plain
    version, which reads them as they are."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0
flash_attention.launches_by_kernel = dict.fromkeys([*KERNELS.values(), PANELS], 0)
flash_attention.copies = 0
