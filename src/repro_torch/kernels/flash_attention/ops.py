"""Wrapper of the Hopper flash-attention kernels (``csrc/flash_attention.cu``).

Public layout is ``nn.attention``'s: q (B, S, H, D), k/v (B, S, K, D).
``flash_attention`` checks its operands and goes through ``_FlashAttention``
(a ``torch.autograd.Function``): the forward launches a CUDA kernel on
CUDA tensors and runs the plain version ``ref.attention_ref`` on CPU
tensors; there is no other route, so a CUDA call launches a kernel or
raises.  The dtype picks the kernel: bfloat16 runs the tensor-core kernel
(wgmma on TMA-fed tiles), float32 the CUDA-core kernel (f32 FMAs; on the
tensor cores f32 would be TF32).  Both kernels take any head dim D <= 128
with D % 8 == 0 (``MAX_HEAD_DIM``, ``HEAD_DIM_STEP``); the plain version on
the CPU takes any D, as the JAX wrapper does.  The backward recomputes the
plain version under autograd, as the JAX wrapper recomputes ``mha_ref`` in
XLA (a backward kernel is later work).
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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each dtype launches, as counted in ``flash_attention.launches_by_kernel``
KERNELS = {torch.bfloat16: "bf16_wgmma", torch.float32: "f32_cuda_core"}
# the head dims the kernels take: D <= 128 and D % 8 == 0 (the bf16 kernel's
# TMA row stride, D * 2 bytes, must be a multiple of 16)
MAX_HEAD_DIM, HEAD_DIM_STEP = 128, 8
ALIGN = 16          # bytes: both kernels' bases (tensor maps; 16-byte copies)


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


def _is_fake(t) -> bool:
    """A tensor without storage (the dry run's): it has no address to align."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


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
        raise TypeError(f"q, k, v must share one of float32/bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k, v on several devices")
    if q.device.type != "cpu" and (D > MAX_HEAD_DIM or D % HEAD_DIM_STEP):
        raise ValueError(f"head dim {D}: the flash_attention kernels take D <= "
                         f"{MAX_HEAD_DIM} with D % {HEAD_DIM_STEP} == 0")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention operands must be contiguous")
    # the bf16 kernel reads by TMA, the f32 kernel by 16-byte copies; the
    # plain version takes f32 at any address on the CPU
    aligned = q.dtype == torch.bfloat16 or q.device.type != "cpu"
    if aligned and not _is_fake(q) and any(t.data_ptr() % ALIGN for t in (q, k, v)):
        raise ValueError(f"{str(q.dtype).removeprefix('torch.')} flash_attention operands "
                         f"must start {ALIGN}-byte aligned (the kernels read them by TMA "
                         f"or 16-byte copies)")


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or Sq == 0:
        return out
    if Skv == 0:
        raise ValueError("flash_attention needs at least one key")
    dev = q.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   _DTYPES[q.dtype], B, H, K, Sq, Skv, D, int(causal),
                   1.0 / math.sqrt(D),
                   dev.index if dev.index is not None else torch.cuda.current_device(),
                   stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: {_describe(err)}")
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[KERNELS[q.dtype]] += 1
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
    """q (B, Sq, H, D), k/v (B, Skv, K, D), float32 or bfloat16 -> (B, Sq,
    H, D) in q's dtype.  Differentiable.  On the card D <= 128 with D % 8
    == 0; on the CPU any D.

    CUDA operands launch a kernel on the current stream (no
    synchronisation; ``flash_attention.launches`` counts the launches and
    ``flash_attention.launches_by_kernel`` splits them by kernel); CPU
    operands run the plain version."""
    _check(q, k, v)
    return _FlashAttention.apply(q, k, v, causal)


flash_attention.launches = 0
flash_attention.launches_by_kernel = dict.fromkeys(KERNELS.values(), 0)
