"""Pluggable decode backends for the paper's hot op (codes -> codebook sum).
Counterpart of the single-device part of ``repro/core/backend.py``.

    decode(codes (B, m) int32, codebooks (m, c, d_c), w0 (d_c,)?) -> (B, d_c) f32

Registered implementations:

  gather   m sequential gathers accumulated in f32 in codebook order — the
           bit-exactness oracle.
  onehot   one (B, m*c) x (m*c, d_c) f32 matmul.
  pallas   the hand-written Hopper ``hash_decode`` kernel
           (``kernels/hash_decode``), with its autograd backward.  It keeps
           the JAX package's name so a JAX ``RuntimeSpec`` selects its
           counterpart unchanged; on CPU tensors the wrapper runs the
           kernel's plain version.

``auto`` resolves to ``pallas`` on a CUDA device and to ``onehot`` on the
CPU, as the JAX package picks its kernel only on its accelerator.

Every backend carries a ``MixedPrecisionPolicy``: codebooks may be stored
bf16 or absmax-int8 (int8 is fused into the kernel; gather and onehot
decode the dequantized values, which are the same f32 products), but the
sum is always f32.

The collective backends (``sharded``, ``owner``) and the other compression
families (``hashemb``, ``tt``) belong to later slices of the port and raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels.hash_decode import ops as hd_ops
from repro_torch.kernels.hash_decode.ref import hash_decode_ref

# Later slices of the port (ROADMAP.md queue A).
NOT_PORTED = {
    "sharded": "the multi-GPU slice (ROADMAP A.14)",
    "owner": "the multi-GPU slice (ROADMAP A.14)",
    "hashemb": "the families-and-precision slice (ROADMAP A.13)",
    "tt": "the families-and-precision slice (ROADMAP A.13)",
}

FAMILY_BACKENDS = ("hashemb", "tt")

# Documented decode drift bounds vs the all-f32 path: max-abs output error
# <= bound * max-abs(f32 output) per decode.
DRIFT_BOUNDS = {"bfloat16": 1.5e-2, "int8": 5e-2}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class BackendCapabilities:
    """Metadata consumed by selection logic and call-sites."""
    grad: bool = True            # differentiable w.r.t. codebooks / w0
    fused: bool = False          # single fused kernel
    accelerator: Tuple[str, ...] = ("cpu", "cuda")


@dataclasses.dataclass(frozen=True)
class MixedPrecisionPolicy:
    """Dtype contract of a decode path.

    ``param_dtype``    storage dtype of codebooks/w0 entering the decode
                       (None = whatever the caller passed)
    ``compute_dtype``  activation dtype of the caller (informational: the
                       decode always returns f32)
    ``reduce_dtype``   accumulation dtype; always float32
    ``quantize``       "none" | "int8" (absmax per (codebook, code))
    """
    param_dtype: Optional[str] = None
    compute_dtype: Optional[str] = None
    reduce_dtype: str = "float32"
    quantize: str = "none"

    def __post_init__(self):
        if self.quantize not in ("none", "int8"):
            raise ValueError(
                f"quantize={self.quantize!r} not supported (expected 'none' "
                f"or 'int8')")
        if self.reduce_dtype != "float32":
            raise ValueError("reduce_dtype must be 'float32': every backend "
                             "accumulates in f32")


DEFAULT_POLICY = MixedPrecisionPolicy()


class DecodeBackend:
    """Protocol: subclasses set ``name``/``capabilities`` and implement
    ``decode``."""

    name: str = "abstract"
    capabilities = BackendCapabilities()
    policy: MixedPrecisionPolicy = DEFAULT_POLICY

    def __init__(self, policy: Optional[MixedPrecisionPolicy] = None):
        self.policy = policy or DEFAULT_POLICY

    def decode(self, codes: torch.Tensor, codebooks: torch.Tensor,
               w0: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def _prep(self, codebooks, w0):
        """Cast params to the policy's storage dtype."""
        p = self.policy
        if p.param_dtype is not None:
            dt = torch_dtype(p.param_dtype)
            codebooks = codebooks.to(dt)
            w0 = None if w0 is None else w0.to(dt)
        return codebooks, w0

    def _prep_values(self, codebooks, w0):
        """Storage cast, then the decode-visible int8 values (q * s)."""
        codebooks, w0 = self._prep(codebooks, w0)
        if self.policy.quantize == "int8":
            codebooks = hd_ops.dequantize_codebooks(
                *hd_ops.quantize_codebooks(codebooks))
        return codebooks, w0


class GatherBackend(DecodeBackend):
    """Oracle: m sequential gathers, f32 accumulation in codebook order —
    the kernel's plain version run on the decode-visible values."""

    name = "gather"

    def decode(self, codes, codebooks, w0=None):
        codebooks, w0 = self._prep_values(codebooks, w0)
        return hash_decode_ref(codes, codebooks, w0)


class OnehotBackend(DecodeBackend):
    """One-hot x stacked-codebook matmul: the sum over m is one
    (B, m*c) x (m*c, d_c) f32 contraction."""

    name = "onehot"

    def decode(self, codes, codebooks, w0=None):
        codebooks, w0 = self._prep_values(codebooks, w0)
        m, c, d_c = codebooks.shape
        B = codes.shape[0]
        iota = torch.arange(c, dtype=codes.dtype, device=codes.device)
        onehot = (codes[:, :, None] == iota).to(torch.float32)
        out = onehot.reshape(B, m * c) @ codebooks.float().reshape(m * c, d_c)
        if w0 is not None:
            out = out * w0.float()[None, :]
        return out


class KernelBackend(DecodeBackend):
    """The hand-written Hopper ``hash_decode`` kernel (registered as
    ``"pallas"``).  int8 storage goes to the kernel as int8 values plus the
    (m, c) scale table; it dequantizes in-register.  Any batch size and
    feature width run as they are (the kernel masks ragged edges).

    Differentiable: the wrapper's ``torch.autograd.Function`` gives the
    codebooks and ``w0`` their gradients on both devices.  The int8
    straight-through backward is not ported yet, so an int8 decode that
    needs a gradient raises instead of returning none."""

    name = "pallas"
    capabilities = BackendCapabilities(grad=True, fused=True)

    def decode(self, codes, codebooks, w0=None):
        codebooks, w0 = self._prep(codebooks, w0)
        scales = None
        if self.policy.quantize == "int8":
            if hd_ops.needs_grad(codebooks, w0):
                raise NotImplementedError(hd_ops.INT8_GRAD)
            codebooks, scales = hd_ops.quantize_codebooks(codebooks)
        elif codebooks.dtype not in (torch.float32, torch.bfloat16):
            codebooks = codebooks.float()
        return hd_ops.hash_decode(
            codes.to(torch.int32).contiguous(), codebooks.contiguous(),
            None if w0 is None else w0.float().contiguous(), scales)


# ---------------------------------------------------------------------------
# registry / selection
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., DecodeBackend]] = {}


def register_backend(name: str, factory: Callable[..., DecodeBackend]) -> None:
    """Register a backend factory; ``factory(policy=...) -> DecodeBackend``."""
    _REGISTRY[name] = factory


register_backend("gather", GatherBackend)
register_backend("onehot", OnehotBackend)
register_backend("pallas", KernelBackend)


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def family_of(lookup_impl: Optional[str]) -> str:
    """Compression family a ``lookup_impl`` string selects: "hashemb",
    "tt", or "paper" (every other spelling)."""
    for part in (lookup_impl or "auto").split(":"):
        if part in FAMILY_BACKENDS:
            return part
    return "paper"


def resolve_auto(device: torch.device) -> str:
    """``auto``: the hand-written kernel on a CUDA device, the one-hot
    matmul on the CPU."""
    return "pallas" if torch.device(device).type == "cuda" else "onehot"


def get_backend(spec, *, device: torch.device,
                policy: Optional[MixedPrecisionPolicy] = None) -> DecodeBackend:
    """Resolve a backend from a config string (or pass an instance through).
    ``device`` is where the decode will run (it decides ``auto``)."""
    if isinstance(spec, DecodeBackend):
        return spec
    name = spec or "auto"
    if name == "auto":
        name = resolve_auto(device)
    base, _, option = name.partition(":")
    if base in NOT_PORTED:
        raise NotImplementedError(
            f"decode backend {name!r} is not ported yet; it comes with "
            f"{NOT_PORTED[base]}")
    if base not in _REGISTRY:
        raise ValueError(
            f"unknown decode backend {name!r}; known: {available_backends()}")
    if option:
        raise ValueError(f"decode backend {base!r} takes no ':{option}' option")
    return _REGISTRY[base](policy=policy)
