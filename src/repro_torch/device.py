"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  A
machine without CUDA gets an error that names the CPU opt-in; nothing ever
carries on quietly on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is requested but missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return dev


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    """A seeded generator on ``device`` (CUDA draws need a CUDA generator)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions (TF32 keeps ~3 decimal digits and
    would break parity with the f32 reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
