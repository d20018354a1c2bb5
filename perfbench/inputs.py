"""Inputs made from ``--seed``: the derived seeds, and weights drawn on
the device in one call, so both the program and the reference get the
same numbers and set-up makes them in one large draw."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[str, Tuple[int, ...], float]   # name, shape, scale (0: zeros)


def derived_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from any whole number."""
    words = np.random.SeedSequence(seed % (1 << 64)).generate_state(n, np.uint64)
    return [int(w) >> 1 for w in words]


def draw(specs: Sequence[Spec], seed: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of ``specs`` from one float32 ``randn`` on ``device``: a
    leaf is its slice of the draw (a view of one buffer) times its scale; a
    scale of 0 gives zeros."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    total = sum(int(np.prod(shape)) for _, shape, scale in specs if scale)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, scale in specs:
        size = int(np.prod(shape))
        if scale:
            out[name] = flat[at:at + size].mul_(scale).view(shape)
            at += size
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
