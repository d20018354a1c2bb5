"""Ablations of the lsh_encode projection kernel on the card: what each
part of its design is worth at the two path shapes.

    PYTHONPATH=src python -m repro_torch.kernels.lsh_encode.ablate

Each variant is ``csrc/lsh_encode.cu`` with one text edit, built with the
port's nvcc flags (``kernels/build.py``) and called through its C entry
point ``lsh_project_launch`` on the same Gaussian A and V (W = 128, all
four words of a (256, 16) code): the reconstruction's (200,000, 300) and
the vocabulary's (152,064, 512).  The variants are timed in turns with
CUDA events, beside ``torch.mm(A, V)`` (f32, TF32 off), three rounds;
lower is better.  ``unfused`` rounds each product before adding it, so
its sums differ in the last bits; it exists to time what the FMA is
worth.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import build
from repro_torch.kernels.lsh_encode import ops

SHAPES = [(200_000, 300, 128), (152_064, 512, 128)]

# name -> the edits (old text, new text) that make it from the shipped source
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "shipped": [],
    # a ring of three stages: two tiles load while one computes
    "three_stages": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    # 16-deep k tiles: twice the __syncthreads a k
    "bk16": [("constexpr int kBK = 32;", "constexpr int kBK = 16;")],
    # 64-deep k tiles: half the __syncthreads a k, twice the bytes a stage
    "bk64": [("constexpr int kBK = 32;", "constexpr int kBK = 64;")],
    # at BN = 128 a warp covers 4 x 8 threads (32 rows x 64 columns), not 2 x 16
    "warp_4x8": [("  const int tn = tid % TN;\n  const int tm = tid / TN;                   // 0..15",
                  "  const int tn = TN == 16 ? ((tid >> 5) & 1) * 8 + (tid & 7) : tid % TN;\n"
                  "  const int tm = TN == 16 ? (tid >> 6) * 4 + ((tid & 31) >> 3) : tid / TN;")],
    # 16 rows a thread (256 rows a block): 128 accumulators, half the V reads a FMA
    "tm16": [("constexpr int kTM = 8;", "constexpr int kTM = 16;")],
    # A read four k at a time (float4): fewer reads, 16 more live registers
    "float4_a": [("constexpr int kAK = 2;", "constexpr int kAK = 4;")],
    # two blocks an SM, each held to 128 registers (it spills)
    "two_blocks_an_sm": [("__launch_bounds__(2 * BN)\nlsh_project_kernel",
                          "__launch_bounds__(2 * BN, 256 / BN)\nlsh_project_kernel")],
    # one block a row tile instead of a persistent grid
    "not_persistent": [("kernel<<<min(tiles, resident[vec]), 2 * BN,",
                        "kernel<<<tiles, 2 * BN,")],
    # each product rounded, then added (twice the f32 instructions)
    "unfused": [("acc[i][j] = __fmaf_rn(a[i][q], v[j], acc[i][j]);",
                 "acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i][q], v[j]));")],
}


def variant_sources(text: str) -> Dict[str, str]:
    """Each variant's source; raises if an edit no longer applies."""
    return build.apply_edits(text, VARIANTS)


def _entry(path: Path):
    fn = ctypes.CDLL(str(path)).lsh_project_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("ablate: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = {name: _entry(path)
           for name, path in build.build_variants(ops.NAME, ops.SOURCE, VARIANTS).items()}
    stream = torch.cuda.current_stream().cuda_stream

    def timed(call, n=20):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            call()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    rounds = []
    for n, d, w in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(0)
        A = torch.randn(n, d, generator=g, device="cuda")
        V = torch.randn(d, w, generator=g, device="cuda")
        U = torch.empty(n, w, device="cuda")

        def kernel(fn):
            def call():
                err = fn(A.data_ptr(), V.data_ptr(), U.data_ptr(), n, d, w,
                         torch.cuda.current_device(), stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return call

        for r in range(3):
            row = {name: timed(kernel(fn)) for name, fn in fns.items()}
            row["torch.mm"] = timed(lambda: torch.mm(A, V))
            rounds.append(dict(round=r, shape=[n, d, w], ms=row))
            print(f"[ablate] round {r} n={n} d={d} W={w}: "
                  + ", ".join(f"{name} {ms:.4f}" for name, ms in row.items()), flush=True)
        del A, V, U
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rounds": rounds}), flush=True)


if __name__ == "__main__":
    main()
