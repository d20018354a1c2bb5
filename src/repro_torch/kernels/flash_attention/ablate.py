"""Ablations of the bf16 flash_attention kernel on the card: what each part
of its design is worth at the training path's shape.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate

Each variant is ``csrc/flash_attention.cu`` with one text edit, built with
the port's nvcc flags (``kernels/build.py``) and called through its C entry
point on the same bf16 q, k, v (B=4, S=2048, H=16, D=64), causal and full.
The variants are timed in turns with CUDA events, beside
``scaled_dot_product_attention``, three rounds; lower is better.  A variant
that drops work (``no_exp2``, ``no_softmax``) computes wrong values and
exists only to time what the rest costs.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops

# name -> the edits (old text, new text) that make it from the shipped source
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "shipped": [],
    # exp2 on the FMA pipe as a multiply: what the MUFU unit costs
    "no_exp2": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                 "y = x * 0.5f;")],
    # no mask, max, exp2 or sums: the wgmma and TMA pipeline alone
    "no_softmax": [("softmax_tile(sc, st, alpha, 0 > mask_from, 0, Skv, causal, qpos, col0, "
                    "scale_log2);", "alpha[0] = alpha[1] = 1.f;"),
                   ("softmax_tile(sc, st, alpha, t * BK > mask_from, t * BK, Skv, causal, "
                    "qpos, col0,\n                     scale_log2);",
                    "alpha[0] = alpha[1] = 1.f;")],
    # every consumer warpgroup computes every key tile of its unit
    "no_wg_skip": [("const int n_mine = causal ? min(w.n_tiles, (min(Skv, qrow0 + 64) + BK - 1) "
                    "/ BK) : w.n_tiles;", "const int n_mine = w.n_tiles;")],
    # units dealt round-robin instead of in a snake
    "round_robin": [("return n * gridDim.x + ((n & 1) ? gridDim.x - 1 - blockIdx.x : "
                     "blockIdx.x);", "return n * gridDim.x + blockIdx.x;")],
    # one unit per block (not persistent), heaviest first
    "one_unit_per_block": [("<<<min(n_units, sms), ", "<<<n_units, ")],
    # two consumer warpgroups (128 query rows a block) at D = 64 too
    "two_consumers": [("static constexpr int CONSUMERS = D == 128 ? 2 : 3;",
                       "static constexpr int CONSUMERS = 2;")],
    # a K/V ring of three stages (shared memory allows it at D <= 64 only)
    "three_stages": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
}


def variant_sources(text: str) -> Dict[str, str]:
    """Each variant's source; raises if an edit no longer applies."""
    return build.apply_edits(text, VARIANTS)


def _entry(path: Path):
    fn = ctypes.CDLL(str(path)).flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> None:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("ablate: needs a CUDA card")
    built = build.build_variants(ops.NAME, ops.SOURCE, VARIANTS)
    fns = {name: _entry(path) for name, path in built.items()}

    B, S, H, D = 4, 2048, 16, 64
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda").bfloat16()
               for _ in range(3))
    o = torch.empty_like(q)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
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

    def kernel(fn, causal):
        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1, B, H, H, S,
                     S, D, int(causal), 1 / math.sqrt(D), torch.cuda.current_device(), stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return call

    rounds = []
    for r in range(3):
        for causal in (True, False):
            row = {name: timed(kernel(fn, causal)) for name, fn in fns.items()}
            row["scaled_dot_product_attention"] = timed(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal))
            rounds.append(dict(round=r, causal=causal, ms=row))
            print(f"[ablate] round {r} causal={causal}: "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms in row.items()), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "shape": [B, S, H, D],
                      "rounds": rounds}), flush=True)


if __name__ == "__main__":
    main()
