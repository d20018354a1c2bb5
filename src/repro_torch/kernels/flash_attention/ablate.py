"""Ablations of the flash_attention kernels on the card: what each part of
their designs is worth at the training path's shape.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.ablate

Each variant is ``csrc/flash_attention.cu`` with one text edit, built with
the port's nvcc flags (``kernels/build.py``) and called through its C entry
point on the same q, k, v (B=4, S=2048, H=16, D=64): the bf16 kernel's
variants in bf16, causal and full; the f32 kernel's (``f32_*``) in f32,
causal (``shipped`` in both).  The variants are timed in turns with CUDA events, beside
``scaled_dot_product_attention`` in the same dtype, three rounds; lower is
better.  A variant that drops work (``no_exp2``, ``no_softmax``,
``f32_no_qk``, ``f32_no_pv``, ``f32_no_copy``) computes wrong values and
exists only to time what the rest costs.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
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
    "no_softmax": [("softmax_tile<BK>(sc, st, alpha, 0 > mask_from, 0, Skv, causal, qpos, col0, "
                    "scale_log2);", "alpha[0] = alpha[1] = 1.f;"),
                   ("softmax_tile<BK>(sc, st, alpha, t * BK > mask_from, t * BK, Skv, causal, "
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
    "two_consumers": [("static constexpr int CONSUMERS = DT >= 128 ? 2 : 3;",
                       "static constexpr int CONSUMERS = 2;")],
    # a K/V ring of three stages (shared memory allows it at D <= 64 only)
    "three_stages": [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")],
    # no S = Q.K^T (S stays 0): what the product costs
    "f32_no_qk": [("    for (int d0 = 0; d0 < D; d0 += 8) {\n",
                   "    for (int d0 = 0; d0 < 0; d0 += 8) {\n")],
    # no O += P.V
    "f32_no_pv": [("for (int kk = 0; kk < BK; kk += 4) {", "for (int kk = 0; kk < 0; kk += 4) {")],
    # every tile computed from tile 0's buffers: what the copies cost
    "f32_no_copy": [("    if (t + 1 < n_tiles) {       // tile t + 1 is copied",
                     "    if (false) {       // tile t + 1 is copied")],
    # a block-wide barrier after P instead of the row group's warp
    "f32_barrier_p": [("__syncwarp();                // P's rows",
                       "__syncthreads();             // P's rows")],
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
    q32, k32, v32 = (torch.randn((B, S, H, D), generator=g, device="cuda") for _ in range(3))
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

    def kernel(fn, causal, q, k, v, o):
        def call():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     ops._DTYPES[q.dtype], B, H, H, S, S, D, int(causal), 1 / math.sqrt(D),
                     torch.cuda.current_device(), stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return call

    rounds = []
    for r in range(3):
        for dtype, causal in ((torch.bfloat16, True), (torch.bfloat16, False),
                              (torch.float32, True)):
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            o = torch.empty_like(q)
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            f32 = dtype == torch.float32
            row = {name: timed(kernel(fn, causal, q, k, v, o), 5 if f32 else 20)
                   for name, fn in fns.items()
                   if name == "shipped" or name.startswith("f32_") == f32}
            row["scaled_dot_product_attention"] = timed(
                lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal))
            rounds.append(dict(round=r, dtype=str(dtype), causal=causal, ms=row))
            print(f"[ablate] round {r} {dtype} causal={causal}: "
                  + ", ".join(f"{n} {ms:.4f}" for n, ms in row.items()), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card,
                      "shape": [B, S, H, D], "rounds": rounds}), flush=True)


if __name__ == "__main__":
    main()
