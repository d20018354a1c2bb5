"""Ablations of the hash_decode kernels on the card: what each part of the
staged forward design is worth, where it overtakes the direct gather, and
what the backward kernel's pass size, batch and warp count are worth, at
the paths' shapes.

    PYTHONPATH=src python -m repro_torch.kernels.hash_decode.ablate

Each variant is ``csrc/hash_decode.cu`` with one text edit (or the shipped
source launched on another geometry), built with the port's nvcc flags
(``kernels/build.py``) and called through its C entry points on the same
codes and codebooks (m = 16, c = 256, d_c = 512): one request's frontier
(B = 61,696, f32), a training batch (8,192, bf16) and a reconstruction
batch (512, f32).  Each is timed as a CUDA graph of 20 launches (so the
host's enqueue time does not hide the card's), in turns, three rounds;
lower is better.  The backward variants (the codebook gradient, f32, no
w0) run at a GraphSAGE training frontier (24,064 rows) and at one
request's 61,696, timed by CUDA events over 20 launches, in turns.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import build
from repro_torch.kernels.hash_decode import ops

SHAPES = [(61_696, "float32"), (8_192, "bfloat16"), (512, "float32")]   # (B, storage)
M, C, D_C = 16, 256, 512

# name -> the edits (old text, new text) that make it from the shipped source
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "shipped": [],
    # each code read on its own as its term is added (the element-wise path's loads)
    "codes_per_term": [("      if (VEC) {\n        // the row's m <= 16 codes at once",
                        "      if (false) {\n        // the row's m <= 16 codes at once")],
    # 512 threads a block for every storage type (16 warps an SM)
    "threads_512": [("return sizeof(T) == 1 ? 512 : 1024;", "return 512;")],
}
FORWARD_VARIANTS = tuple(VARIANTS)
BACKWARD_ROWS = (24_064, 61_696)
BACKWARD_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    # the first design's pass: 64 rows, 16 loads in flight
    "bwd_rows_64": [("constexpr int kBwdRows = 256;", "constexpr int kBwdRows = 64;"),
                    ("constexpr int kBwdBatch = 32;", "constexpr int kBwdBatch = 16;")],
    # 16 loads in flight instead of 32
    "bwd_batch_16": [("constexpr int kBwdBatch = 32;", "constexpr int kBwdBatch = 16;")],
    # 16 warps a block, each owning c/16 codes
    "bwd_warps_16": [("constexpr int kBwdWarps = 8;", "constexpr int kBwdWarps = 16;")],
}
VARIANTS.update(BACKWARD_VARIANTS)


def variant_sources(text: str) -> Dict[str, str]:
    """Each variant's source; raises if an edit no longer applies."""
    return build.apply_edits(text, VARIANTS)


def _entries(path: Path):
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    staged, direct = lib.hash_decode_staged_launch, lib.hash_decode_launch
    staged.argtypes = [p, p, i, p, p, p] + [i] * 10 + [p]
    direct.argtypes = [p, p, i, p, p, p] + [i] * 8 + [p]
    staged.restype = direct.restype = ctypes.c_int
    backward = lib.hash_decode_backward_launch
    backward.argtypes = [p, p, p, p] + [i] * 6 + [p]
    backward.restype = ctypes.c_int
    return staged, direct, backward


def time_backward(libs, dev) -> List[dict]:
    """The backward variants in turns, three rounds, at ``BACKWARD_ROWS``."""
    import torch
    rounds = []
    for B in BACKWARD_ROWS:
        gen = torch.Generator(device="cuda").manual_seed(1)
        codes = torch.randint(0, C, (B, M), generator=gen, device="cuda", dtype=torch.int32)
        g = torch.randn(B, D_C, generator=gen, device="cuda")
        out = torch.empty(M, C, D_C, device="cuda")

        def call(fn):
            err = fn(codes.data_ptr(), g.data_ptr(), None, out.data_ptr(), 0, B, M, C, D_C,
                     dev, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        for r in range(3):
            row = {}
            for name in ("shipped", *BACKWARD_VARIANTS):
                for _ in range(3):
                    call(libs[name][2])
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    call(libs[name][2])
                b.record()
                torch.cuda.synchronize()
                row[name] = a.elapsed_time(b) / 20
            rounds.append(dict(round=r, B=B, backward=True, ms=row))
            print(f"[ablate] backward round {r} B={B} float32: "
                  + ", ".join(f"{name} {ms:.4f}" for name, ms in row.items()), flush=True)
        del codes, g, out
    return rounds


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("ablate: needs a CUDA card")
    libs = {name: _entries(path)
            for name, path in build.build_variants(ops.NAME, ops.SOURCE, VARIANTS).items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.cuda.current_device()

    def graph_ms(call, n=20):
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                call()
        g.replay()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    rounds = []
    for B, storage in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        codes = torch.randint(0, C, (B, M), generator=gen, device="cuda", dtype=torch.int32)
        cb = torch.randn(M, C, D_C, generator=gen, device="cuda").to(getattr(torch, storage))
        out = torch.empty(B, D_C, device="cuda")
        elem = cb.element_size()
        ptrs = (codes.data_ptr(), cb.data_ptr(), ops._STORAGE[cb.dtype], None, None,
                out.data_ptr())

        def staged(fn, shape):
            def call():
                err = fn(*ptrs, B, M, C, D_C, 1, shape.grid, shape.smem, shape.slices,
                         shape.rows, dev, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return call

        shape = ops.launch_shape(B, M, C, D_C, elem, False, sms, "staged")
        # twice the row ranges: 2 units a block, each staging its own slice
        finer = ops.launch_shape(B, M, C, D_C, elem, False, 2 * sms, "staged")
        finer = finer._replace(grid=min(finer.grid, sms))
        direct = ops.launch_shape(B, M, C, D_C, elem, False, sms, "direct")

        def direct_call():
            err = libs["shipped"][1](*ptrs, B, M, C, D_C, 1, direct.tx, direct.rows, dev,
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")

        calls = {name: staged(libs[name][0], shape) for name in FORWARD_VARIANTS}
        calls["units_x2"] = staged(libs["shipped"][0], finer)
        calls["direct"] = direct_call
        for r in range(3):
            row = {name: graph_ms(call) for name, call in calls.items()}
            rounds.append(dict(round=r, B=B, storage=storage, ms=row))
            print(f"[ablate] round {r} B={B} {storage}: "
                  + ", ".join(f"{name} {ms:.4f}" for name, ms in row.items()), flush=True)
        del codes, cb, out
    rounds += time_backward(libs, dev)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rounds": rounds}), flush=True)


if __name__ == "__main__":
    main()
