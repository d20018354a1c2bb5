"""flash_attention's kernels timed at the shapes the port runs them at, each
beside its plain version, ``scaled_dot_product_attention`` in the same dtype,
and its bound on the H100 (``launch.mesh``'s rates).

    PYTHONPATH=src python src/repro_torch/kernels/flash_attention/sweep.py

Run by its path, the file times the kernels of whichever package PYTHONPATH
names, so that one call can time two checkouts in turns; a shape that a
checkout's wrapper refuses (an earlier one's float16 or D > 128) prints as
refused.  It prints a line a shape, then
one JSON object with every row and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# (B, H, K, S, D, causal, dtype, where the port runs it)
SHAPES = [
    (4, 16, 16, 2048, 64, True, "bfloat16", "lm_train, qwen1.5-0.5b"),
    (4, 16, 16, 2048, 64, True, "float32", "lm_train's shape in f32"),
    (4, 32, 32, 2048, 112, True, "bfloat16", "hybrid_train, zamba2-7b"),
    (4, 32, 32, 2048, 112, True, "float32", "hybrid_train's shape in f32"),
    (2, 8, 2, 2048, 128, True, "float32", "GQA at D = 128"),
    (2, 4, 4, 1000, 80, False, "float32", "full attention at D = 80"),
    (4, 4, 4, 256, 32, True, "float32", "lm_reference, reduced qwen1.5-0.5b"),
    (4, 4, 4, 128, 32, True, "float32", "families_reference, reduced granite, zamba2"),
    (4, 16, 16, 2048, 64, True, "float16", "lm_train's shape in f16 (no config)"),
    (4, 16, 16, 2048, 256, True, "bfloat16", "D = 256, the 256-wide tile (no config)"),
    (4, 16, 16, 2048, 256, True, "float16", "D = 256 in f16 (no config)"),
    (4, 16, 16, 2048, 256, True, "float32", "D = 256 in f32 (no config)"),
    (4, 16, 16, 2048, 320, True, "bfloat16", "D = 320, the panel kernel (no config)"),
]


def bound(B, H, K, S, D, causal, dtype) -> dict:
    """The least time of the function on the H100: the larger of its bytes
    (q, k, v read once, o written once) over HBM's rate and its flops (Q.K^T
    and P.V, the causal half's pairs only) over the dtype's peak."""
    from repro_torch.launch.mesh import F32_FLOPS, HBM_BW, PEAK_FLOPS_BF16
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * D * pairs * B * H
    nbytes = (2 * H + 2 * K) * B * S * D * (4 if dtype == "float32" else 2)
    ops_ms = flops / (F32_FLOPS if dtype == "float32" else PEAK_FLOPS_BF16) * 1e3
    bytes_ms = nbytes / HBM_BW * 1e3
    return dict(flops=flops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def _timed(fn, iters: int):
    """(mean device ms by CUDA events, mean host ms to enqueue one call)
    over ``iters`` back-to-back calls after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def _graph_timed(fn, iters: int):
    """Mean device ms of ``fn`` captured ``iters`` times into one CUDA graph
    and replayed: the card's time alone, where the host takes longer to
    enqueue a call than the card to run it.  None if the capture fails."""
    import torch
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for _ in range(iters):
                fn()
    except RuntimeError:
        return None
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_flash(B, H, K, S, D, causal, dtype, iters: int = 20, seed: int = 0) -> dict:
    """The port's ``flash_attention`` on the card at one shape: its time
    back to back and as a CUDA graph, its plain version's, SDPA's (GQA by
    ``enable_gqa``) both ways, the largest difference between the kernel
    and SDPA, and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn((B, S, H, D), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, S, K, D), generator=g, device="cuda").to(dt) for _ in range(2))
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, enable_gqa=K != H)

    out = ops.flash_attention(q, k, v, causal=causal)
    library_err = float((library().transpose(1, 2).float() - out.float()).abs().max())
    ms, enqueue_ms = _timed(lambda: ops.flash_attention(q, k, v, causal=causal), iters)
    graph_ms = _graph_timed(lambda: ops.flash_attention(q, k, v, causal=causal), iters)
    plain_ms, _ = _timed(lambda: attention_ref(q, k, v, causal=causal), max(2, iters // 4))
    library_ms, _ = _timed(library, iters)
    library_graph_ms = _graph_timed(library, iters)
    row = dict(shape=[B, H, K, S, D], causal=causal, dtype=dtype, ms=ms, enqueue_ms=enqueue_ms,
               graph_ms=graph_ms, plain_ms=plain_ms, library_ms=library_ms,
               library_graph_ms=library_graph_ms, library_err=library_err,
               **bound(B, H, K, S, D, causal, dtype))
    row["tflops"] = row["flops"] / ms / 1e9
    return row


def describe(row: dict) -> str:
    B, H, K, S, D = row["shape"]

    def graph(ms):
        return "capture failed" if ms is None else f"{ms:.4f} ms"
    return (f"flash_attention B={B} H={H} K={K} S={S} D={D} "
            f"{'causal' if row['causal'] else 'full'} {row['dtype']}: kernel {row['ms']:.4f} ms "
            f"(host enqueues in {row['enqueue_ms']:.4f} ms; as a CUDA graph "
            f"{graph(row['graph_ms'])}), plain {row['plain_ms']:.4f} ms, "
            f"scaled_dot_product_attention {row['library_ms']:.4f} ms (as a CUDA graph "
            f"{graph(row['library_graph_ms'])}; max diff to kernel {row['library_err']}); "
            f"bound {row['bound_ms']:.4f} ms by {row['bound_by']} ({row['flops']} flops, "
            f"{row['bytes']} B); kernel at {row['tflops']:.1f} TFLOP/s, "
            f"{row['ms'] / row['bound_ms']:.2f}x its bound, "
            f"{row['ms'] / row['library_ms']:.2f}x scaled_dot_product_attention")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("sweep: needs a CUDA card")
    rows = []
    for *shape, where in SHAPES:
        try:
            row = time_flash(*shape)
        except (ValueError, TypeError) as e:   # a head dim or dtype this checkout refuses
            print(f"[sweep] {shape} ({where}): refused: {e}", flush=True)
            continue
        row["where"] = where
        rows.append(row)
        print(f"[sweep] {describe(row)} ({where})", flush=True)
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "card": card, "rows": rows}),
          flush=True)


if __name__ == "__main__":
    main()
