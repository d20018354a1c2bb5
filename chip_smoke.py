#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers
in PERF.md):

    python3 chip_smoke.py

from the root of a checkout.  It builds the port's CUDA kernels from the
sources in ``src/repro_torch``, holds each against its plain PyTorch
version at the shapes the serving path gives it, then serves the paper's
full-width hash-compressed GraphSAGE (``paper_gnn_config("sage")``: c=256,
m=16, d_c=d_m=512, 3-layer decoder, d_e=64, 2 SAGE layers x 128, fanout 15,
f32) on a 169,343-node power-law graph (the size of ogbn-arxiv) through the
port's entry points: ``GraphRuntime.from_spec`` -> ``rt.serve()`` -> 8
requests of 256 nodes and one ``serve_many`` of 4.  Weights are random,
from a seed.

Phases: device, build, kernel check, slice, kernels line.  Every check
raises on failure, so the script exits nonzero; it prints the
``{"kernels": ...}`` line and then, as its last line,
``{"ok": true, "device": {...}}`` only when every phase passed.  It needs
one card and imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
# The data sheet's 67 TFLOP/s f32 outside the tensor cores counts each FMA
# as two operations; a lone add runs at the FMA rate, so adds peak at half.
F32_ADDS_PER_S = 67e12 / 2

N_NODES = 169_343
N_CLASSES = 40
REQUEST = 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, iters: int) -> tuple:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events, after a warm-up; and the mean host time to enqueue one
    call.  When the two are close, the host's enqueue rate, not the card,
    set the device time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[device] {name} x{count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return name, count


def phase_build():
    from repro_torch.kernels.hash_decode import ops
    t0 = time.perf_counter()
    path, log = ops.build()
    secs = time.perf_counter() - t0
    print(f"[build] hash_decode -> {path.name} in {secs:.2f} s", flush=True)
    for line in log.splitlines():
        if re.search(r"registers|spill|Compiling entry", line):
            print(f"[build]   {line.strip()}", flush=True)


def _operands(B, m, c, d_c, variant, seed):
    import numpy as np
    import torch
    from repro_torch.kernels.hash_decode import ops
    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(0, c, (B, m)).astype(np.int32))
    cb = torch.from_numpy(rng.standard_normal((m, c, d_c)).astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal(d_c).astype(np.float32))
    dtype, _, with_w0 = variant.partition("+")
    scales = None
    if dtype == "bfloat16":
        cb, w0 = cb.to(torch.bfloat16), w0.to(torch.bfloat16).float()
    elif dtype == "int8":
        cb, scales = ops.quantize_codebooks(cb)
    return [None if t is None else t.cuda()
            for t in (codes, cb, w0 if with_w0 else None, scales)]


def time_at_shape(B: int, m: int, c: int, d_c: int) -> dict:
    """Kernel, plain and ``embedding_bag`` times of the f32 decode without
    w0 at one shape, and the bound computed from that shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.hash_decode import ops
    from repro_torch.kernels.hash_decode.ref import hash_decode_ref
    codes, cb, _, _ = _operands(B, m, c, d_c, "float32", seed=0)
    offsets = (torch.arange(m, device="cuda") * c)[None, :]
    idx = codes.long() + offsets
    table = cb.reshape(m * c, d_c)
    lib = F.embedding_bag(idx, table, mode="sum")
    lib_err = float((lib - ops.hash_decode(codes, cb)).abs().max())
    kernel_ms, enqueue_ms = time_ms(lambda: ops.hash_decode(codes, cb), 50)
    plain_ms, _ = time_ms(lambda: hash_decode_ref(codes, cb), 10)
    library_ms, _ = time_ms(lambda: F.embedding_bag(idx, table, mode="sum"), 50)
    bytes_moved = B * m * 4 + m * c * d_c * 4 + B * d_c * 4
    adds = B * (m - 1) * d_c
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    adds_ms = adds / F32_ADDS_PER_S * 1e3
    bound_ms = max(bytes_ms, adds_ms)
    bound_by = "bytes" if bytes_ms >= adds_ms else "operations"
    print(f"[kernel] shape ({B}, {m}, {c}, {d_c}) f32: kernel "
          f"{kernel_ms:.4f} ms (host enqueues a launch in {enqueue_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms, embedding_bag "
          f"{library_ms:.4f} ms (max diff to kernel {lib_err}), bound "
          f"{bound_ms:.4f} ms by {bound_by} ({bytes_moved} B in "
          f"{bytes_ms:.4f} ms, {adds} adds in {adds_ms:.4f} ms), "
          f"{bytes_moved / kernel_ms / 1e6:.1f} GB/s of required traffic; "
          f"{B * m * d_c * 4 / kernel_ms / 1e6:.1f} GB/s of gathered "
          f"codebook rows", flush=True)
    return dict(ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def phase_kernel_check(B_main: int):
    """hash_decode vs its plain version, bitwise, at the shapes the serving
    path gives it (one request's frontier, and the coalesced frontier of a
    ``serve_many`` of 4) and at ragged ones; times at both serving shapes."""
    import torch
    from repro_torch.kernels.hash_decode import ops
    from repro_torch.kernels.hash_decode.ref import hash_decode_ref
    m, c, d_c = 16, 256, 512
    cases = [((B_main, m, c, d_c), v) for v in
             ("float32", "float32+w0", "bfloat16", "int8+w0")]
    cases += [((4 * B_main, m, c, d_c), "float32")]
    cases += [((100, 8, 16, 96), "float32+w0"), ((33, 4, 4, 130), "int8"),
              ((7, 3, 8, 5), "bfloat16+w0")]
    max_err = 0.0
    for i, (shape, variant) in enumerate(cases):
        args = _operands(*shape, variant, seed=i)
        before = ops.hash_decode.launches
        got = ops.hash_decode(*args)
        torch.cuda.synchronize()
        check(ops.hash_decode.launches == before + 1, "kernel did not launch")
        ref = hash_decode_ref(*args)
        err = float((got - ref).abs().max())
        max_err = max(max_err, err)
        same = torch.equal(got, ref)
        print(f"[kernel] hash_decode {shape} {variant}: bitwise={same} "
              f"max_abs_err={err}", flush=True)
        check(same, f"hash_decode {shape} {variant} differs from its plain version")
        del args, got, ref
    timing = time_at_shape(B_main, m, c, d_c)
    time_at_shape(4 * B_main, m, c, d_c)
    torch.cuda.empty_cache()
    return dict(max_abs_err=max_err, **timing)


def _spec(lookup_impl: str, n_nodes: int, n_classes: int):
    import dataclasses
    from repro_torch.configs.paper_gnn import paper_gnn_config
    from repro_torch.graph.runtime import GraphSource, RuntimeSpec
    cfg = paper_gnn_config("sage", n_nodes=n_nodes, n_classes=n_classes)
    cfg = dataclasses.replace(cfg, embedding=dataclasses.replace(
        cfg.embedding, lookup_impl=lookup_impl))
    return RuntimeSpec(
        graph=GraphSource(kind="powerlaw", seed=0, n_nodes=n_nodes,
                          n_classes=n_classes, avg_degree=14, homophily=0.9),
        model=cfg)


def phase_slice():
    """The port's serving path at full width; returns the launch count."""
    import numpy as np
    import torch
    from repro_torch.core import embedding as emb_lib
    from repro_torch.device import make_generator
    from repro_torch.graph.runtime import GraphRuntime
    from repro_torch.kernels.hash_decode import ops

    spec = _spec("auto", N_NODES, N_CLASSES)
    t0 = time.perf_counter()
    rt = GraphRuntime.from_spec(spec)
    torch.cuda.synchronize()
    print(f"[slice] GraphRuntime.from_spec on {rt.device}: {rt.adj.nnz} "
          f"nonzeros, codes {tuple(rt.codes.shape)}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    check(rt.device.type == "cuda", "runtime is not on the card")
    again = emb_lib.make_codes(make_generator(spec.init_seed, rt.device),
                               rt.cfg.embedding_config(), aux=rt.adj)
    check(torch.equal(again, rt.codes), "encoding the graph twice gave other codes")
    print("[slice] encoding the graph twice gives identical codes", flush=True)

    engine = rt.serve(cache_capacity=0)
    rng = np.random.default_rng(1)
    requests = [rng.choice(N_NODES, REQUEST, replace=False) for _ in range(12)]
    torch.cuda.reset_peak_memory_stats()

    ops.hash_decode.launches = 0               # the main path's run starts here
    results, times, per_request = [], [], []
    for ids in requests[:8]:
        before = ops.hash_decode.launches
        t0 = time.perf_counter()
        results.append(engine.serve(ids))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        per_request.append(ops.hash_decode.launches - before)
    t0 = time.perf_counter()
    many = engine.serve_many(requests[8:12])
    torch.cuda.synchronize()
    many_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.hash_decode.launches         # ... and ends here
    check(all(n >= 1 for n in per_request), f"a request decoded without the kernel: {per_request}")
    check(launches >= 9, f"kernel launched {launches} times for 9 engine calls")
    stats = engine.stats()
    print(f"[slice] per-request ms (host clock, synchronised): "
          f"{[round(t, 3) for t in times]}; median of requests 3-8 "
          f"{float(np.median(times[2:])):.3f} ms", flush=True)
    print(f"[slice] serve_many(4): {many_ms:.3f} ms; kernel launches "
          f"{launches}; rows decoded per request {stats['rows_decoded_per_request']}; "
          f"frontier cap {engine.frontier_cap}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    n_unique = [engine.frontier_for(ids).n_unique for ids in requests[:8]]
    print(f"[slice] unique frontier rows per request {n_unique} of "
          f"{engine.frontier_cap} decoded", flush=True)
    for r in results + many:
        check(r.embeddings.shape == (REQUEST, rt.cfg.hidden), "embedding shape")
        check(r.logits.shape == (REQUEST, N_CLASSES), "logits shape")
        check(bool(np.isfinite(r.embeddings).all() and np.isfinite(r.logits).all()),
              "non-finite output")

    # the same requests through the gather backend on the card
    gather = rt.serve(cache_capacity=0, decode_backend="gather")
    ecfg = rt.cfg.embedding_config()
    cb = rt.params["embed"]["decoder"]["codebooks"]
    worst = 0.0

    def decoded_bitwise(fb, what):
        fb = fb.to(rt.device)
        codes = emb_lib.lookup_codes(rt.params["embed"], fb.unique, ecfg)
        check(torch.equal(engine.model.backend.decode(codes, cb),
                          gather.model.backend.decode(codes, cb)),
              f"decoded rows of {what} differ between kernel and gather backends")

    for ids, r in zip(requests[:8], results):
        decoded_bitwise(engine.frontier_for(ids), "a request")
        worst = max(worst, float(np.abs(gather.serve(ids).embeddings - r.embeddings).max()))
    fb_many = engine.coalesced_frontier(requests[8:12])
    check(fb_many.unique.shape[0] == 4 * engine.frontier_cap,
          f"coalesced frontier of 4 has {fb_many.unique.shape[0]} rows")
    decoded_bitwise(fb_many, "the serve_many of 4")
    for ids, r in zip(requests[8:12], many):
        worst = max(worst, float(np.abs(gather.serve(ids).embeddings - r.embeddings).max()))
    print(f"[slice] kernel vs gather on the card: decoded rows bitwise for the "
          f"8 requests and the coalesced serve_many frontier "
          f"({fb_many.unique.shape[0]} rows), embeddings max abs diff {worst}",
          flush=True)
    check(worst <= 1e-6, f"embeddings differ from the gather path by {worst}")
    phase_breakdown(engine, requests[:8])
    return launches, engine.frontier_cap


def phase_breakdown(engine, requests):
    """Where one request's time goes: ``engine.serve`` under a
    ``StageTimer``, which synchronises the card around each stage the
    serving path marks, so the stages do not overlap."""
    import numpy as np
    from repro_torch.stages import StageTimer
    with StageTimer() as timer:
        t0 = time.perf_counter()
        for ids in requests:
            engine.serve(ids)
        served_ms = (time.perf_counter() - t0) * 1e3 / len(requests)
    med = {s: float(np.median(v)) for s, v in timer.ms.items()}
    check(all(len(v) == len(requests) for v in timer.ms.values()),
          f"stages marked unevenly: { {s: len(v) for s, v in timer.ms.items()} }")
    total = sum(med.values())
    dev_ms = sum(med.get(s, 0.0) for s in ("unpack", "decode", "mlp", "sage", "logits"))
    print(f"[breakdown] median ms per request over {len(requests)} timed "
          f"requests: " + ", ".join(f"{s} {v:.3f}" for s, v in med.items())
          + f"; sum {total:.3f}; device stages {dev_ms:.3f} "
          f"({100 * dev_ms / total:.1f}% of the sum); mean timed request "
          f"{served_ms:.3f} ms", flush=True)


def phase_small_reference():
    """A small graph served on the card (kernel) and on the CPU (plain
    version) with the same params: agreement within f32 matmul rounding."""
    import numpy as np
    import torch
    from repro_torch.graph.runtime import GraphRuntime
    spec = _spec("auto", 3000, 8)
    rt = GraphRuntime.from_spec(spec)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu() for k, v in tree.items()}
    cpu_params = to_cpu(rt.params)
    rt_cpu = GraphRuntime.from_spec(spec, graph=(rt.adj, rt.labels), device="cpu",
                                    params=cpu_params)
    ids = np.arange(0, 3000, 11)[:REQUEST]
    a = rt.serve(cache_capacity=0).serve(ids)
    b = rt_cpu.serve(cache_capacity=0).serve(ids)
    diff = float(np.abs(a.embeddings - b.embeddings).max())
    print(f"[reference] 3,000-node graph, card vs CPU plain path: embeddings "
          f"max abs diff {diff}", flush=True)
    check(diff <= 1e-4, f"card and CPU disagree by {diff}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import disable_tf32
    disable_tf32()
    name, count = phase_device()
    phase_build()
    from repro_torch.graph.engine import default_frontier_cap
    b_main = default_frontier_cap(REQUEST, (15, 15), 256, N_NODES)
    timing = phase_kernel_check(b_main)
    launches, cap = phase_slice()
    check(cap == b_main, f"served frontier cap {cap} != checked shape {b_main}")
    phase_small_reference()
    print(json.dumps({"kernels": [dict(
        name="hash_decode", route="cuda",
        source="src/repro_torch/kernels/hash_decode/csrc/hash_decode.cu",
        replaces="src/repro/kernels/hash_decode/kernel.py:67",
        launches=launches, bitwise=timing["max_abs_err"] == 0.0, **timing)]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)


if __name__ == "__main__":
    main()
