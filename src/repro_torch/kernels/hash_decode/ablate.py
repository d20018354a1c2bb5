"""Ablations of the hash_decode kernels on the card: what each part of the
staged forward design is worth, where it overtakes the direct gather, and
what each knob of the backward (the codebook gradient) is worth, at the
paths' shapes.

    PYTHONPATH=src python -m repro_torch.kernels.hash_decode.ablate

Each variant is ``csrc/hash_decode.cu`` with one text edit (or the shipped
source launched on another geometry), built with the port's nvcc flags
(``kernels/build.py``) and called through its C entry points on the same
codes and codebooks (m = 16, c = 256, d_c = 512): one request's frontier
(B = 61,696, f32), a training batch (8,192, bf16) and a reconstruction
batch (512, f32).  Each is timed as a CUDA graph of 20 launches (so the
host's enqueue time does not hide the card's), in turns, three rounds;
lower is better.

The backward variants (no w0) run at a GraphSAGE training frontier
(24,064 rows, f32), one request's 61,696 rows (f32), the LM step's 8,192
rows (bf16) and the reconstruction's 512 (f32), the same way.  Knobs:
rows whose g a warp loads before adding them (``kSumAhead``), features a
warp (``kSumFeatures``), the sum grid's order (``codebook_major``) and one
fused launch against a sort and a sum (``fused_4096``), the sort's
key match (``match_any``) and parts (``parts_8``, ``part_rows_1024``);
and the sort alone (``sort``).  An L2 read probe (a sum over a buffer that stays in L2,
and one that does not) gives the card's L2 and device-memory read rates,
against which the backward's m*B*d_c*4 bytes from L2 are its floor.
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
BACKWARD_SHAPES = [(24_064, "float32"), (61_696, "float32"), (8_192, "bfloat16"),
                   (512, "float32")]                            # (B, d_cb dtype)
FUSED_KERNEL = """template <typename T, bool W0, bool VEC>
__global__ void __launch_bounds__(32 * kSumWarps)
hash_decode_fused_kernel(const int32_t* __restrict__ codes, const float* __restrict__ g,
                         const float* __restrict__ w0, T* __restrict__ d_cb,
                         int B, int m, int c, int d_c) {
  constexpr int W = kSumWarps;
  extern __shared__ int s_fused[];
  int* hist = s_fused;                 // c * (W + 1)
  int* start = hist + c * (W + 1);     // c + 1
  int* scan = start + c + 1;           // W + 1
  int* rows = scan + W + 1;            // B
  const int groups = (c + W - 1) / W;
  const int slice = blockIdx.x / (m * groups), jg = blockIdx.x % (m * groups);
  const int j = jg / groups, k = (jg - j * groups) * W + (threadIdx.x >> 5);
  for (int i = threadIdx.x; i < c; i += 32 * W) hist[i] = 0;
  __syncthreads();
  for (int b = threadIdx.x; b < B; b += 32 * W) {
    atomicAdd(&hist[min(max(codes[static_cast<size_t>(b) * m + j], 0), c - 1)], 1);
  }
  __syncthreads();
  const int per = (c + 32 * W - 1) / (32 * W);
  const int k0 = min(c, static_cast<int>(threadIdx.x) * per), k1 = min(c, k0 + per);
  int own = 0;
  for (int q = k0; q < k1; ++q) own += hist[q];
  int run = block_exclusive_scan<W>(own, scan);
  for (int q = k0; q < k1; ++q) {
    start[q] = run;
    run += hist[q];
  }
  if (threadIdx.x == 0) start[c] = B;
  __syncthreads();
  place_rows<W>(codes, m, j, c, 0, B, start, hist, rows);
  __syncthreads();
  if (k >= c) return;
  sum_segment<T, W0, VEC>(rows, start[k], start[k + 1], g, w0,
                          d_cb + (static_cast<size_t>(j) * c + k) * d_c, d_c,
                          slice * kSumFeatures + (threadIdx.x & 31) * kLaneF);
}

"""
FUSED_LAUNCH = """  if (B <= 4096) {
    const int smem = (c * (kSumWarps + 2) + kSumWarps + 2 + B) * static_cast<int>(sizeof(int));
    hash_decode_fused_kernel<T, W0, VEC><<<n_slices * m * ((c + kSumWarps - 1) / kSumWarps),
                                           32 * kSumWarps, smem, stream>>>(
        codes, g, w0, out, B, m, c, d_c);
    return static_cast<int>(cudaGetLastError());
  }
"""
BACKWARD_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    # 16 rows' g loads in flight a warp instead of 8
    "ahead_16": [("constexpr int kSumAhead = 8;", "constexpr int kSumAhead = 16;")],
    # 4 instead of 8
    "ahead_4": [("constexpr int kSumAhead = 8;", "constexpr int kSumAhead = 4;")],
    # 64 features a warp (two a lane) instead of 128
    "features_64": [("constexpr int kSumFeatures = 128;", "constexpr int kSumFeatures = 64;")],
    # the sum grid codebook-major: a (j, k)'s slices side by side
    "codebook_major": [("  const int slice = wid / mc;\n  const int jk = wid % mc;",
                        "  const int slice = wid % n_slices;\n  const int jk = wid / n_slices;")],
    # the sort in at most 8 parts (larger ones) instead of 32
    "parts_8": [("constexpr int kMaxParts = 32;", "constexpr int kMaxParts = 8;")],
    # parts of at least 1,024 rows instead of 512
    "part_rows_1024": [("constexpr int kPartRows = 512;", "constexpr int kPartRows = 1024;")],
    # the sort's key groups from __match_any_sync instead of bit ballots
    "match_any": [("  const unsigned valid = __ballot_sync(0xffffffffu, key >= 0);",
                   "  if (bits >= 0) return __match_any_sync(0xffffffffu, key);\n"
                   "  const unsigned valid = __ballot_sync(0xffffffffu, key >= 0);")],
    # one launch up to 4,096 rows: each block sorts its codebook's rows into
    # shared memory itself, then its warps sum kSumWarps codes of one slice
    "fused_4096": [("// dynamic shared memory above 48 KiB", FUSED_KERNEL
                    + "// dynamic shared memory above 48 KiB"),
                   ("  int* offsets = work;\n", FUSED_LAUNCH + "  int* offsets = work;\n")],
}
VARIANTS.update(BACKWARD_VARIANTS)

# a read-bandwidth probe: each thread sums float4s, four loads in flight,
# cached in L2 only (__ldcg), so a buffer read again comes from L2, not L1
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void read_probe(const float4* __restrict__ p, long long n4, int reps, float* out) {
  float4 a[4] = {};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int r = 0; r < reps; ++r) {
    long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    for (; i + 3 * stride < n4; i += 4 * stride) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v = __ldcg(p + i + u * stride);   // L2, not L1
        a[u].x += v.x; a[u].y += v.y; a[u].z += v.z; a[u].w += v.w;
      }
    }
    for (; i < n4; i += stride) { const float4 v = __ldcg(p + i); a[0].x += v.x; }
  }
  const float s = a[0].x + a[1].x + a[2].x + a[3].x + a[0].y + a[1].y + a[2].y + a[3].y +
                  a[0].z + a[1].z + a[2].z + a[3].z + a[0].w + a[1].w + a[2].w + a[3].w;
  if (s == 1234.5f) out[0] = s;          // keeps the loads; never true on the probe's data
}
extern "C" int read_probe_launch(const void* p, long long n4, int reps, void* out, int grid,
                                 void* stream) {
  read_probe<<<grid, 512, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(p), n4, reps, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""
# (bytes, passes a launch): a g slice at 24k rows and two (in L2), and a
# buffer far above L2 (device memory)
PROBE = ((12 << 20, 40), (24 << 20, 20), (2 << 30, 1))


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
    backward, sort = lib.hash_decode_backward_launch, lib.hash_decode_sort_launch
    backward.argtypes = [p] * 4 + [i] * 5 + [p, i, p]
    sort.argtypes = [p, i, i, i, p, p, p, i, p]
    backward.restype = sort.restype = ctypes.c_int
    sizes = lib.hash_decode_backward_sizes
    sizes.argtypes = [i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    sizes.restype = None
    return staged, direct, backward, sort, sizes


def _scratch(entries, B: int) -> Tuple[int, int]:
    """(scratch, counts) int32 elements of one variant's backward at (B, M, C)."""
    out = (ctypes.c_longlong * 3)()
    entries[4](B, M, C, out)
    return out[0], out[1]


def graph_ms(call, n=20) -> float:
    """Mean device time of ``call`` captured ``n`` times into one CUDA graph
    and replayed, after a warm-up."""
    import torch
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


def time_probe(dev) -> dict:
    """GB/s read by ``PROBE_SOURCE`` over the buffers of ``PROBE``, each
    read ``passes`` times a launch, three rounds: the card's L2 read rate
    (the two small ones) and its device memory's (the large one)."""
    import torch
    path = build.BUILD_DIR / "ablate" / "read_probe.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(PROBE_SOURCE)
    fn = ctypes.CDLL(str(build.build_shared_library("read_probe", path)[0])).read_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    grid = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.zeros(1, device="cuda")
    rates = {}
    for nbytes, passes in PROBE:
        buf = torch.ones(nbytes // 4, device="cuda")

        def call():
            if fn(buf.data_ptr(), nbytes // 16, passes, out.data_ptr(), grid,
                  torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("probe launch failed")

        ms = [graph_ms(call) for _ in range(3)]
        rates[nbytes] = [nbytes * passes / (t * 1e-3) / 1e9 for t in ms]
        print(f"[ablate] read probe {nbytes} B x {passes}: "
              + ", ".join(f"{t:.4f} ms" for t in ms)
              + " = " + ", ".join(f"{r:.0f}" for r in rates[nbytes]) + " GB/s", flush=True)
        del buf
    return rates


def time_backward(libs, dev) -> List[dict]:
    """The backward variants in turns, three rounds, at ``BACKWARD_SHAPES``,
    as CUDA graphs."""
    import torch
    rounds = []
    names = ["shipped", *BACKWARD_VARIANTS]
    for B, dtype in BACKWARD_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        codes = torch.randint(0, C, (B, M), generator=gen, device="cuda", dtype=torch.int32)
        g = torch.randn(B, D_C, generator=gen, device="cuda")
        out = torch.empty(M, C, D_C, device="cuda", dtype=getattr(torch, dtype))
        work = torch.empty(max(_scratch(libs[name], B)[0] for name in names),
                           device="cuda", dtype=torch.int32)
        storage = ops._STORAGE[out.dtype]

        def call(name):
            err = libs[name][2](codes.data_ptr(), g.data_ptr(), None, out.data_ptr(), storage,
                                B, M, C, D_C, work.data_ptr(), dev,
                                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} launch failed: {err}")

        ref = None
        for name in names:                   # every variant gives the same bits
            call(name)
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
            elif not torch.equal(out, ref):
                raise RuntimeError(f"backward variant {name} differs from the shipped kernel")
        offsets = torch.empty(M, C + 1, device="cuda", dtype=torch.int32)
        rows = torch.empty(M, B, device="cuda", dtype=torch.int32)

        def sort():
            err = libs["shipped"][3](codes.data_ptr(), B, M, C, offsets.data_ptr(),
                                     rows.data_ptr(), work.data_ptr(), dev,
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"sort launch failed: {err}")

        for r in range(3):
            row = {name: graph_ms(lambda name=name: call(name)) for name in names}
            row["sort"] = graph_ms(sort)
            rounds.append(dict(round=r, B=B, storage=dtype, backward=True, ms=row))
            print(f"[ablate] backward round {r} B={B} {dtype}: "
                  + ", ".join(f"{name} {ms:.4f}" for name, ms in row.items()), flush=True)
        del codes, g, out, work, offsets, rows
    return rounds


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("ablate: needs a CUDA card")
    libs = {name: _entries(path)
            for name, path in build.build_variants(ops.NAME, ops.SOURCE, VARIANTS).items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.cuda.current_device()

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
    probe = time_probe(dev)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "rounds": rounds,
                      "read_probe_gb_s": probe}), flush=True)


if __name__ == "__main__":
    main()
