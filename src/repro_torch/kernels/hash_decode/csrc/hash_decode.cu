// hash_decode for Hopper (sm_90a): compositional-code decode as a row
// gather-sum, with the codebooks staged in shared memory.
//
//   out[b, :] = (sum_{j=0..m-1} cb[j, codes[b, j], :]) * w0
//
// Replaces the TPU kernel src/repro/kernels/hash_decode/kernel.py,
// function hash_decode_fwd (body _decode_body).  The TPU kernel recasts the
// m gathers as m one-hot x codebook-panel matmuls for the MXU; on this card
// a gather is cheap, so the kernel reads the m selected codebook rows
// directly.  Each one-hot row of the TPU kernel has exactly one nonzero, so
// both compute the same f32 sums.
//
// Storage types: float32, bfloat16, float16, or int8 with a per-(codebook,
// code) float32 scale table (scales (m, c)); every term is widened to f32
// (exactly) and the sum is taken in f32.  w0 (d_c,) float32 is optional.
// Any (m, c): where a slice of every codebook does not fit in shared
// memory the direct variant decodes, and it stages a block's codes only
// where they fit (fewer rows a block first).
//
// Bitwise contract: the output equals the plain PyTorch version
// (ref.py) and the JAX package's gather backend bit for bit.  The sum starts
// from the j=0 term and adds j = 1..m-1 in order with __fadd_rn; the int8
// term is __fmul_rn(float(q), s) and the w0 scale __fmul_rn.  No multiply-add
// is ever contracted into an FMA (the intrinsics are never fused, and the
// build also passes --fmad=false).
//
// What bounds it: the output's device-memory bytes (B*d_c*4, 126 MB at the
// serving shape B = 61,696, m = 16, c = 256, d_c = 512, f32) are 16 times
// fewer than the codebook bytes the sums read (B*m*d_c*4, 2.02 GB).  Read
// from L2, row by row, those set the pace (the direct variant below, at
// about 8 TB/s).  So the staged variant keeps them in shared memory: a
// block loads one 32-byte feature slice of every codebook row, m*c*32 bytes
// (128 KiB at m = 16, c = 256: 8 f32, 16 bf16 or 32 int8 features, plus the
// int8 scales), once, and then walks a range of rows with it, so each
// codebook byte crosses L2 once per range instead of once per row.  Two
// lanes share a row, 16 bytes each: a quarter-warp's 16-byte shared-memory
// reads then touch 4 rows' random slices, whose bank conflicts cost about 2x
// (the expected largest of 4 random draws among 4 bank groups).  The grid is
// persistent: units of (slice, row range) are spread over the SMs, the
// slices of one range side by side, so a row's codes are read from L2 by
// the blocks that decode it at about the same time.  Each lane writes 16,
// 32 or 64 bytes of a row; a row's slice is whole 32-byte sectors.
//
// Small batches (B below the launcher's threshold) take the direct variant:
// each thread owns 4 consecutive features (one 16-byte store; 16-, 8- or
// 4-byte loads for f32, bf16 or int8) and reads its m codebook rows from L2,
// a warp covers 128 consecutive features, and a block decodes a few rows
// whose m codes it stages once in shared memory; staging 128 KiB a block
// costs more than it saves there.
//
// Ragged B and d_c are masked inside both kernels (d_c that is not a
// multiple of the slice, or of 4, takes the element-wise variant), so
// callers never pad.
//
// The backward (at the end) is the codebook gradient, which the JAX package
// computes in XLA, not in Pallas (its kernels/hash_decode/ops.py, _bwd: a
// one-hot contraction):
//
//   d_cb[j, k, :] = sum over b ascending with codes[b, j] = k of g[b, :] * w0
//
// summed in f32 from +0 with __fadd_rn (g * w0 rounded by __fmul_rn first),
// then rounded once to the codebooks' type (f32, bf16 or f16, round to
// nearest even).  Every (j, k, f) sum belongs to one thread and runs in ascending
// b, so the result is the plain version's (ref.py, index_add_ on the CPU)
// bit for bit and the same on every run: no atomics in any float sum.
// What bounds it: g must be read once (B*d_c*4 bytes, 49 MB at a 24,000-row
// training frontier) and d_cb written once (8 MB at m = 16, c = 256,
// d_c = 512); but each of the m codebooks needs all of g, so m*B*d_c*4
// bytes (0.79 GB) cross from L2 to the SMs however the work is cut, and L2's
// bandwidth sets the floor.  Its design, in two steps:
//
//   1. a stable counting sort of each codebook's rows by their (clamped)
//      code, into offsets (m, c+1) and rows (m, B) int32 (ref.py,
//      code_order), in two launches over parts of R >= 512 rows (at most 32
//      parts).  hash_decode_count_kernel reads each part's codes once, in
//      order, and counts each codebook's codes (shared-memory atomics: an
//      integer count does not depend on their order).  Where the (m, c)
//      counts would pass a block's shared memory (m * c > 58,112), or a
//      place block's (c > 3,227: 12-bit codes), the blocks take the codes
//      in ranges that fit, reading their part's codes once a range.  hash_decode_place_-
//      kernel, one block a (part, codebook), starts each code's rows after
//      the rows of smaller codes and its own rows in earlier parts (from the
//      counts), and places the part's rows: ballots over the code's bits
//      group a warp's 32 rows by code, so a row's rank among its warp's rows
//      of the same code is a popcount, and the warps' per-code counts,
//      scanned per code, give each warp its start.  Positions come from
//      ranks, never from the order of atomics.
//   2. hash_decode_sum_kernel, one warp a (feature slice, j, k) segment: the
//      warp reads its segment's row ids 32 at a time (coalesced), loads the g
//      rows of the next kSumAhead of them at once (each lane kSumFeatures/32
//      consecutive features, one 16-byte load at 128 features), then adds
//      them in list order (ascending b) into registers; it rounds once and
//      stores its slice of d_cb[j, k] (an empty segment stores +0).  No
//      shared memory, no read-modify-write: a segment of L rows is a chain of
//      L adds behind loads already in flight.  The grid runs slice-major
//      (every (j, k) of one feature slice before the next slice), so a
//      slice of g (B*512 bytes at 128 features) stays in L2 while the m
//      codebooks read it and g comes from device memory about once.
//
// The sort and the sum are separate launches at every B: one launch whose
// blocks each sort their codebook in shared memory before summing is
// slower even at 512 rows on an H100 (ablate.py, fused_4096).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

enum StorageType { kF32 = 0, kBF16 = 1, kInt8 = 2, kF16 = 3 };

template <typename T> struct Widen;

template <> struct Widen<float> {
  __device__ __forceinline__ static void vec4(const float* p, float v[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  __device__ __forceinline__ static float one(const float* p) { return *p; }
};

template <> struct Widen<__nv_bfloat16> {
  __device__ __forceinline__ static void vec4(const __nv_bfloat16* p, float v[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(e[k]);
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <> struct Widen<__half> {
  __device__ __forceinline__ static void vec4(const __half* p, float v[4]) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __half* e = reinterpret_cast<const __half*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __half2float(e[k]);     // f16 -> f32 is exact
  }
  __device__ __forceinline__ static float one(const __half* p) { return __half2float(*p); }
};

template <> struct Widen<int8_t> {
  __device__ __forceinline__ static void vec4(const int8_t* p, float v[4]) {
    const char4 x = *reinterpret_cast<const char4*>(p);
    v[0] = static_cast<float>(x.x); v[1] = static_cast<float>(x.y);
    v[2] = static_cast<float>(x.z); v[3] = static_cast<float>(x.w);
  }
  __device__ __forceinline__ static float one(const int8_t* p) {
    return static_cast<float>(*p);
  }
};

// blockDim = (TX, TY): TX threads x 4 features span the row (looping when
// d_c > 4*TX), TY rows per block, one row per threadIdx.y.  STAGE: the
// block's TY x m codes are staged (clamped) in shared memory; without it,
// where one row's m codes would not fit, each code is read and clamped
// where it is used.
template <typename T, bool VEC, bool STAGE>
__global__ void hash_decode_kernel(const int32_t* __restrict__ codes,
                                   const T* __restrict__ cb,
                                   const float* __restrict__ w0,
                                   const float* __restrict__ scales,
                                   float* __restrict__ out,
                                   int B, int m, int c, int d_c) {
  extern __shared__ int32_t s_codes[];            // (TY, m)
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row0 = blockIdx.x * blockDim.y;
  const int rows_here = min(static_cast<int>(blockDim.y), B - row0);
  const int nthreads = blockDim.x * blockDim.y;
  const int32_t* block_codes = codes + static_cast<size_t>(row0) * m;
  if (STAGE) {
    for (int i = ty * blockDim.x + tx; i < rows_here * m; i += nthreads) {
      // out-of-range codes clamp, as the JAX gather's indexing does
      s_codes[i] = min(max(block_codes[i], 0), c - 1);
    }
    __syncthreads();
  }
  if (ty >= rows_here) return;

  const int32_t* rc = STAGE ? s_codes + ty * m : block_codes + static_cast<size_t>(ty) * m;
  float* orow = out + static_cast<size_t>(row0 + ty) * d_c;
  for (int f0 = tx * 4; f0 < d_c; f0 += blockDim.x * 4) {
    float acc[4];
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const int code = STAGE ? rc[j] : min(max(rc[j], 0), c - 1);
      const T* src = cb + (static_cast<size_t>(j) * c + code) * d_c + f0;
      float v[4];
      if (VEC) {
        Widen<T>::vec4(src, v);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = (f0 + k < d_c) ? Widen<T>::one(src + k) : 0.f;
      }
      if (scales != nullptr) {
        const float s = scales[j * c + code];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k] = __fmul_rn(v[k], s);
      }
      if (j == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = v[k];
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
      }
    }
    if (w0 != nullptr) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (VEC || f0 + k < d_c) acc[k] = __fmul_rn(acc[k], w0[f0 + k]);
      }
    }
    if (VEC) {
      *reinterpret_cast<float4*>(orow + f0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (f0 + k < d_c) orow[f0 + k] = acc[k];
      }
    }
  }
}

// ----- staged variant -------------------------------------------------------

constexpr int kSliceBytes = 32;         // one codebook row's feature slice
constexpr int kMaxVecM = 16;            // codes a row holds in registers (VEC)

// threads a block: int8's 16 features a lane need more registers
template <typename T> constexpr int staged_threads() { return sizeof(T) == 1 ? 512 : 1024; }

// 16 bytes of storage widened to f32: 4 f32, 8 bf16 or 16 int8 values.
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const uint4& r, float v[kN]) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
};

template <> struct Chunk<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float v[kN]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);           // bf16 -> f32 is exact
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
};

template <> struct Chunk<__half> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& r, float v[kN]) {
    const __half* e = reinterpret_cast<const __half*>(&r);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __half2float(e[k]);      // f16 -> f32 is exact
  }
};

template <> struct Chunk<int8_t> {
  static constexpr int kN = 16;
  __device__ __forceinline__ static void widen(const uint4& r, float v[kN]) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      v[k] = static_cast<float>(static_cast<int8_t>((w[k >> 2] >> (8 * (k & 3))) & 0xffu));
    }
  }
};

// One unit = (feature slice, row range).  VEC: d_c is a multiple of the
// lane's 16-byte chunk, m a multiple of 4 up to 16, and codebooks, codes,
// out and w0 are 16-byte aligned; otherwise each code is read on its own.  Shared memory: (m*c, 2) chunks, then (m*c) scales.
template <typename T, bool VEC>
__global__ void __launch_bounds__(staged_threads<T>(), 1)
hash_decode_staged(const int32_t* __restrict__ codes, const T* __restrict__ cb,
                   const float* __restrict__ w0, const float* __restrict__ scales,
                   float* __restrict__ out, int B, int m, int c, int d_c,
                   int n_slices, int rows_per_unit, int n_units) {
  constexpr int kH = Chunk<T>::kN;        // features per lane
  constexpr int kF = 2 * kH;              // features per slice
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* s_cb = reinterpret_cast<uint4*>(smem);
  const int mc = m * c;
  float* s_scale = reinterpret_cast<float*>(smem + static_cast<size_t>(mc) * kSliceBytes);
  const int tid = threadIdx.x;
  const int half = tid & 1;
  if (scales != nullptr) {
    for (int i = tid; i < mc; i += blockDim.x) s_scale[i] = scales[i];
  }
  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const int f = (unit % n_slices) * kF + half * kH;   // this lane's first feature
    const int r0 = (unit / n_slices) * rows_per_unit;
    const int r1 = min(B, r0 + rows_per_unit);
    __syncthreads();                      // the last unit's reads are done
    for (int i = tid; i < 2 * mc; i += blockDim.x) {
      const int fi = (unit % n_slices) * kF + (i & 1) * kH;
      const T* src = cb + static_cast<size_t>(i >> 1) * d_c + fi;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (VEC) {
        if (fi < d_c) v = *reinterpret_cast<const uint4*>(src);
      } else {
        T* e = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int k = 0; k < kH; ++k) {
          if (fi + k < d_c) e[k] = src[k];
        }
      }
      s_cb[i] = v;
    }
    float wv[kH];
#pragma unroll
    for (int k = 0; k < kH; ++k) wv[k] = (w0 != nullptr && f + k < d_c) ? w0[f + k] : 1.0f;
    __syncthreads();
    if (f >= d_c) continue;               // this lane's half of the last slice is empty
    for (int b = r0 + (tid >> 1); b < r1; b += blockDim.x >> 1) {
      const int32_t* rc = codes + static_cast<size_t>(b) * m;
      float acc[kH];
      // term j in order: the first as it is, then __fadd_rn
      auto add_term = [&](int j, int code) {
        // out-of-range codes clamp, as the JAX gather's indexing does
        const int idx = j * c + min(max(code, 0), c - 1);
        float v[kH];
        Chunk<T>::widen(s_cb[2 * idx + half], v);
        if (scales != nullptr) {
          const float s = s_scale[idx];
#pragma unroll
          for (int k = 0; k < kH; ++k) v[k] = __fmul_rn(v[k], s);
        }
#pragma unroll
        for (int k = 0; k < kH; ++k) acc[k] = j == 0 ? v[k] : __fadd_rn(acc[k], v[k]);
      };
      if (VEC) {
        // the row's m <= 16 codes at once (four 16-byte loads), then the
        // m shared-memory reads back to back
        int cj[kMaxVecM];
#pragma unroll
        for (int q = 0; q < kMaxVecM / 4; ++q) {
          if (4 * q < m) {
            const int4 x = reinterpret_cast<const int4*>(rc)[q];
            cj[4 * q] = x.x; cj[4 * q + 1] = x.y; cj[4 * q + 2] = x.z; cj[4 * q + 3] = x.w;
          }
        }
#pragma unroll
        for (int j = 0; j < kMaxVecM; ++j) {
          if (j < m) add_term(j, cj[j]);
        }
      } else {
        for (int j = 0; j < m; ++j) add_term(j, rc[j]);
      }
      if (w0 != nullptr) {
#pragma unroll
        for (int k = 0; k < kH; ++k) acc[k] = __fmul_rn(acc[k], wv[k]);
      }
      float* o = out + static_cast<size_t>(b) * d_c + f;
      if (VEC) {
#pragma unroll
        for (int q = 0; q < kH / 4; ++q) {
          reinterpret_cast<float4*>(o)[q] =
              make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kH; ++k) {
          if (f + k < d_c) o[k] = acc[k];
        }
      }
    }
  }
}

template <typename T>
int launch_staged(const int32_t* codes, const void* cb, const float* w0,
                  const float* scales, float* out, int B, int m, int c, int d_c,
                  int vec, int grid, int smem, int n_slices, int rows_per_unit,
                  cudaStream_t stream) {
  const int n_units = n_slices * ((B + rows_per_unit - 1) / rows_per_unit);
  const T* cbt = static_cast<const T*>(cb);
  auto kernel = vec ? hash_decode_staged<T, true> : hash_decode_staged<T, false>;
  // shared memory above 48 KiB is allowed per kernel, once for the largest
  // size asked so far (not on every launch)
  static int allowed[2] = {0, 0};
  if (smem > allowed[vec]) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allowed[vec] = smem;
  }
  kernel<<<grid, staged_threads<T>(), smem, stream>>>(codes, cbt, w0, scales, out, B, m,
                                                 c, d_c, n_slices, rows_per_unit, n_units);
  return static_cast<int>(cudaGetLastError());
}

// ----- direct variant -------------------------------------------------------

template <typename T>
void launch_typed(const int32_t* codes, const void* cb, const float* w0,
                  const float* scales, float* out, int B, int m, int c,
                  int d_c, int vec, int tx, int ty, int stage, cudaStream_t stream) {
  const dim3 block(tx, ty);
  const dim3 grid((B + ty - 1) / ty);
  const size_t smem = stage ? static_cast<size_t>(ty) * m * sizeof(int32_t) : 0;
  const T* cbt = static_cast<const T*>(cb);
  auto kernel = vec ? (stage ? hash_decode_kernel<T, true, true> : hash_decode_kernel<T, true, false>)
                    : (stage ? hash_decode_kernel<T, false, true> : hash_decode_kernel<T, false, false>);
  kernel<<<grid, block, smem, stream>>>(codes, cbt, w0, scales, out, B, m, c, d_c);
}

// ----- backward: the codebook gradient --------------------------------------

constexpr int kPartRows = 512;       // rows of a sort part at least (32 * kPlaceWarps)
constexpr int kMaxParts = 32;        // parts of a sort at most: more rows a part above
constexpr int kPlaceWarps = 16;      // warps of a place block, one block a (part, codebook)
constexpr int kSortAhead = 4;        // 32-row steps whose codes a warp loads at once
constexpr int kSumWarps = 8;         // warps of a sum block
constexpr int kSumFeatures = 128;    // features of g a warp sums
constexpr int kSumAhead = 8;         // rows whose g a warp loads before adding them
constexpr int kLaneF = kSumFeatures / 32;   // consecutive features a lane
static_assert(kSumFeatures % 32 == 0 && kLaneF <= 4, "a lane holds 1, 2 or 4 features");

template <typename T> __device__ __forceinline__ T round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half round_to<__half>(float v) {
  return __float2half_rn(v);
}

// The lanes of the warp whose key equals this lane's, for keys in [-1, c):
// one ballot for the sign, then one a bit of c - 1 (9 ballots at c = 256;
// on an H100 the whole backward is 2-3% slower at 61,696 and 512 rows with
// __match_any_sync instead, and as fast at 24,064: ablate.py, match_any).
__device__ __forceinline__ unsigned same_key(int key, int bits) {
  const unsigned valid = __ballot_sync(0xffffffffu, key >= 0);
  unsigned same = key >= 0 ? valid : ~valid;
  for (int i = 0; i < bits; ++i) {
    const bool bit = (key >> i) & 1;
    const unsigned set = __ballot_sync(0xffffffffu, bit);
    same &= bit ? set : ~set;
  }
  return same;
}

// The exclusive prefix, over the block's threads in order, of `own`; scan
// holds W + 1 ints of shared memory (scan[W] = the total).  Every thread
// of the W warps calls it.
template <int W>
__device__ int block_exclusive_scan(int own, int* scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < W ? scan[lane] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += u;
    }
    if (lane < W) scan[lane] = x - v;
    if (lane == 31) scan[W] = x;
  }
  __syncthreads();
  return scan[warp] + incl - own;
}

// Places rows [r_lo, r_hi) of codebook j whose code lies in [lo, lo + n)
// in the stable order by code: given start[k], the place of the part's
// first row of code lo + k, each row goes to rows_out[start[code - lo] + its
// rank among the part's rows of that code].  The block's W warps each own a contiguous chunk of the part (a
// multiple of 32 rows), so ascending (warp, step, lane) is ascending b; a
// row's rank is the count of its code in the warps before its own (the
// warps' per-code counts, hist, scanned per code) plus its rank in its
// warp's earlier steps and in its own step (a popcount of its same_key
// group).  Integers only: the same on every run.  hist: n * (W + 1) ints
// of shared memory ([code][warp], a row of W + 1 so that a warp's codes
// fall in different banks).
template <int W>
__device__ void place_rows(const int32_t* __restrict__ codes, int m, int j, int c, int lo,
                           int n, int r_lo, int r_hi, const int* start, int* hist,
                           int* rows_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;         // the lanes below this one
  const int chunk = (r_hi - r_lo + 32 * W - 1) / (32 * W) * 32;
  const int b_lo = r_lo + warp * chunk, b_hi = min(r_hi, b_lo + chunk);
  const int bits = 32 - __clz(n - 1);               // bits of the range's largest key
  for (int i = threadIdx.x; i < n * (W + 1); i += 32 * W) hist[i] = 0;
  // row b's code less lo, or -1 past the chunk or outside the range;
  // out-of-range codes clamp, as the forward's do
  auto key = [&](int b) {
    if (b >= b_hi) return -1;
    const int k = min(max(codes[static_cast<size_t>(b) * m + j], 0), c - 1) - lo;
    return k >= 0 && k < n ? k : -1;
  };
  __syncthreads();
  for (int b0 = b_lo; b0 < b_hi; b0 += 32 * kSortAhead) {   // count
    int q[kSortAhead];
#pragma unroll
    for (int s = 0; s < kSortAhead; ++s) q[s] = key(b0 + 32 * s + lane);
#pragma unroll
    for (int s = 0; s < kSortAhead; ++s) {
      if (b0 + 32 * s >= b_hi) break;
      const unsigned same = same_key(q[s], bits);
      if (q[s] >= 0 && (same & below) == 0) hist[q[s] * (W + 1) + warp] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += 32 * W) {          // each warp's start a code
    int run = start[k];
    for (int w = 0; w < W; ++w) {
      const int v = hist[k * (W + 1) + w];
      hist[k * (W + 1) + w] = run;
      run += v;
    }
  }
  __syncthreads();
  for (int b0 = b_lo; b0 < b_hi; b0 += 32 * kSortAhead) {   // place
    int q[kSortAhead];
#pragma unroll
    for (int s = 0; s < kSortAhead; ++s) q[s] = key(b0 + 32 * s + lane);
#pragma unroll
    for (int s = 0; s < kSortAhead; ++s) {
      if (b0 + 32 * s >= b_hi) break;
      const unsigned same = same_key(q[s], bits);
      if (q[s] >= 0) {
        rows_out[hist[q[s] * (W + 1) + warp] + __popc(same & below)] = b0 + 32 * s + lane;
      }
      __syncwarp();
      if (q[s] >= 0 && (same & below) == 0) hist[q[s] * (W + 1) + warp] += __popc(same);
      __syncwarp();
    }
  }
}

// The sort's first launch: grid (P, ranges), one block a part of R rows
// and a range of `span` (codebook, code) pairs j * c + k, 512 threads;
// dynamic shared memory `span` ints (every pair in one range up to
// kCountSpan pairs: m * c <= 58,112).  counts (P, m, c): how many rows of
// each part have each (clamped) code in each codebook.  The part's codes
// are read once a range, in order (coalesced); the counts are shared-memory
// atomics, whose order cannot change an integer count.
__global__ void __launch_bounds__(512)
hash_decode_count_kernel(const int32_t* __restrict__ codes, int B, int m, int c, int R,
                         int span, int* __restrict__ counts) {
  extern __shared__ int s_count[];
  const int mc = m * c;
  const int lo = blockIdx.y * span, n = min(span, mc - lo);
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_count[i] = 0;
  __syncthreads();
  const int e0 = blockIdx.x * R * m;                 // B * m < 2^31 (the wrapper checks)
  const int e1 = min(B, (blockIdx.x + 1) * R) * m;
  constexpr int kAhead = 8;                          // codes a thread loads at once
  for (int e = e0 + threadIdx.x; e < e1; e += kAhead * blockDim.x) {
    int k[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = e + u * blockDim.x;
      k[u] = i < e1 ? min(max(codes[i], 0), c - 1) : -1;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int pair = (e + u * blockDim.x) % m * c + k[u] - lo;
      if (k[u] >= 0 && pair >= 0 && pair < n) atomicAdd(&s_count[pair], 1);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    counts[static_cast<size_t>(blockIdx.x) * mc + lo + i] = s_count[i];
  }
}

// The sort's second launch: grid (P, m), 32 * kPlaceWarps threads, block
// (p, j) places part p's rows of codebook j, one range of `span` codes at a
// time (every code in one range up to kPlaceSpan codes: c <= 3,227).  Its
// codes' places start after all rows of smaller codes and this code's rows
// in parts before p (both from counts); block (0, j) writes offsets[j].
// Dynamic shared memory span * (kPlaceWarps + 2) + kPlaceWarps + 1 ints.
__global__ void __launch_bounds__(32 * kPlaceWarps)
hash_decode_place_kernel(const int32_t* __restrict__ codes, int B, int m, int c, int R,
                         int P, int span, const int* __restrict__ counts,
                         int* __restrict__ offsets, int* __restrict__ rows) {
  constexpr int W = kPlaceWarps;
  extern __shared__ int s_place[];
  int* hist = s_place;                               // span * (W + 1)
  int* start = hist + span * (W + 1);                // span
  int* scan = start + span;                          // W + 1
  const int p = blockIdx.x, j = blockIdx.y;
  int* off = offsets + static_cast<size_t>(j) * (c + 1);
  int below = 0;                                     // the rows of codes below the range
  for (int lo = 0; lo < c; lo += span) {
    const int n = min(span, c - lo);
    const int per = (n + 32 * W - 1) / (32 * W);     // codes a thread
    const int k0 = min(n, static_cast<int>(threadIdx.x) * per), k1 = min(n, k0 + per);
    int own = 0;                                     // the rows of this thread's codes
    for (int k = k0; k < k1; ++k) {
      const int* col = counts + static_cast<size_t>(j) * c + lo + k;
      int before = 0, total = 0;
#pragma unroll 8
      for (int q = 0; q < P; ++q) {
        const int v = col[static_cast<size_t>(q) * m * c];
        total += v;
        before += q < p ? v : 0;
      }
      start[k] = before;
      hist[k] = total;
      own += total;
    }
    int run = below + block_exclusive_scan<W>(own, scan);   // the rows of smaller codes
    below += scan[W];
    for (int k = k0; k < k1; ++k) {
      if (p == 0) off[lo + k] = run;
      start[k] += run;
      run += hist[k];
    }
    __syncthreads();                                 // hist is reused
    place_rows<W>(codes, m, j, c, lo, n, p * R, min(B, (p + 1) * R), start, hist,
                  rows + static_cast<size_t>(j) * B);
    __syncthreads();                                 // start, hist and scan are reused
  }
  if (p == 0 && threadIdx.x == 0) off[c] = B;
}

// kLaneF f32 (g) or T (d_cb) values that one lane loads or stores at once
template <typename T> struct alignas(kLaneF * sizeof(T)) Lanes { T v[kLaneF]; };

// One segment: out[f .. f + kLaneF) (this lane's features of d_cb[j, k]) =
// the sum over rows[beg .. end), in list order, of g[b, f ..] (* w0).
// `left` = d_c - f masks the ragged end; VEC: d_c a multiple of kLaneF and
// g, d_cb aligned to a lane's vector.
template <typename T, bool W0, bool VEC>
__device__ __forceinline__ void sum_segment(const int* rows, int beg, int end,
                                            const float* __restrict__ g,
                                            const float* __restrict__ w0, T* __restrict__ out,
                                            int d_c, int f) {
  const int lane = threadIdx.x & 31;
  const int left = d_c - f;
  float acc[kLaneF], w[kLaneF];
#pragma unroll
  for (int x = 0; x < kLaneF; ++x) {
    acc[x] = 0.f;
    w[x] = (W0 && x < left) ? w0[f + x] : 1.f;
  }
  for (int base = beg; base < end; base += 32) {
    const int n = min(32, end - base);             // row ids, 32 at a time
    const int mine = lane < n ? rows[base + lane] : 0;
    for (int u0 = 0; u0 < n; u0 += kSumAhead) {
      float v[kSumAhead][kLaneF];
#pragma unroll
      for (int u = 0; u < kSumAhead; ++u) {      // kSumAhead loads in flight
        const int b = __shfl_sync(0xffffffffu, mine, (u0 + u) & 31);
        const float* src = g + static_cast<size_t>(b) * d_c + f;
        if (VEC && u0 + u < n && left > 0) {
          const Lanes<float> x = *reinterpret_cast<const Lanes<float>*>(src);
#pragma unroll
          for (int k = 0; k < kLaneF; ++k) v[u][k] = x.v[k];
        } else {
#pragma unroll
          for (int k = 0; k < kLaneF; ++k) v[u][k] = (u0 + u < n && k < left) ? src[k] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kSumAhead; ++u) {      // then added in list order
        if (u0 + u < n) {
#pragma unroll
          for (int k = 0; k < kLaneF; ++k) {
            acc[k] = __fadd_rn(acc[k], W0 ? __fmul_rn(v[u][k], w[k]) : v[u][k]);
          }
        }
      }
    }
  }
  if (left <= 0) return;
  if (VEC) {
    Lanes<T> y;
#pragma unroll
    for (int k = 0; k < kLaneF; ++k) y.v[k] = round_to<T>(acc[k]);
    *reinterpret_cast<Lanes<T>*>(out + f) = y;
  } else {
#pragma unroll
    for (int k = 0; k < kLaneF; ++k) {
      if (k < left) out[f + k] = round_to<T>(acc[k]);
    }
  }
}

// grid ceil(n_slices * m * c / kSumWarps), 32 * kSumWarps threads, no shared
// memory; warp -> (feature slice, j, k), slice-major: all (j, k) of a slice,
// then the next, so that the slice of g stays in L2 while the m codebooks
// read it.
template <typename T, bool W0, bool VEC>
__global__ void __launch_bounds__(32 * kSumWarps)
hash_decode_sum_kernel(const int* __restrict__ offsets, const int* __restrict__ rows,
                       const float* __restrict__ g, const float* __restrict__ w0,
                       T* __restrict__ d_cb, int B, int m, int c, int d_c, int n_slices) {
  const int mc = m * c;
  const int wid = blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (wid >= n_slices * mc) return;
  const int slice = wid / mc;
  const int jk = wid % mc;                                  // j * c + k
  const int j = jk / c;
  const int* off = offsets + static_cast<size_t>(j) * (c + 1) + (jk - j * c);
  sum_segment<T, W0, VEC>(rows + static_cast<size_t>(j) * B, off[0], off[1], g, w0,
                          d_cb + static_cast<size_t>(jk) * d_c, d_c,
                          slice * kSumFeatures + (threadIdx.x & 31) * kLaneF);
}

// dynamic shared memory above 48 KiB is allowed once per kernel, for the
// largest size asked so far
template <typename K>
int allow_smem(K kernel, int smem, int& allowed) {
  if (smem > 48 * 1024 && smem > allowed) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allowed = smem;
  }
  return 0;
}

// The sort's ranges: a count block counts at most kCountSpan (codebook,
// code) pairs and a place block places at most kPlaceSpan codes at a time,
// so that each stays within a block's 227 KiB of shared memory at any
// (m, c); below them, one range takes every pair or code.
constexpr int kSmemInts = 232448 / 4;
constexpr int kCountSpan = kSmemInts;
constexpr int kPlaceSpan = (kSmemInts - kPlaceWarps - 1) / (kPlaceWarps + 2);
int count_span(int m, int c) { return static_cast<int>(std::min<long long>(1LL * m * c, kCountSpan)); }
int place_span(int c) { return std::min(c, kPlaceSpan); }

// the dynamic shared memory of a count block (a range's counts) and of a
// place block (hist, start and scan of place_rows), in bytes
long long count_smem(int m, int c) { return 4LL * count_span(m, c); }
long long place_smem(int c) {
  return 4LL * (static_cast<long long>(place_span(c)) * (kPlaceWarps + 2) + kPlaceWarps + 1);
}

// CUDA launches of the backward's kernels (count, place, sum), counted on
// the host where each is launched
std::atomic<unsigned long long> g_launched[3];

// The stable sort: parts of R rows, R a multiple of kPartRows chosen so
// that there are at most kMaxParts; counts is kMaxParts * m * c ints.
int launch_sort(const int32_t* codes, int B, int m, int c, int* offsets, int* rows,
                int* counts, cudaStream_t stream) {
  const int R = kPartRows * max(1, (B + kPartRows * kMaxParts - 1) / (kPartRows * kMaxParts));
  const int P = (B + R - 1) / R;
  static int allowed[2] = {0, 0};
  const int smem[2] = {static_cast<int>(count_smem(m, c)), static_cast<int>(place_smem(c))};
  int err = allow_smem(hash_decode_count_kernel, smem[0], allowed[0]);
  if (err == 0) err = allow_smem(hash_decode_place_kernel, smem[1], allowed[1]);
  if (err != 0) return err;
  const int cspan = count_span(m, c);
  const long long mc = 1LL * m * c;
  hash_decode_count_kernel<<<dim3(P, static_cast<unsigned>((mc + cspan - 1) / cspan)), 512,
                             smem[0], stream>>>(codes, B, m, c, R, cspan, counts);
  ++g_launched[0];
  hash_decode_place_kernel<<<dim3(P, m), 32 * kPlaceWarps, smem[1], stream>>>(
      codes, B, m, c, R, P, place_span(c), counts, offsets, rows);
  ++g_launched[1];
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool W0, bool VEC>
int launch_backward_typed(const int32_t* codes, const float* g, const float* w0, T* out,
                          int B, int m, int c, int d_c, int* work, cudaStream_t stream) {
  const int n_slices = (d_c + kSumFeatures - 1) / kSumFeatures;
  int* offsets = work;
  int* rows = offsets + static_cast<size_t>(m) * (c + 1);
  const int err = launch_sort(codes, B, m, c, offsets, rows, rows + static_cast<size_t>(m) * B,
                              stream);
  if (err != 0) return err;
  const long long warps = static_cast<long long>(n_slices) * m * c;
  hash_decode_sum_kernel<T, W0, VEC><<<static_cast<unsigned>((warps + kSumWarps - 1) / kSumWarps),
                                       32 * kSumWarps, 0, stream>>>(
      offsets, rows, g, w0, out, B, m, c, d_c, n_slices);
  ++g_launched[2];
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_backward(const int32_t* codes, const float* g, const float* w0, void* d_cb,
                    int B, int m, int c, int d_c, int* work, cudaStream_t stream) {
  T* out = static_cast<T*>(d_cb);
  const bool vec = d_c % kLaneF == 0 &&
                   reinterpret_cast<uintptr_t>(g) % sizeof(Lanes<float>) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % sizeof(Lanes<T>) == 0;
  if (w0 != nullptr) {
    return vec ? launch_backward_typed<T, true, true>(codes, g, w0, out, B, m, c, d_c, work, stream)
               : launch_backward_typed<T, true, false>(codes, g, w0, out, B, m, c, d_c, work, stream);
  }
  return vec ? launch_backward_typed<T, false, true>(codes, g, w0, out, B, m, c, d_c, work, stream)
             : launch_backward_typed<T, false, false>(codes, g, w0, out, B, m, c, d_c, work, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are device pointers
// on card `device`; w0 and scales may be null.  storage: 0 = f32, 1 = bf16,
// 2 = int8, 3 = f16.  They launch on `stream`, do not synchronise and return
// cudaGetLastError() (or the error of setting the shared-memory size).

// The direct variant: blockDim (tx, ty); stage: the block's ty x m codes
// staged in shared memory (ty * m * 4 bytes, at most 48 KiB), else read
// where they are used.
extern "C" int hash_decode_launch(const void* codes, const void* cb,
                                  int storage, const void* w0,
                                  const void* scales, void* out, int B, int m,
                                  int c, int d_c, int vec, int tx, int ty, int stage,
                                  int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int32_t* ci = static_cast<const int32_t*>(codes);
  const float* w = static_cast<const float*>(w0);
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kF32:
      launch_typed<float>(ci, cb, w, s, o, B, m, c, d_c, vec, tx, ty, stage, st);
      break;
    case kBF16:
      launch_typed<__nv_bfloat16>(ci, cb, w, s, o, B, m, c, d_c, vec, tx, ty, stage, st);
      break;
    case kF16:
      launch_typed<__half>(ci, cb, w, s, o, B, m, c, d_c, vec, tx, ty, stage, st);
      break;
    case kInt8:
      launch_typed<int8_t>(ci, cb, w, s, o, B, m, c, d_c, vec, tx, ty, stage, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The staged variant: `grid` persistent blocks of 1024 threads (512 for
// int8), `smem`
// bytes of dynamic shared memory (m*c*32, plus m*c*4 with scales), units of
// one 32-byte feature slice x `rows_per_unit` rows.
extern "C" int hash_decode_staged_launch(const void* codes, const void* cb,
                                         int storage, const void* w0,
                                         const void* scales, void* out, int B,
                                         int m, int c, int d_c, int vec, int grid,
                                         int smem, int n_slices, int rows_per_unit,
                                         int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int32_t* ci = static_cast<const int32_t*>(codes);
  const float* w = static_cast<const float*>(w0);
  const float* s = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kF32:
      return launch_staged<float>(ci, cb, w, s, o, B, m, c, d_c, vec, grid, smem,
                                  n_slices, rows_per_unit, st);
    case kBF16:
      return launch_staged<__nv_bfloat16>(ci, cb, w, s, o, B, m, c, d_c, vec, grid,
                                          smem, n_slices, rows_per_unit, st);
    case kF16:
      return launch_staged<__half>(ci, cb, w, s, o, B, m, c, d_c, vec, grid, smem,
                                   n_slices, rows_per_unit, st);
    case kInt8:
      return launch_staged<int8_t>(ci, cb, w, s, o, B, m, c, d_c, vec, grid, smem,
                                   n_slices, rows_per_unit, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The codebook gradient: codes (B, m) int32, g (B, d_c) f32, w0 (d_c,) f32
// or null -> d_cb (m, c, d_c) written whole, f32 (storage 0), bf16 (1) or
// f16 (3).
// work: hash_decode_backward_sizes' sizes[0] int32 of device scratch for
// the sort's offsets, rows and counts.  Three launches: the sort's two, then
// the sum.
extern "C" int hash_decode_backward_launch(const void* codes, const void* g,
                                           const void* w0, void* d_cb, int storage,
                                           int B, int m, int c, int d_c, void* work,
                                           int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int32_t* ci = static_cast<const int32_t*>(codes);
  const float* gf = static_cast<const float*>(g);
  const float* w = static_cast<const float*>(w0);
  int* wk = static_cast<int*>(work);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kF32:
      return launch_backward<float>(ci, gf, w, d_cb, B, m, c, d_c, wk, st);
    case kBF16:
      return launch_backward<__nv_bfloat16>(ci, gf, w, d_cb, B, m, c, d_c, wk, st);
    case kF16:
      return launch_backward<__half>(ci, gf, w, d_cb, B, m, c, d_c, wk, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward's stable sort alone: codes (B, m) int32 -> offsets (m, c + 1)
// and rows (m, B) int32 (ref.py, code_order); counts: sizes[1] int32 of
// scratch.
extern "C" int hash_decode_sort_launch(const void* codes, int B, int m, int c, void* offsets,
                                       void* rows, void* counts, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return launch_sort(static_cast<const int32_t*>(codes), B, m, c, static_cast<int*>(offsets),
                     static_cast<int*>(rows), static_cast<int*>(counts),
                     static_cast<cudaStream_t>(stream));
}

// The backward's sizes at (B, m, c), so that its callers hold no copy of
// the layout: sizes[0] = int32 elements of its scratch (offsets (m, c + 1),
// rows (m, B), then the parts' counts), sizes[1] = the counts' share
// (kMaxParts * m * c).
extern "C" void hash_decode_backward_sizes(int B, int m, int c, long long* sizes) {
  const long long counts = static_cast<long long>(kMaxParts) * m * c;
  sizes[0] = static_cast<long long>(m) * (c + 1) + static_cast<long long>(m) * B + counts;
  sizes[1] = counts;
}

// The backward kernels' launches since the library was loaded or last
// reset: out[0..2] = count, place, sum; reset != 0 sets them to 0 after.
extern "C" void hash_decode_backward_kernel_launches(unsigned long long* out, int reset) {
  for (int i = 0; i < 3; ++i) out[i] = reset ? g_launched[i].exchange(0) : g_launched[i].load();
}
