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
// Storage types: float32, bfloat16, or int8 with a per-(codebook, code)
// float32 scale table (scales (m, c)); every term is widened to f32 and the
// sum is taken in f32.  w0 (d_c,) float32 is optional.
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
// The backward (hash_decode_bwd_kernel, at the end) is the codebook
// gradient, which the JAX package computes in XLA, not in Pallas (its
// kernels/hash_decode/ops.py, _bwd: a one-hot contraction):
//
//   d_cb[j, k, :] = sum over b ascending with codes[b, j] = k of g[b, :] * w0
//
// summed in f32 from 0 with __fadd_rn (g * w0 rounded by __fmul_rn first),
// then rounded once to the codebooks' type (f32 or bf16, round to nearest
// even).  Every (j, k, f) sum belongs to one thread and runs in ascending
// b, so the result is the plain version's (ref.py, index_add_ on the CPU)
// bit for bit and the same on every run: no atomics.  What bounds it: the
// gradient g must be read once (B*d_c*4 bytes, 49 MB at a 24,000-row
// training frontier) and d_cb written once (8 MB at m = 16, c = 256,
// d_c = 512); the one-hot contraction it replaces does 2*B*m*c*d_c flops
// instead.  Its design: one block per (codebook j, 32-feature tile), its
// (c, 32) f32 accumulator in shared memory (32 KiB at c = 256); lane l owns
// feature f0 + l, and each of the 8 warps owns c/8 codes.  A warp sifts 256
// rows' codes a pass (the next 256 already in flight): ballots write the
// rows whose code is its own, in ascending order, to a list in shared
// memory, and the warp then loads their g rows (128 coalesced bytes each)
// 32 at a time before adding them in list order.  Each warp's passes run
// one after another, so the time goes with B / 256 times a load's latency
// and 32 shared-memory adds; g is read m times in all, mostly from L2
// (m*B*d_c*4 bytes, 0.79 GB at 24,000 rows).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

enum StorageType { kF32 = 0, kBF16 = 1, kInt8 = 2 };

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
// d_c > 4*TX), TY rows per block, one row per threadIdx.y.
template <typename T, bool VEC>
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
  for (int i = ty * blockDim.x + tx; i < rows_here * m; i += nthreads) {
    // out-of-range codes clamp, as the JAX gather's indexing does
    s_codes[i] = min(max(block_codes[i], 0), c - 1);
  }
  __syncthreads();
  if (ty >= rows_here) return;

  const int32_t* rc = s_codes + ty * m;
  float* orow = out + static_cast<size_t>(row0 + ty) * d_c;
  for (int f0 = tx * 4; f0 < d_c; f0 += blockDim.x * 4) {
    float acc[4];
#pragma unroll 4
    for (int j = 0; j < m; ++j) {
      const int code = rc[j];
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
                  int d_c, int vec, int tx, int ty, cudaStream_t stream) {
  const dim3 block(tx, ty);
  const dim3 grid((B + ty - 1) / ty);
  const size_t smem = static_cast<size_t>(ty) * m * sizeof(int32_t);
  const T* cbt = static_cast<const T*>(cb);
  if (vec) {
    hash_decode_kernel<T, true><<<grid, block, smem, stream>>>(
        codes, cbt, w0, scales, out, B, m, c, d_c);
  } else {
    hash_decode_kernel<T, false><<<grid, block, smem, stream>>>(
        codes, cbt, w0, scales, out, B, m, c, d_c);
  }
}

// ----- backward: the codebook gradient --------------------------------------

constexpr int kBwdTile = 32;     // features a block: one a lane
constexpr int kBwdWarps = 8;     // warps a block, each owning ceil(c / 8) codes
constexpr int kBwdRows = 256;    // rows a warp sifts a pass
constexpr int kBwdBatch = 32;    // matched rows whose g a warp loads at once

template <typename T> __device__ __forceinline__ T round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// grid (ceil(d_c / 32), m), kBwdWarps * 32 threads; dynamic shared memory:
// the (c, kBwdTile) f32 accumulator, then a list of kBwdRows entries a warp.
template <typename T, bool W0>
__global__ void __launch_bounds__(kBwdWarps * 32)
hash_decode_bwd_kernel(const int32_t* __restrict__ codes, const float* __restrict__ g,
                       const float* __restrict__ w0, T* __restrict__ d_cb,
                       int B, int m, int c, int d_c, int codes_per_warp) {
  constexpr int kSub = kBwdRows / 32;
  extern __shared__ float s_acc[];                  // (c, kBwdTile)
  const int j = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this warp's matched rows of a pass, ascending: code * kBwdRows + row
  int* s_list = reinterpret_cast<int*>(s_acc + c * kBwdTile) + warp * kBwdRows;
  const int f0 = blockIdx.x * kBwdTile;
  const int f = f0 + lane;
  const bool live = f < d_c;
  for (int i = threadIdx.x; i < c * kBwdTile; i += blockDim.x) s_acc[i] = 0.f;
  const float wf = (W0 && live) ? w0[f] : 1.f;
  const int k_lo = warp * codes_per_warp;
  const int k_hi = min(c, k_lo + codes_per_warp);
  const unsigned below = (1u << lane) - 1u;         // the lanes below this one
  // row b's code for codebook j, clamped as the forward clamps it; -1 past B
  auto code_of = [&](int b) {
    return b < B ? min(max(codes[static_cast<size_t>(b) * m + j], 0), c - 1) : -1;
  };
  int code[kSub];                                   // rows b0 + 32 i + lane
#pragma unroll
  for (int i = 0; i < kSub; ++i) code[i] = code_of(32 * i + lane);
  __syncthreads();
  for (int b0 = 0; b0 < B; b0 += kBwdRows) {
    int next[kSub];                                 // the next pass's, in flight
#pragma unroll
    for (int i = 0; i < kSub; ++i) next[i] = code_of(b0 + kBwdRows + 32 * i + lane);
    int count = 0;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const bool mine = code[i] >= k_lo && code[i] < k_hi;
      const unsigned ballot = __ballot_sync(0xffffffffu, mine);
      if (mine) s_list[count + __popc(ballot & below)] = code[i] * kBwdRows + 32 * i + lane;
      count += __popc(ballot);
    }
    __syncwarp();
    for (int base = 0; base < count; base += kBwdBatch) {   // in list order
      int e[kBwdBatch];
      float v[kBwdBatch];
#pragma unroll
      for (int u = 0; u < kBwdBatch; ++u) e[u] = base + u < count ? s_list[base + u] : -1;
#pragma unroll
      for (int u = 0; u < kBwdBatch; ++u) {
        v[u] = (e[u] >= 0 && live)
                   ? g[static_cast<size_t>(b0 + e[u] % kBwdRows) * d_c + f] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBwdBatch; ++u) {
        if (e[u] >= 0) {
          float* a = s_acc + (e[u] / kBwdRows) * kBwdTile + lane;
          *a = __fadd_rn(*a, W0 ? __fmul_rn(v[u], wf) : v[u]);
        }
      }
    }
    __syncwarp();                                   // the list is rewritten next pass
#pragma unroll
    for (int i = 0; i < kSub; ++i) code[i] = next[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < c * kBwdTile; i += blockDim.x) {
    const int k = i / kBwdTile, l = i % kBwdTile;
    if (f0 + l < d_c) {
      d_cb[(static_cast<size_t>(j) * c + k) * d_c + f0 + l] = round_to<T>(s_acc[i]);
    }
  }
}

template <typename T>
int launch_backward(const int32_t* codes, const float* g, const float* w0, void* d_cb,
                    int B, int m, int c, int d_c, cudaStream_t stream) {
  T* out = static_cast<T*>(d_cb);
  auto kernel = w0 != nullptr ? hash_decode_bwd_kernel<T, true>
                              : hash_decode_bwd_kernel<T, false>;
  const int smem = (c * kBwdTile + kBwdWarps * kBwdRows) * static_cast<int>(sizeof(float));
  static int allowed[2] = {0, 0};                   // as in launch_staged
  const int slot = w0 != nullptr;
  if (smem > 48 * 1024 && smem > allowed[slot]) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    allowed[slot] = smem;
  }
  const dim3 grid((d_c + kBwdTile - 1) / kBwdTile, m);
  kernel<<<grid, kBwdWarps * 32, smem, stream>>>(codes, g, w0, out, B, m, c, d_c,
                                                 (c + kBwdWarps - 1) / kBwdWarps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Pointers are device pointers
// on card `device`; w0 and scales may be null.  storage: 0 = f32, 1 = bf16,
// 2 = int8.  They launch on `stream`, do not synchronise and return
// cudaGetLastError() (or the error of setting the shared-memory size).

// The direct variant: blockDim (tx, ty).
extern "C" int hash_decode_launch(const void* codes, const void* cb,
                                  int storage, const void* w0,
                                  const void* scales, void* out, int B, int m,
                                  int c, int d_c, int vec, int tx, int ty,
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
      launch_typed<float>(ci, cb, w, s, o, B, m, c, d_c, vec, tx, ty, st);
      break;
    case kBF16:
      launch_typed<__nv_bfloat16>(ci, cb, w, s, o, B, m, c, d_c, vec, tx, ty, st);
      break;
    case kInt8:
      launch_typed<int8_t>(ci, cb, w, s, o, B, m, c, d_c, vec, tx, ty, st);
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
    case kInt8:
      return launch_staged<int8_t>(ci, cb, w, s, o, B, m, c, d_c, vec, grid, smem,
                                   n_slices, rows_per_unit, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The codebook gradient: codes (B, m) int32, g (B, d_c) f32, w0 (d_c,) f32
// or null -> d_cb (m, c, d_c) written whole, f32 (storage 0) or bf16 (1).
extern "C" int hash_decode_backward_launch(const void* codes, const void* g,
                                           const void* w0, void* d_cb, int storage,
                                           int B, int m, int c, int d_c, int device,
                                           void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int32_t* ci = static_cast<const int32_t*>(codes);
  const float* gf = static_cast<const float*>(g);
  const float* w = static_cast<const float*>(w0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case kF32:
      return launch_backward<float>(ci, gf, w, d_cb, B, m, c, d_c, st);
    case kBF16:
      return launch_backward<__nv_bfloat16>(ci, gf, w, d_cb, B, m, c, d_c, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
