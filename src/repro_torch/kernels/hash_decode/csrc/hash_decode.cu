// hash_decode for Hopper (sm_90a): compositional-code decode as a direct
// row gather-sum.
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
// What bounds it: device-memory bytes.  Per row it does m*d_c adds and
// writes d_c*4 bytes, reading m*4 bytes of codes; at the serving shape
// (B = 61,696, m = 16, c = 256, d_c = 512, f32) that is 126 MB written
// against 505 M adds, far below the card's f32 rate.  The 8 MiB of f32
// codebooks are read by every row but stay resident in the 50 MB L2, so the
// device-memory traffic is the codes, one pass over the codebooks and the
// output.  The design therefore keeps the write stream wide and coalesced:
// each thread owns 4 consecutive features (one 16-byte store; 16-, 8- or
// 4-byte loads for f32, bf16 or int8), a warp covers 128 consecutive
// features, and a block decodes a few rows whose m codes it stages once in
// shared memory.  Ragged B and d_c are masked inside the kernel (d_c not a
// multiple of 4 takes the scalar-load variant), so callers never pad.

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

}  // namespace

// Plain C entry point (loaded with ctypes).  Pointers are device pointers on
// card `device`; w0 and scales may be null.  storage: 0 = f32, 1 = bf16,
// 2 = int8.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
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
