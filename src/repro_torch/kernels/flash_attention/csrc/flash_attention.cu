// flash_attention for Hopper (sm_90a): causal or full attention with an
// online softmax and native GQA, forward only.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h/G, :] / sqrt(D)) v[b, j, h/G, :]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// function flash_attention_bhsd (body _flash_body).  It computes what that
// body computes, in the same order: q, k and v widened to f32; s = (q.k^T)
// * scale in f32; under the causal mask key positions above the query
// position get -1e30, and key tiles wholly above the diagonal are skipped;
// per tile m_new = max(m_prev, max_j s), p = exp(s - m_new), alpha =
// exp(m_prev - m_new), l = alpha*l + sum_j p, acc = acc*alpha + p.v with p
// kept in f32; the output acc / max(l, 1e-30) is written once, in q's type.
// The grid is not carried over block by block: the TPU kernel walks key
// blocks as the sequential last grid axis with its running state in VMEM;
// here one block owns a 64-row query tile and loops over the key tiles
// itself, with the running state in registers.
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, K, D), o (B, Sq, H, D), all
// contiguous, exactly as nn/attention.py holds them: nothing is transposed
// and K and V are never replicated (q head h reads kv head h / (H/K) in
// place).  Any Sq and Skv: out-of-range query rows are not stored, and
// out-of-range key rows load as zeros and score -1e30.  D in {32, 64, 128};
// float32 or bfloat16.
//
// What bounds it: operations.  At the training shape (B=4, H=16,
// S=2048, D=64, causal) the work is 4*D flops for each of 2,098,176
// visible (query, key) pairs per head, 34.4 GFLOP, against 67 MB of q, k,
// v and o.  This first kernel does the products in f32 on the CUDA cores
// (fmaf), so it sits far above the tensor-core bound; wgmma on bf16 tiles
// (exact products, f32 sums) with TMA-fed shared memory is the way down,
// in a later change.  The design keeps what a simple kernel can: each
// thread owns a 4 x 4 tile of scores and a 4 x D/16 tile of the output, so
// one shared-memory value feeds 4 FMAs; the Q and K tiles are padded by
// one float per row so the 16 threads of a row group read 16 banks; the
// heaviest causal query tiles are scheduled first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // key rows per tile
constexpr int TX = 16;           // threads across key columns / output columns
constexpr int TY = 16;           // threads across query rows
constexpr int THREADS = TX * TY;
constexpr int RQ = BQ / TY;      // query rows per thread (4)
constexpr int RK = BK / TX;      // key columns per thread (4)
constexpr int PP = BK + 1;       // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // sQ (BQ, D+1), sK (BK, D+1), sV (BK, D), sP (BQ, BK+1), all f32
  return sizeof(float) * (static_cast<size_t>(BQ) * (D + 1) +
                          static_cast<size_t>(BK) * (D + 1) +
                          static_cast<size_t>(BK) * D +
                          static_cast<size_t>(BQ) * PP);
}

// Butterfly over the 16 lanes of a row group: every lane ends with the same
// bits (each step adds the same pair of values, in either order).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Sq, int Skv, int H, int K, int causal, float scale) {
  constexpr int DP = D + 1;      // padded row stride of the Q and K tiles
  constexpr int RD = D / TX;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;              // (BQ, DP)
  float* sK = sQ + BQ * DP;      // (BK, DP)
  float* sV = sK + BK * DP;      // (BK, D)
  float* sP = sV + BK * D;       // (BQ, PP)

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D;
    const int qpos = q0 + r;
    sQ[r * DP + c] = qpos < Sq
        ? widen(q[((static_cast<size_t>(b) * Sq + qpos) * H + h) * D + c]) : 0.f;
  }

  float m_run[RQ], l_run[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  // causal: key tiles starting past the tile's last query row are skipped
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();             // the last tile's sK, sV, sP reads are done
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D;
      const int kpos = k0 + r;
      float kx = 0.f, vx = 0.f;
      if (kpos < Skv) {
        const size_t off = ((static_cast<size_t>(b) * Skv + kpos) * K + kvh) * D + c;
        kx = widen(k[off]);
        vx = widen(v[off]);
      }
      sK[r * DP + c] = kx;
      sV[r * D + c] = vx;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = sQ[(ty * RQ + i) * DP + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = sK[(tx + j * TX) * DP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty * RQ + i;
      const int qpos = q0 + row;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int kpos = k0 + tx + j * TX;
        float x = __fmul_rn(s[i][j], scale);
        if (kpos >= Skv || (causal && kpos > qpos)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m_run[i], group_max(mx));
      const float alpha = expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[row * PP + tx + j * TX] = p;
        psum = __fadd_rn(psum, p);
      }
      l_run[i] = __fadd_rn(__fmul_rn(alpha, l_run[i]), group_sum(psum));
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncthreads();             // the P tile is complete

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = sP[(ty * RQ + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < RD; ++c) vv[c] = sV[kk * D + tx + c * TX];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty * RQ + i;
    if (qpos >= Sq) continue;
    const float l = fmaxf(l_run[i], 1e-30f);
    T* orow = o + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < RD; ++c) orow[tx + c * TX] = narrow<T>(__fdiv_rn(acc[i][c], l));
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B,
                 int H, int K, int Sq, int Skv, int causal, float scale,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, K, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int B,
               int H, int K, int Sq, int Skv, int D, int causal, float scale,
               cudaStream_t stream) {
  switch (D) {
    case 32: return launch_typed<T, 32>(q, k, v, o, B, H, K, Sq, Skv, causal, scale, stream);
    case 64: return launch_typed<T, 64>(q, k, v, o, B, H, K, Sq, Skv, causal, scale, stream);
    case 128: return launch_typed<T, 128>(q, k, v, o, B, H, K, Sq, Skv, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Device pointers on card
// `device`; dtype 0 = float32, 1 = bfloat16.  Launches on `stream`, does
// not synchronise, returns the CUDA error code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype, int B,
                                      int H, int K, int Sq, int Skv, int D,
                                      int causal, float scale, int device,
                                      void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Skv <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dim<float>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, st);
    case kBF16:
      return launch_dim<__nv_bfloat16>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
