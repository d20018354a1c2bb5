// lsh_encode for Hopper (sm_90a): Algorithm 1's project-binarise-pack for a
// dense auxiliary matrix, one 32-bit code word per entity.
//
//   u[r, j]  = sum_k A[r, k] * V[k, j]      A (n, d), V (d, w <= 32), f32
//   word[r]  = sum_j (u[r, j] > t[j]) << j
//
// Replaces the TPU kernel src/repro/kernels/lsh_encode/kernel.py, function
// lsh_encode_word (body _encode_body).  The TPU kernel runs a grid over
// (row blocks, d blocks) and carries the (block_n, w) product in VMEM across
// the sequential d axis, then compares and packs at the last d step.  Here a
// block owns 64 rows and walks over d itself, so nothing carries between
// blocks; the product never leaves registers.
//
// Layout: 8 warps a block, 8 rows a warp.  Lane j owns bit column j: it
// keeps the d-chunk's column V[k0:k0+32, j] in registers and one f32
// accumulator per row of its warp.  The block stages a (64 rows x 32)
// chunk of A in shared memory with coalesced loads (one warp reads 128
// consecutive bytes of a row); each lane then reads the row's values as
// float4 broadcasts (every lane the same address, one transaction).  After
// the last chunk, __ballot_sync(u_j > t_j) over the warp's lanes is exactly
// the word sum_j bits_j << j, and lane r stores row r's word.
//
// Arithmetic: IEEE f32 on the CUDA cores, never TF32 (a TF32 product flips
// bits near the median).  Each u[r, j] starts at 0 and adds the products in
// k-ascending order, the multiply and the add rounded separately
// (__fmul_rn / __fadd_rn; the build also passes --fmad=false).  So with
// integer-valued inputs whose sums stay below 2^24 every sum is exact and
// the word equals the plain version's bit for bit; otherwise it differs
// from a cuBLAS product only where |u - t| is within rounding.
//
// Ragged shapes are handled here, not by padding: rows past n and columns
// past d are staged as 0 in shared memory (a +0 product added to a sum
// leaves it unchanged, so the sum is the one over k < d), rows past n are
// not stored, and lanes j >= w hold V = 0 and are left out of the ballot.
//
// What bounds it: the device-memory read of A (n*d*4 bytes, 240 MB at the
// reconstruction shape n=200,000, d=300) against 2*n*d*w flops.  With
// unfused multiplies and adds the kernel issues twice the FMA count, so its
// own floor is the f32 issue rate rather than the byte stream; the design
// keeps A's bytes read once and coalesced and V in registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;   // rows per block
constexpr int kChunk = 32;                      // d values staged per pass

__global__ void __launch_bounds__(kWarps * 32)
lsh_encode_kernel(const float* __restrict__ A, const float* __restrict__ V,
                  const float* __restrict__ t, int32_t* __restrict__ out,
                  int n, int d, int w) {
  __shared__ __align__(16) float As[kRows][kChunk];
  __shared__ float Vs[kChunk][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;

  float acc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int k = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) {
      const int r = warp + kWarps * i;
      const int64_t row = row0 + r;
      As[r][lane] = (row < n && k < d) ? A[row * d + k] : 0.0f;
    }
    for (int i = warp; i < kChunk; i += kWarps) {
      const int kv = k0 + i;
      Vs[i][lane] = (kv < d && lane < w)
                        ? V[static_cast<int64_t>(kv) * w + lane] : 0.0f;
    }
    __syncthreads();

    float v[kChunk];
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) v[kk] = Vs[kk][lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4* a4 = reinterpret_cast<const float4*>(As[warp * kRowsPerWarp + r]);
      float u = acc[r];
#pragma unroll
      for (int q = 0; q < kChunk / 4; ++q) {
        const float4 a = a4[q];
        u = __fadd_rn(u, __fmul_rn(a.x, v[4 * q + 0]));
        u = __fadd_rn(u, __fmul_rn(a.y, v[4 * q + 1]));
        u = __fadd_rn(u, __fmul_rn(a.z, v[4 * q + 2]));
        u = __fadd_rn(u, __fmul_rn(a.w, v[4 * q + 3]));
      }
      acc[r] = u;
    }
    __syncthreads();
  }

  const float tj = lane < w ? t[lane] : 0.0f;
  unsigned mine = 0;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const unsigned word = __ballot_sync(0xffffffffu, lane < w && acc[r] > tj);
    if (lane == r) mine = word;
  }
  const int64_t row = row0 + warp * kRowsPerWarp + lane;
  if (lane < kRowsPerWarp && row < n) out[row] = static_cast<int32_t>(mine);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Returns a cudaError_t code; 0
// means the launch was accepted.  Launches on `stream`, does not
// synchronise, allocates nothing.
extern "C" int lsh_encode_launch(const void* A, const void* V, const void* t,
                                 void* out, int n, int d, int w, int device,
                                 void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0) return 0;
  if (w < 1 || w > 32 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + kRows - 1) / kRows;
  lsh_encode_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(V),
      static_cast<const float*>(t), static_cast<int32_t*>(out), n, d, w);
  return static_cast<int>(cudaGetLastError());
}
