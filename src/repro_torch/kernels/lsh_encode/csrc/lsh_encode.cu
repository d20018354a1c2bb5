// lsh_encode for Hopper (sm_90a): Algorithm 1's project-binarise-pack for a
// dense auxiliary matrix, every code word of an entity in one pass over A.
//
//   u[r, j]  = sum_k A[r, k] * V[k, j]          A (n, d), V (d, W <= 128), f32
//   word[r, i] = sum_{b<32} (u[r, 32i+b] > t[32i+b]) << b
//
// Replaces the TPU kernel src/repro/kernels/lsh_encode/kernel.py, function
// lsh_encode_word (body _encode_body), which computes one 32-bit word (W <=
// 32) per call.  Here one launch takes all W <= 128 projection columns of a
// (c, m) = (256, 16) code (four words), so A is read once per encode rather
// than twice per word.
//
// Three entry points over two kernels:
//   lsh_project_launch  U = A V, stored (n, W) f32      (the exact-median path)
//   lsh_encode_launch   the words of U > t, U never stored (zero / sampled
//                       median thresholds, and the TPU kernel's counterpart)
//   lsh_pack_launch     the words of a stored U > t     (after the median)
//
// The product is a register-tiled f32 GEMM on the CUDA cores.  A block owns
// 128 rows and all BN = 32, 64 or 128 columns (the smallest that holds W),
// with 2*BN threads; each thread holds an 8 x 8 tile of accumulators: rows
// tm + 16 i (i < 8) and columns tn*4 + {0..3} and BN/2 + tn*4 + {0..3}.  A's
// (128 x 32) k-tiles and V's (32 x BN) k-tiles stream into shared memory
// through cp.async, a ring of two stages (dynamic shared memory, 68 KiB at
// BN = 128), so one tile loads while one computes and a tile costs one
// __syncthreads.  A's rows are padded to 36 floats, so the reads of
// neighbouring rows fall in different banks; A is read two k at a time
// (float2); V's float4 reads are 128 consecutive bytes per quarter-warp.
// The registers are not capped: at BN = 128 one block of 8 warps an SM
// with no spills took 9% (d = 300) and 19% (d = 512) less time on an H100
// than two blocks held to 128 registers, which spilled
// (`python -m repro_torch.kernels.lsh_encode.ablate`).
// With one block an SM nothing else hides a block's first loads and its
// stores, so the grid is persistent: a block walks row tiles
// blockIdx.x + gridDim.x * i, and its ring runs on from one row tile's k
// tiles into the next one's.
//
// Arithmetic: IEEE f32, never TF32 (a TF32 product flips bits near the
// median).  Every u[r, j] starts at 0 and adds its products in ascending k
// with __fmaf_rn, which --fmad=false leaves alone: one rounding per k,
// whatever the tiling.  So with integer-valued inputs whose sums stay below
// 2^24 every sum is exact and the words equal the plain version's bit for
// bit; otherwise each u lies within d 2^-24 sum_k |A_rk V_kj| of the exact
// sum, as a cuBLAS product does.
//
// Ragged shapes are handled here, not by padding: rows past n, k past d and
// columns past W are zero-filled by cp.async (a +0 product added to a sum
// leaves it unchanged), rows past n are not stored, and columns past W are
// left out of the words.  d and W multiples of 4 with aligned operands take
// 16-byte copies; any other shape takes 4-byte copies.
//
// What bounds it: at W = 128 the f32 FMAs, 2 n d W flops (0.229 ms at the
// reconstruction shape n = 200,000, d = 300 on the data sheet's 67 TFLOP/s)
// against 0.102 ms for the bytes of A and U.  The 8 x 8 thread tile makes
// 64 FMAs for every 6 shared-memory reads (4 of A, float2 over two k; 2 of
// V).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 8;       // rows per thread
constexpr int kBM = 16 * kTM; // rows per block (16 threads down the rows)
constexpr int kBK = 32;      // k per shared-memory tile
constexpr int kStages = 2;   // tiles in flight (cp.async ring)
constexpr int kAK = 2;       // k values of A per shared-memory read (float2)
constexpr int kAPad = 4;     // A's smem row stride is kBK + kAPad floats
constexpr int kMaxW = 128;

// Dynamic shared memory of one block: kStages x (A tile, V tile).
template <int BN> struct Ring {
  static constexpr int kA = kBM * (kBK + kAPad);    // floats of an A tile
  static constexpr int kV = kBK * BN;               // floats of a V tile
  static constexpr int kBytes = kStages * (kA + kV) * 4;
};

// kAK consecutive floats from shared memory as one vector read.
template <int K> struct Frag;
template <> struct Frag<2> {
  __device__ __forceinline__ static void load(const float* p, float a[2]) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    a[0] = x.x; a[1] = x.y;
  }
};
template <> struct Frag<4> {
  __device__ __forceinline__ static void load(const float* p, float a[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    a[0] = x.x; a[1] = x.y; a[2] = x.z; a[3] = x.w;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The epilogues of a row tile.  Accumulator j of a thread is column
// tn*4 + j (j < 4) or BN/2 + tn*4 + (j - 4) (j >= 4), of rows tm + 16 i.
template <int BN, bool VEC>
__device__ __forceinline__ void store_u(const float (&acc)[kTM][8], float* __restrict__ U,
                                        int64_t row0, int n, int w, int tn, int tm) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = row0 + tm + 16 * i;
    if (row >= n) continue;
    float* urow = U + row * w;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * (BN / 2) + tn * 4;
      if (VEC) {
        if (col < w) {
          *reinterpret_cast<float4*>(urow + col) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (col + q < w) urow[col + q] = acc[i][4 * h + q];
        }
      }
    }
  }
}

// Compare and pack: each thread makes the 4-bit pieces of its two column
// groups; the 8 (BN >= 64) or 4 (BN = 32) lanes that share a word OR them
// together with shuffles, and the group's first lane stores the word.
template <int BN>
__device__ __forceinline__ void store_words(const float (&acc)[kTM][8],
                                            const float* __restrict__ t,
                                            int32_t* __restrict__ words, int64_t row0,
                                            int n, int w, int tn, int tm) {
  constexpr int TN = BN / 8;
  constexpr int G = TN < 8 ? TN : 8;
  const int nw = (w + 31) / 32;
  float tv[8];
  bool cv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = (j >> 2) * (BN / 2) + tn * 4 + (j & 3);
    cv[j] = col < w;
    tv[j] = cv[j] ? t[col] : 0.0f;
  }
  const int wi0 = (tn * 4) / 32;
  const int wi1 = (BN / 2 + tn * 4) / 32;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    unsigned p0 = 0, p1 = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (cv[q] && acc[i][q] > tv[q]) p0 |= 1u << ((tn * 4 + q) & 31);
      if (cv[4 + q] && acc[i][4 + q] > tv[4 + q]) p1 |= 1u << ((BN / 2 + tn * 4 + q) & 31);
    }
    if (BN == 32) p0 |= p1;                  // both groups lie in word 0
#pragma unroll
    for (int off = 1; off < G; off <<= 1) {
      p0 |= __shfl_xor_sync(0xffffffffu, p0, off);
      if (BN != 32) p1 |= __shfl_xor_sync(0xffffffffu, p1, off);
    }
    const int64_t row = row0 + tm + 16 * i;
    if (row < n && tn % G == 0) {
      int32_t* wrow = words + row * nw;
      if (wi0 < nw) wrow[wi0] = static_cast<int32_t>(p0);
      if (BN != 32 && wi1 < nw) wrow[wi1] = static_cast<int32_t>(p1);
    }
  }
}

// PACK = false: store U (n, w).  PACK = true: store the words (n, ceil(w/32))
// of U > t.  VEC: d % 4 == 0, w % 4 == 0 and 16-byte aligned A, V and U.
template <int BN, bool VEC, bool PACK>
__global__ void __launch_bounds__(2 * BN)
lsh_project_kernel(const float* __restrict__ A, const float* __restrict__ V,
                   const float* __restrict__ t, float* __restrict__ U,
                   int32_t* __restrict__ words, int n, int d, int w) {
  constexpr int kThreads = 2 * BN;
  constexpr int TN = BN / 8;                 // threads across the columns
  constexpr int kLd = kBK + kAPad;           // A's smem row stride
  extern __shared__ __align__(16) float ring[];
  float* const As = ring;                                   // [kStages][kBM][kLd]
  float* const Vs = ring + kStages * Ring<BN>::kA;          // [kStages][kBK][BN]
  const int tid = threadIdx.x;
  const int tn = tid % TN;
  const int tm = tid / TN;                   // 0..15

  auto load_tile = [&](int stage, int64_t row0, int k0) {
    float* const as = As + stage * Ring<BN>::kA;
    float* const vs = Vs + stage * Ring<BN>::kV;
    if (VEC) {
#pragma unroll
      for (int it = 0; it < kBM * kBK / 4 / kThreads; ++it) {
        const int q = tid + it * kThreads;
        const int r = q / (kBK / 4), kc = (q % (kBK / 4)) * 4;
        const int64_t row = row0 + r;
        const bool ok = row < n && k0 + kc < d;
        cp_async16(as + r * kLd + kc, ok ? A + row * d + k0 + kc : A, ok);
      }
#pragma unroll
      for (int it = 0; it < kBK * BN / 4 / kThreads; ++it) {
        const int q = tid + it * kThreads;
        const int kk = q / (BN / 4), col = (q % (BN / 4)) * 4;
        const bool ok = k0 + kk < d && col < w;
        cp_async16(vs + kk * BN + col,
                   ok ? V + static_cast<int64_t>(k0 + kk) * w + col : V, ok);
      }
    } else {
#pragma unroll 4
      for (int it = 0; it < kBM * kBK / kThreads; ++it) {
        const int q = tid + it * kThreads;
        const int r = q / kBK, kk = q % kBK;
        const int64_t row = row0 + r;
        const bool ok = row < n && k0 + kk < d;
        cp_async4(as + r * kLd + kk, ok ? A + row * d + k0 + kk : A, ok);
      }
#pragma unroll 4
      for (int it = 0; it < kBK * BN / kThreads; ++it) {
        const int q = tid + it * kThreads;
        const int kk = q / BN, col = q % BN;
        const bool ok = k0 + kk < d && col < w;
        cp_async4(vs + kk * BN + col,
                  ok ? V + static_cast<int64_t>(k0 + kk) * w + col : V, ok);
      }
    }
  };

  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  // Persistent: this block's row tiles are blockIdx.x + gridDim.x * i, and
  // its steps (row tile, k tile) run in one sequence, so the ring loads the
  // next row tile's first k tiles while this one's last compute and store.
  // The counters advance by increments (no division in the loop).
  const int nk = max(1, (d + kBK - 1) / kBK);         // d = 0: one zero tile
  const int64_t tiles = (static_cast<int64_t>(n) + kBM - 1) / kBM;
  const int steps = blockIdx.x < tiles
      ? static_cast<int>((tiles - 1 - blockIdx.x) / gridDim.x + 1) * nk : 0;
  const int64_t row_step = static_cast<int64_t>(gridDim.x) * kBM;
  int64_t load_row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  int load_kt = 0, load_stage = 0;
  auto load_next = [&]() {
    load_tile(load_stage, load_row0, load_kt * kBK);
    if (++load_stage == kStages) load_stage = 0;
    if (++load_kt == nk) { load_kt = 0; load_row0 += row_step; }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_next();
    cp_async_commit();
  }
  int64_t row0 = static_cast<int64_t>(blockIdx.x) * kBM;
  int kt = 0, stage = 0;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();            // this step's tile has landed ...
    __syncthreads();                         // ... for every thread, and the last step is done
    if (step + kStages - 1 < steps) load_next();
    cp_async_commit();
    const float* const as = As + stage * Ring<BN>::kA;
    const float* const vs = Vs + stage * Ring<BN>::kV;
    if (++stage == kStages) stage = 0;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += kAK) {
      float a[kTM][kAK];
#pragma unroll
      for (int i = 0; i < kTM; ++i) Frag<kAK>::load(as + (tm + 16 * i) * kLd + kk, a[i]);
#pragma unroll
      for (int q = 0; q < kAK; ++q) {
        const float4 v0 = *reinterpret_cast<const float4*>(vs + (kk + q) * BN + tn * 4);
        const float4 v1 = *reinterpret_cast<const float4*>(vs + (kk + q) * BN + BN / 2 + tn * 4);
        const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(a[i][q], v[j], acc[i][j]);
        }
      }
    }
    if (++kt == nk) {                        // the row tile's last k tile: store it
      if (PACK) {
        store_words<BN>(acc, t, words, row0, n, w, tn, tm);
      } else {
        store_u<BN, VEC>(acc, U, row0, n, w, tn, tm);
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      kt = 0;
      row0 += row_step;
    }
  }
}

// The words of a stored U (n, w) against t.  VEC (w % 4 == 0, U aligned):
// lane l of a warp reads columns 4l .. 4l + 3 of a row as one float4, so a
// row of 128 columns is one 512-byte read; its four bits go to word l / 8,
// and the 8 lanes of a word OR their bits together with shuffles.  A warp
// keeps kPackRows rows in flight.  Otherwise: lane b of word i compares
// column 32 i + b and __ballot_sync packs the word.
constexpr int kPackWarps = 8;
constexpr int kPackRows = 4;

template <bool VEC>
__global__ void __launch_bounds__(kPackWarps * 32)
lsh_pack_kernel(const float* __restrict__ U, const float* __restrict__ t,
                int32_t* __restrict__ words, int n, int w) {
  const int lane = threadIdx.x & 31;
  const int nw = (w + 31) / 32;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kPackWarps + (threadIdx.x >> 5);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kPackWarps;
  if (VEC) {
    const int col = 4 * lane;
    const bool live = col < w;
    float tl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) tl[q] = live ? t[col + q] : 0.0f;
    for (int64_t row0 = warp * kPackRows; row0 < n; row0 += warps * kPackRows) {
      float4 u[kPackRows];
#pragma unroll
      for (int r = 0; r < kPackRows; ++r) {
        const int64_t row = row0 + r;
        u[r] = live && row < n ? *reinterpret_cast<const float4*>(U + row * w + col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int r = 0; r < kPackRows; ++r) {
        unsigned bits = live ? (static_cast<unsigned>(u[r].x > tl[0]) |
                                static_cast<unsigned>(u[r].y > tl[1]) << 1 |
                                static_cast<unsigned>(u[r].z > tl[2]) << 2 |
                                static_cast<unsigned>(u[r].w > tl[3]) << 3) << (col & 31)
                             : 0u;
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, off);
        const int64_t row = row0 + r;
        if (row < n && (lane & 7) == 0 && lane / 8 < nw) words[row * nw + lane / 8] =
            static_cast<int32_t>(bits);
      }
    }
    return;
  }
  float tl[kMaxW / 32];
#pragma unroll
  for (int i = 0; i < kMaxW / 32; ++i) {
    const int col = 32 * i + lane;
    tl[i] = col < w ? t[col] : 0.0f;
  }
  for (int64_t row = warp; row < n; row += warps) {
    const float* urow = U + row * w;
    unsigned mine = 0;
#pragma unroll
    for (int i = 0; i < kMaxW / 32; ++i) {
      if (i < nw) {
        const int col = 32 * i + lane;
        const bool bit = col < w && urow[col] > tl[i];
        const unsigned word = __ballot_sync(0xffffffffu, bit);
        if (lane == i) mine = word;
      }
    }
    if (lane < nw) words[row * nw + lane] = static_cast<int32_t>(mine);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The ring is above the 48 KiB of static shared memory: each instantiation
// is allowed its size once (the first launch), before it is launched.
template <int BN, bool PACK>
int launch_bn(bool vec, const float* A, const float* V, const float* t, float* U,
              int32_t* words, int n, int d, int w, cudaStream_t stream) {
  static bool allowed[2] = {false, false};
  auto kernel = vec ? lsh_project_kernel<BN, true, PACK> : lsh_project_kernel<BN, false, PACK>;
  if (!allowed[vec]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<BN>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[vec] = true;
  }
  // persistent: as many blocks as fit on the card at once, at most one a row tile
  static int resident[2] = {0, 0};
  if (resident[vec] == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 2 * BN, Ring<BN>::kBytes);
    resident[vec] = max(1, sms * per_sm);
  }
  const int tiles = (n + kBM - 1) / kBM;
  kernel<<<min(tiles, resident[vec]), 2 * BN, Ring<BN>::kBytes, stream>>>(
      A, V, t, U, words, n, d, w);
  return static_cast<int>(cudaGetLastError());
}

template <bool PACK>
int launch_project(const float* A, const float* V, const float* t, float* U,
                   int32_t* words, int n, int d, int w, cudaStream_t stream) {
  const bool vec = d % 4 == 0 && w % 4 == 0 && aligned16(A) && aligned16(V) &&
                   (PACK || aligned16(U));
  if (w <= 32) return launch_bn<32, PACK>(vec, A, V, t, U, words, n, d, w, stream);
  if (w <= 64) return launch_bn<64, PACK>(vec, A, V, t, U, words, n, d, w, stream);
  return launch_bn<128, PACK>(vec, A, V, t, U, words, n, d, w, stream);
}

int prologue(int device, int n, int d, int w) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (w < 1 || w > kMaxW || d < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each returns a cudaError_t
// code; 0 means the launch was accepted (or n = 0: nothing to launch).  They
// launch on `stream`, do not synchronise and allocate nothing.

// U (n, w) = A (n, d) @ V (d, w), w <= 128.
extern "C" int lsh_project_launch(const void* A, const void* V, void* U, int n,
                                  int d, int w, int device, void* stream) {
  const int err = prologue(device, n, d, w);
  if (err != 0 || n == 0) return err;
  return launch_project<false>(static_cast<const float*>(A), static_cast<const float*>(V),
                               nullptr, static_cast<float*>(U), nullptr, n, d, w,
                               static_cast<cudaStream_t>(stream));
}

// words (n, ceil(w/32)) int32 of (A @ V) > t, w <= 128; U is never stored.
extern "C" int lsh_encode_launch(const void* A, const void* V, const void* t,
                                 void* words, int n, int d, int w, int device,
                                 void* stream) {
  const int err = prologue(device, n, d, w);
  if (err != 0 || n == 0) return err;
  return launch_project<true>(static_cast<const float*>(A), static_cast<const float*>(V),
                              static_cast<const float*>(t), nullptr,
                              static_cast<int32_t*>(words), n, d, w,
                              static_cast<cudaStream_t>(stream));
}

// words (n, ceil(w/32)) int32 of U (n, w) > t, w <= 128.
extern "C" int lsh_pack_launch(const void* U, const void* t, void* words, int n,
                               int w, int device, void* stream) {
  const int err = prologue(device, n, 0, w);
  if (err != 0 || n == 0) return err;
  const bool vec = w % 4 == 0 && aligned16(U);
  const int rows_a_block = kPackWarps * (vec ? kPackRows : 1);
  const int blocks = (n + rows_a_block - 1) / rows_a_block;
  const float* u = static_cast<const float*>(U);
  const float* th = static_cast<const float*>(t);
  int32_t* out = static_cast<int32_t*>(words);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    lsh_pack_kernel<true><<<blocks, kPackWarps * 32, 0, st>>>(u, th, out, n, w);
  } else {
    lsh_pack_kernel<false><<<blocks, kPackWarps * 32, 0, st>>>(u, th, out, n, w);
  }
  return static_cast<int>(cudaGetLastError());
}
