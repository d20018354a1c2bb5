// flash_attention for Hopper (sm_90a): causal or full attention with an
// online softmax and native GQA, forward only.
//
//   o[b, i, h, :] = sum_j softmax_j(q[b, i, h, :] . k[b, j, h/G, :] / sqrt(D)) v[b, j, h/G, :]
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py,
// function flash_attention_bhsd (body _flash_body).  It computes what that
// body computes: s = (q.k^T) * scale with f32 sums; under the causal mask
// key positions above the query position get -1e30, and key tiles wholly
// above the diagonal are skipped; per tile m_new = max(m_prev, max_j s),
// p = exp(s - m_new), alpha = exp(m_prev - m_new), l = alpha*l + sum_j p,
// acc = acc*alpha + p.v; the output acc / max(l, 1e-30) is written once, in
// q's type.  The grid is not carried over block by block: the TPU kernel
// walks key blocks as the sequential last grid axis with its running state
// in VMEM; here one block owns a query tile and loops over the key tiles
// itself, with the running state in registers.
//
// Layout: q (B, Sq, H, D), k and v (B, Skv, K, D), o (B, Sq, H, D), all
// contiguous, exactly as nn/attention.py holds them: nothing is transposed
// and K and V are never replicated (q head h reads kv head h / (H/K) in
// place).  Any Sq and Skv: out-of-range query rows are not stored, and
// out-of-range key rows load as zeros and score -1e30.  Types: float32,
// bfloat16 and float16.  Any D % 8 == 0: a D <= 256 (the configs use 32,
// 64, 112 and 128) runs the tiled kernel of its dtype at the next tile
// width of 32, 64, 128 and 256, its columns from D on zeros, and stores
// only the D columns; a D above 256 runs the panel kernel (at the end),
// which streams D through shared memory.  The wrapper pads another D up to
// the step with zero columns.
//
// What bounds it: operations.  At the training shape (B=4, H=16, S=2048,
// D=64, causal, bf16) the work is 4*D flops for each of 2,098,176 visible
// (query, key) pairs per head, 34.4 GFLOP: 0.0348 ms at the bf16
// tensor-core peak, against 67 MB of q, k, v and o (0.0200 ms).  Two
// kernels, chosen by dtype:
//
// bfloat16 (the training path) and float16: both products on the tensor
// cores (wgmma .bf16 or .f16 operands, f32 sums).  A block is one producer
// warpgroup and two (DT >= 128) or three (DT <= 64) consumer warpgroups of
// 64 query rows each, as registers allow (setmaxnreg moves the producer's
// registers to the consumers).  One producer thread issues TMA loads of the
// Q tile (two slots) and of 128-row K and V tiles into a ring of stages
// (at DT = 256: one Q slot and 64-row tiles, 192 KB of shared memory; each
// consumer's O then takes 128 registers a thread and S 32), completed on
// mbarriers; the tensor maps are 4-D
// views of the (B, S, heads, D) tensors (dims D, heads, S, B; box (DT or
// 64, 1, rows, 1)), so a tile is one copy, GQA is a coordinate, and rows
// past S and columns past D arrive as zeros.  Each consumer warpgroup: S = Q.K^T is a wgmma
// (m64n128k16, Q and K from shared memory, K as stored is the K-major B
// operand; m64n64k16 at DT = 256); the softmax runs on the f32 accumulator
// fragment in registers (quad shuffles for each row's max, exp2 with
// scale*log2(e) folded in, a mask only on tiles that cross the diagonal or
// the end of the keys); P is rounded to the operands' type in place, since
// the accumulator layout of wgmma is its register-A layout, and O += P.V is
// a second wgmma with V from shared memory as the MN-major B operand (the
// transpose bit).  The plain version rounds its softmax weights to q's type
// before .v as well.  S of tile t and
// P.V of tile t - 1 share one wgmma window, so tile t's softmax runs while
// P.V is on the tensor cores.  Q, K and V tiles use the swizzle that the
// wgmma descriptors name: 128 B for DT = 64 and DT = 128 (two 64-column
// panels), 64 B for DT = 32.  Under the causal mask a warpgroup skips the
// key tiles wholly above its own 64 rows.  The grid is persistent, one
// block per SM, walking (batch, head, query tile) units heaviest causal
// unit first, dealt to the blocks in a snake.  What is left between this
// and the bound: the softmax's instructions (at D = 64 one exp2 and about
// four other operations for every 256 flops) and the K/V tiles read from
// L2 once per query tile (python -m repro_torch.kernels.flash_attention.ablate
// times the parts).
//
// float32 (the card-vs-CPU references): the CUDA-core kernel, IEEE f32
// FMAs from shared-memory tiles; on the tensor cores f32 would be TF32,
// which the 2e-5 tolerance does not allow.  What bounds it is the FMA
// pipe: at the shape above 0.5131 ms at the 67 TFLOP/s f32 peak.  A block
// of 256 threads owns 128 query rows; each thread an 8 x 8 register tile of
// S (8 x 4 at DT = 128, whose key tiles are 64 rows) and 8 rows x DT/16
// columns of O (at DT = 256: 64 query rows and 32-row key tiles, 4 x 2 of S
// and 4 rows x 16 columns of O, in 204,800 B of shared memory).  Q sits in shared memory D-major, so per d a thread's 8
// rows are two 128-bit reads; K row-major, so a 128-bit read gives one of
// its keys at 4 d: per 4 d, 16 reads for 256 FMAs.  The lanes of a warp
// that share rows or keys read them by broadcast, and the tiles' 4-float
// chunks are swizzled (Q's by d, K's by key, P's by row group), so neither
// the copies nor the reads conflict.  K/V tiles are double-buffered with
// 16-byte cp.async: tile t + 1 is copied while tile t is multiplied.  The
// softmax takes exp2 with scale*log2(e) folded in, masks only the tiles
// that cross the diagonal or the end of the keys, and skips those wholly
// above it; P makes one trip through shared memory, written and read back
// by the 16 lanes that own its rows, as 128-bit loads for O += P.V.  No
// atomics; each output row's sums run in one fixed order.  Blocks are
// numbered heaviest causal query tile first.  Its registers (up to 255 a
// thread) and 229,376 B of shared memory leave one block of 8 warps an SM
// (python -m repro_torch.kernels.flash_attention.ablate times the parts).

#include <cuda.h>          // CUtensorMap and its encode's types; the encode is fetched at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// The head dims the tiled kernels take: D <= 256 and D % 8 == 0 (the
// 16-bit kernel's TMA row stride, D * 2 bytes, must be a multiple of 16;
// the f32 kernel copies 8 d at a time).  A larger D runs the panel kernel;
// the entry point refuses a D % 8 != 0, which the wrapper pads up to the
// step with zero columns.
constexpr int kMaxTileDim = 256;
constexpr int kTileStep = 8;

// Error codes of the entry point besides cudaError_t (which stays below 1000).
constexpr int kErrTensorMap = 1000;     // + the CUresult of cuTensorMapEncodeTiled
constexpr int kErrEntryPoint = 2000;    // + the status of cudaGetDriverEntryPoint's lookup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------
namespace cuda_core {

constexpr int THREADS = 256;
constexpr int TX = 16;           // threads across key columns / output columns

// DT: the tile's head width (32, 64, 128 or 256; columns from D on are zeros)
template <int DT>
struct Tile {
  // query rows per block: 128, but 64 at DT = 256, where a 128-row Q tile
  // alone would take 128 KB of shared memory
  static constexpr int BQ = DT == 256 ? 64 : 128;
  static constexpr int RQ = BQ / 16;                // query rows per thread: 4 * ty + (0..3), and 64 + the same
  // key rows per tile, as shared memory allows: 64 at DT = 128, 32 at DT = 256
  static constexpr int BK = DT == 256 ? 32 : DT == 128 ? 64 : 128;
  static constexpr int RK = BK / TX;                // keys per thread: 4 * tx + (0..3), and 64 + the same (2 * tx + (0..1) at BK = 32)
  static constexpr int RD = DT / TX;                // output columns per thread
  static constexpr int VW = RD < 4 ? RD : 4;        // ... read as vectors of VW floats
  // sQ (DT, BQ) is D-major, sK and sV (BK, DT) and sP (BQ, BK) row-major;
  // K and V double-buffered.  229,376 B at DT = 64 and 128, 204,800 B at 256.
  static constexpr int NC = BK * DT / 4 / THREADS;   // 16-byte copies a thread a K (or V) tile
  static constexpr int Q_FLOATS = DT * BQ;
  static constexpr int KV_FLOATS = DT * BK;
  static constexpr size_t SMEM = sizeof(float) * (static_cast<size_t>(Q_FLOATS) +
                                                  4 * static_cast<size_t>(KV_FLOATS) +
                                                  static_cast<size_t>(BQ) * BK);
};

// The D-major Q tile holds 4-float chunks of one d row, swizzled by d:
// chunk c of row d sits at chunk c ^ (d % 8).  A warp's 4-byte copies (4
// rows x 8 d) then write 32 banks, and its 16-byte reads at one d stay
// conflict free.
__device__ __forceinline__ int dmajor(int d, int row, int rows) {
  return d * rows + ((((row >> 2) ^ (d & 7)) << 2) | (row & 3));
}

// The K tile's 4-float chunk c of key row `key` sits at chunk c ^ (key/4 %
// 8): the 16 lanes that read one chunk of keys 4 tx + j hit 8 bank quads.
template <int DT>
__device__ __forceinline__ int kswz(int key, int chunk) {
  return key * DT + ((chunk ^ ((key >> 2) & 7)) << 2);
}

// One float from global to shared memory, asynchronously; `valid` false
// writes a zero and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// 16 bytes from global to shared memory (both 16-byte aligned), through L2
// only; `valid` false writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [r0, r0 + ROWS) of a (B, S, heads, D) tensor at head `hd` into a
// D-major tile (d < D only).  Each warp copies blocks of 4 rows x 8 d: 32
// bytes of each of 4 rows, one sector each.  Rows past S read as zeros.
template <int ROWS>
__device__ __forceinline__ void load_dmajor(float* dst, const float* src, int b, int r0, int S,
                                            int heads, int hd, int D, int tid) {
  const int blocks = ROWS / 4 * (D / 8);
  const int lane = tid & 31;
  for (int blk = tid >> 5; blk < blocks; blk += THREADS / 32) {
    const int row = (blk % (ROWS / 4)) * 4 + (lane >> 3);
    const int d = (blk / (ROWS / 4)) * 8 + (lane & 7);
    const int pos = r0 + row;
    const bool valid = pos < S;
    const float* g = src + (((static_cast<size_t>(b) * S + (valid ? pos : 0)) * heads + hd) * D + d);
    cp_async4(dst + dmajor(d, row, ROWS), g, valid);
  }
}

// Chunk e (16 bytes) of rows [r0, r0 + rows) of a (B, S, heads, D) tensor
// at head `hd` in a row-major (rows, DT) tile (a warp copies whole rows);
// SWZ: K's chunk swizzle.  Rows past S and columns from D on read as zeros.
template <int DT, bool SWZ>
__device__ __forceinline__ void copy_chunk(float* dst, const float* src, int b, int r0, int S,
                                           int heads, int hd, int D, int e) {
  constexpr int CHUNKS = DT / 4;
  const int row = e / CHUNKS, c = e % CHUNKS;
  const int pos = r0 + row;
  const bool valid = pos < S && 4 * c < D;
  const float* g = src + (((static_cast<size_t>(b) * S + (valid ? pos : 0)) * heads + hd) * D +
                          (valid ? 4 * c : 0));
  cp_async16(dst + (SWZ ? kswz<DT>(row, c) : row * DT + 4 * c), g, valid);
}

// Copy i of a thread's 2 * NC for the K/V tile of keys [k0, k0 + BK): the
// first NC are K's, the rest V's.
template <int DT>
__device__ __forceinline__ void copy_kv(int i, float* sk, float* sv, const float* k,
                                        const float* v, int b, int k0, int Skv, int K, int kvh,
                                        int D, int tid) {
  constexpr int NC = Tile<DT>::BK * DT / 4 / THREADS;
  const int e = tid + THREADS * (i % NC);
  if (i < NC) copy_chunk<DT, true>(sk, k, b, k0, Skv, K, kvh, D, e);
  else copy_chunk<DT, false>(sv, v, b, k0, Skv, K, kvh, D, e);
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

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  }
}

// Thread (ty, tx) owns query rows row_of(i), two 128-bit reads of a d row
// of sQ, and of each key tile keys key_of(j).  Its output columns are
// col_of(c), VW at a time.
__device__ __forceinline__ int row_of(int ty, int i) { return (i >> 2) * 64 + ty * 4 + (i & 3); }
template <int RK>
__device__ __forceinline__ int key_of(int tx, int j) {
  return RK < 4 ? tx * RK + j : (j >> 2) * 64 + tx * 4 + (j & 3);
}
template <int VW>
__device__ __forceinline__ int col_of(int tx, int c) { return (c / VW) * (TX * VW) + tx * VW + c % VW; }

template <int DT>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int B, int Sq,
                       int Skv, int H, int K, int D, int causal, float scale_log2) {
  using T = Tile<DT>;
  constexpr int BQ = T::BQ, RQ = T::RQ, BK = T::BK, RK = T::RK, RD = T::RD, VW = T::VW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);   // (DT, BQ), D-major
  float* sK = sQ + T::Q_FLOATS;                    // 2 x (BK, DT), chunks swizzled
  float* sV = sK + 2 * T::KV_FLOATS;               // 2 x (BK, DT)
  float* sP = sV + 2 * T::KV_FLOATS;               // (BQ, BK): P's 4-float chunks swizzled by ty

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  // one block per query tile of one (batch, head); blocks are numbered head
  // fastest, then batch, then query tile from the last: the heaviest causal
  // tiles start first
  const int n_qt = (Sq + BQ - 1) / BQ;
  int u = blockIdx.x;
  const int h = u % H;
  u /= H;
  const int b = u % B;
  const int q0 = (n_qt - 1 - u / B) * BQ;
  const int kvh = h / (H / K);

  // causal: key tiles starting past the tile's last query row are skipped
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_dmajor<BQ>(sQ, q, b, q0, Sq, H, h, D, tid);
#pragma unroll
  for (int i = 0; i < 2 * T::NC; ++i) copy_kv<DT>(i, sK, sV, k, v, b, 0, Skv, K, kvh, D, tid);
  cp_async_commit();

  float m_run[RQ], l_run[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;              // this thread's keys only, summed over the row at the end
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const float* kt = sK + (t & 1) * T::KV_FLOATS;
    const float* vt = sV + (t & 1) * T::KV_FLOATS;
    cp_async_wait_all();
    __syncthreads();             // tile t is in; every read of tile t - 1 is done
    if (t + 1 < n_tiles) {       // tile t + 1 is copied while tile t is multiplied
#pragma unroll
      for (int i = 0; i < 2 * T::NC; ++i)
        copy_kv<DT>(i, sK + ((t + 1) & 1) * T::KV_FLOATS, sV + ((t + 1) & 1) * T::KV_FLOATS, k,
                    v, b, k0 + BK, Skv, K, kvh, D, tid);
    }
    cp_async_commit();

    // S = Q . K^T: per 4 d, one 128-bit read of K per key and two of Q per
    // d for 32 * RK FMAs; d ascending
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += 8) {
#pragma unroll
      for (int d4 = 0; d4 < 8; d4 += 4) {
        float kv[RK][4];
#pragma unroll
        for (int j = 0; j < RK; ++j) load_vec(kv[j], kt + kswz<DT>(key_of<RK>(tx, j), (d0 + d4) >> 2));
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) {
          const int d = d0 + d4 + dd;
          float qv[RQ];
#pragma unroll
          for (int i = 0; i < RQ; i += 4) {
            float x[4];
            load_vec(x, sQ + d * BQ + (((i / 4 * 16 + ty) ^ (d4 + dd)) << 2));
#pragma unroll
            for (int e = 0; e < 4; ++e) qv[i + e] = x[e];
          }
#pragma unroll
          for (int i = 0; i < RQ; ++i)
#pragma unroll
            for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j][dd], s[i][j]);
        }
      }
    }

    // online softmax: the mask only on tiles that cross the diagonal or the
    // end of the keys; p = exp2(s * c - m * c), c = scale * log2(e)
    const bool masked = k0 + BK > Skv || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = row_of(ty, i);
      if (masked) {
        const int qpos = q0 + row;
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          const int kpos = k0 + key_of<RK>(tx, j);
          if (kpos >= Skv || (causal && kpos > qpos)) s[i][j] = NEG_INF;
        }
      }
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m_run[i], group_max(mx));
      const float alpha = exp2f(__fmul_rn(__fsub_rn(m_run[i], m_new), scale_log2));
      const float neg = __fmul_rn(-m_new, scale_log2);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        s[i][j] = exp2f(fmaf(s[i][j], scale_log2, neg));
        psum = __fadd_rn(psum, s[i][j]);
      }
      l_run[i] = __fadd_rn(__fmul_rn(alpha, l_run[i]), psum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
      // P's row, 4 keys a 128-bit store (2 a 64-bit store at BK = 32),
      // chunks swizzled by ty so that the two row groups of a warp read
      // different banks below
      if constexpr (RK < 4) {
        *reinterpret_cast<float2*>(sP + row * BK + (((tx >> 1) ^ (ty & 1)) << 2) + 2 * (tx & 1)) =
            make_float2(s[i][0], s[i][1]);
      } else {
#pragma unroll
        for (int j = 0; j < RK; j += 4)
          *reinterpret_cast<float4*>(sP + row * BK + (((j / 4 * 16 + tx) ^ (ty & 1)) << 2)) =
              make_float4(s[i][j], s[i][j + 1], s[i][j + 2], s[i][j + 3]);
      }
    }
    __syncwarp();                // P's rows: written and read by the same 16 lanes

    // O += P . V: per 4 keys, one 128-bit read of P per row and RD/VW reads
    // of V per key for 32 * RD FMAs
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float p[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        load_vec(p[i], sP + row_of(ty, i) * BK + (((kk >> 2) ^ (ty & 1)) << 2));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vv[RD];
#pragma unroll
        for (int c = 0; c < RD; c += VW) {
          float x[VW];
          load_vec(x, vt + (kk + e) * DT + col_of<VW>(tx, c));
#pragma unroll
          for (int w = 0; w < VW; ++w) vv[c + w] = x[w];
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int c = 0; c < RD; ++c) acc[i][c] = fmaf(p[i][e], vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const float l = fmaxf(group_sum(l_run[i]), 1e-30f);
    const int qpos = q0 + row_of(ty, i);
    if (qpos >= Sq) continue;
    float* orow = o + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      const int col = col_of<VW>(tx, c);
      if (col < D) orow[col] = __fdiv_rn(acc[i][c], l);
    }
  }
}

template <int DT>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
                 int Sq, int Skv, int D, int causal, float scale, cudaStream_t stream) {
  const size_t smem = Tile<DT>::SMEM;
  constexpr int BQ = Tile<DT>::BQ;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<DT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sq + BQ - 1) / BQ) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float log2e = 1.4426950408889634f;
  flash_attention_kernel<DT><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), B, Sq, Skv, H, K, D, causal, scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_dim(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
               int Sq, int Skv, int D, int causal, float scale, cudaStream_t stream) {
  if (D <= 32) return launch_typed<32>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, stream);
  if (D <= 64) return launch_typed<64>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, stream);
  if (D <= 128) return launch_typed<128>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, stream);
  return launch_typed<256>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, stream);
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// bfloat16 and float16: TMA-fed tiles, wgmma, warp-specialised
// ---------------------------------------------------------------------------
namespace tensor_core {

constexpr int STAGES = 2;          // K/V ring depth (a third stage gains nothing at D = 64)

template <int DT>
struct Tile {
  // DT: the tile's head width (32, 64, 128 or 256); a head dim D below it
  // arrives zero-padded (the tensor map's out-of-bounds fill).  Consumer
  // warpgroups of 64 query rows each, as registers allow: at DT = 128 the
  // O accumulator takes 64 registers a thread, at DT = 256 128
  static constexpr int CONSUMERS = DT >= 128 ? 2 : 3;
  // key rows per tile, and Q slots: at DT = 256 a 128-row K or V tile
  // would take 64 KB, so 64-row tiles and one Q slot (64 KB + 2 stages x
  // 2 x 32 KB of the 227 KB)
  static constexpr int BK = DT == 256 ? 64 : 128;
  static constexpr int Q_SLOTS = DT == 256 ? 1 : 2;
  static constexpr int BQ = 64 * CONSUMERS;            // query rows per block
  static constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup (last)
  // setmaxnreg: the producer gives its registers to the consumers, so that
  // all of the SM's 65,536 go to one block
  static constexpr int PRODUCER_REGS = CONSUMERS == 2 ? 40 : 32;
  static constexpr int CONSUMER_REGS = CONSUMERS == 2 ? 232 : 160;
  static constexpr int PD = DT < 64 ? DT : 64;           // columns of one TMA box / swizzle panel
  static constexpr int PANELS = DT / PD;
  static constexpr int ROW = PD * 2;                   // bytes of a panel row: the swizzle span
  static constexpr int LAYOUT = PD == 64 ? 1 : 2;      // descriptor layout: 1 = 128 B, 2 = 64 B swizzle
  static constexpr int Q_PANEL = BQ * ROW;
  static constexpr int KV_PANEL = BK * ROW;
  static constexpr int Q_BYTES = BQ * DT * 2;
  static constexpr int KV_BYTES = BK * DT * 2;         // one K or one V tile
  // q_full[], q_free[] (a Q slot each), k_full[], v_full[], k_free[], v_free[]
  static constexpr int BARRIERS = 2 * Q_SLOTS + 4 * STAGES;
  static constexpr size_t SMEM = 1024 + Q_SLOTS * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout.  Tiles are 1024-byte aligned,
// so the base offset field stays 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operands in
// registers across the asynchronous window (fence, issue, wait).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j]) :: "memory");
}

// The wgmma wrappers, for bf16 or (F16) f16 operands with f32 sums:
// scale-d (accumulate into D or overwrite it) is a predicate operand, set
// from a register.
#define FA_OUT16(d) "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
    "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),    \
    "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define FA_OUT32(d) FA_OUT16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),          \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), \
    "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FA_OUT64(d) FA_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),          \
    "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), \
    "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), \
    "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define FA_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define FA_R32 FA_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define FA_R64 FA_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, " \
    "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
// D (64 x N) (+)= A (64 x 16, smem) . B (N x 16, smem, K-major)^T
#define FA_SS(N, TY, R, P, A, B)                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                                \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" R "}, %" #A    \
  ", %" #B ", p, 1, 1, 0, 0;\n}\n"
// D (64 x N, f32) += A (64 x 16, registers) . B (16 x N, smem, MN-major)
#define FA_RS(N, TY, R, P, A0, A1, A2, A3, B)                                     \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #P ", 0;\n"                                \
  "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" R "}, {%" #A0  \
  ", %" #A1 ", %" #A2 ", %" #A3 "}, %" #B ", p, 1, 1, 1;\n}\n"

template <bool F16>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  if constexpr (F16)
    asm volatile(FA_SS(128, "f16", FA_R64, 66, 64, 65)
                 : FA_OUT64(d) : "l"(da), "l"(db), "r"(accumulate));
  else
    asm volatile(FA_SS(128, "bf16", FA_R64, 66, 64, 65)
                 : FA_OUT64(d) : "l"(da), "l"(db), "r"(accumulate));
}

template <bool F16>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  if constexpr (F16)
    asm volatile(FA_SS(64, "f16", FA_R32, 34, 32, 33)
                 : FA_OUT32(d) : "l"(da), "l"(db), "r"(accumulate));
  else
    asm volatile(FA_SS(64, "bf16", FA_R32, 34, 32, 33)
                 : FA_OUT32(d) : "l"(da), "l"(db), "r"(accumulate));
}

template <bool F16>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (F16)
    asm volatile(FA_RS(64, "f16", FA_R32, 37, 32, 33, 34, 35, 36)
                 : FA_OUT32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(FA_RS(64, "bf16", FA_R32, 37, 32, 33, 34, 35, 36)
                 : FA_OUT32(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <bool F16>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t db) {
  if constexpr (F16)
    asm volatile(FA_RS(32, "f16", FA_R16, 21, 16, 17, 18, 19, 20)
                 : FA_OUT16(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(FA_RS(32, "bf16", FA_R16, 21, 16, 17, 18, 19, 20)
                 : FA_OUT16(d) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P . V for one V tile at `v`: BK/16 steps of k16 (V rows 16kk ...
// 16kk + 15), one wgmma per 64-column panel of O.
template <int DT, bool F16>
__device__ __forceinline__ void issue_pv(float (&acc)[Tile<DT>::PANELS][Tile<DT>::PD / 2],
                                         const uint32_t (&pa)[Tile<DT>::BK / 16][4], uint32_t v) {
  using T = Tile<DT>;
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk) {
#pragma unroll
    for (int p = 0; p < T::PANELS; ++p) {
      const uint64_t db = smem_desc(v + p * T::KV_PANEL + kk * 16 * T::ROW, T::KV_PANEL,
                                    8 * T::ROW, T::LAYOUT);
      if constexpr (T::PD == 64) wgmma_rs_n64<F16>(acc[p], pa[kk], db);
      else wgmma_rs_n32<F16>(acc[p], pa[kk], db);
    }
  }
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to the operands' 16-bit type, as one register.
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (F16) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// S = Q . K^T for one K tile at `k` and this warpgroup's 64 Q rows at `q`:
// DT/16 steps of k16, each inside one 64-column panel (columns from D on
// are zeros; skipping their steps at run time serialises the wgmmas).
template <int DT, bool F16>
__device__ __forceinline__ void issue_s(float (&sc)[Tile<DT>::BK / 2], uint32_t q, uint32_t k) {
  using T = Tile<DT>;
#pragma unroll
  for (int kk = 0; kk < DT / 16; ++kk) {
    const int p = kk * 16 / T::PD;
    const uint32_t off = (kk * 16 % T::PD) * 2;
    const uint64_t da = smem_desc(q + p * T::Q_PANEL + off, 16, 8 * T::ROW, T::LAYOUT);
    const uint64_t db = smem_desc(k + p * T::KV_PANEL + off, 16, 8 * T::ROW, T::LAYOUT);
    if constexpr (T::BK == 128) wgmma_ss_n128<F16>(sc, da, db, kk > 0);
    else wgmma_ss_n64<F16>(sc, da, db, kk > 0);
  }
  wgmma_commit();
}

// The running max and sum of this thread's two rows.
struct RowState {
  float m[2];
  float l[2];                 // this thread's columns only
};

// Online-softmax update of one S tile in place: mask (tiles that cross the
// diagonal or the end of the keys only), the rows' new maxima over the
// quad of lanes that shares a row, p = exp2(s*c - m*c) with c =
// scale*log2(e), the rows' partial sums.  Returns each row's alpha.
// Element i of the fragment: row (i >> 1) & 1, column 8 * (i >> 2) + col0 + (i & 1).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], RowState& st, float (&alpha)[2],
                                             bool masked, int k0, int Skv, int causal,
                                             const int (&qpos)[2], int col0, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kpos = k0 + 8 * (i >> 2) + col0 + (i & 1);
      if (kpos >= Skv || (causal && kpos > qpos[(i >> 1) & 1])) sc[i] = NEG_INF;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (((i >> 1) & 1) == r) mx = fmaxf(mx, sc[i]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(st.m[r], mx);
    alpha[r] = ex2((st.m[r] - m_new) * scale_log2);
    st.m[r] = m_new;
    const float neg = -m_new * scale_log2;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if (((i >> 1) & 1) == r) {
        sc[i] = ex2(fmaf(sc[i], scale_log2, neg));
        sum += sc[i];
      }
    }
    st.l[r] = st.l[r] * alpha[r] + sum;
  }
}

// O *= alpha by rows; P in the operands' type from the softmax's f32 p.
// K-step kk of P.V takes S's columns 16kk ... 16kk + 15, which the
// accumulator layout already holds in register-A order.
template <int DT, bool F16>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[Tile<DT>::PANELS][Tile<DT>::PD / 2],
                                                 uint32_t (&pa)[Tile<DT>::BK / 16][4],
                                                 const float (&sc)[Tile<DT>::BK / 2],
                                                 const float (&alpha)[2]) {
  constexpr int BK = Tile<DT>::BK;
#pragma unroll
  for (int p = 0; p < Tile<DT>::PANELS; ++p)
#pragma unroll
    for (int i = 0; i < Tile<DT>::PD / 2; ++i) acc[p][i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = pack2<F16>(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// One unit of work: a query tile of one (batch, head).  Units are numbered
// head fastest, then batch, then query tile from the last (the heaviest
// under the causal mask) to the first, so every block takes the heaviest
// units left first.
struct Work {
  int h, b, q0, kvh, n_tiles;
};

template <int DT>
__device__ __forceinline__ Work work_unit(int u, int B, int Sq, int Skv, int H, int K,
                                          int causal) {
  constexpr int BQ = Tile<DT>::BQ, BK = Tile<DT>::BK;
  const int n_qt = (Sq + BQ - 1) / BQ;
  Work w;
  w.h = u % H;
  u /= H;
  w.b = u % B;
  w.q0 = (n_qt - 1 - u / B) * BQ;
  w.kvh = w.h / (H / K);
  // causal: key tiles starting past the unit's last query row are skipped
  const int kv_end = causal ? min(Skv, w.q0 + BQ) : Skv;
  w.n_tiles = (kv_end + BK - 1) / BK;
  return w;
}

// Persistent: in round n a block takes unit n * gridDim.x + blockIdx.x, in
// odd rounds counted from the other end (a snake, which evens out the
// causal units' weights across blocks).  The K/V ring and its barrier
// phases run on across units; Q has two slots (one at DT = 256), so the
// next unit's Q and first K/V tiles load while this unit finishes.
__device__ __forceinline__ int unit_of(int n) {
  return n * gridDim.x + ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// E: the operands' and the output's type, __nv_bfloat16 or __half (F16).
template <int DT, bool F16>
__global__ void __launch_bounds__(Tile<DT>::THREADS, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      void* __restrict__ o_raw, int B, int Sq, int Skv, int H,
                      int K, int D, int causal, float scale_log2, int n_units) {
  using T = Tile<DT>;
  using E = typename std::conditional<F16, __half, __nv_bfloat16>::type;
  using E2 = typename std::conditional<F16, __half2, __nv_bfloat162>::type;
  constexpr int PD = T::PD, BK = T::BK, QS = T::Q_SLOTS;
  constexpr int CONSUMERS = T::CONSUMERS;
  E* __restrict__ o = static_cast<E*>(o_raw);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;   // swizzle atoms need 1024 B
  const uint32_t sK = sQ + QS * T::Q_BYTES;                   // QS Q slots, then STAGES K tiles
  const uint32_t sV = sK + STAGES * T::KV_BYTES;              // STAGES V tiles
  const uint32_t q_full = sV + STAGES * T::KV_BYTES;          // + 8 * slot
  const uint32_t q_free = q_full + 8 * QS;                    // consumers are done with a Q slot
  const uint32_t k_full = q_free + 8 * QS;                    // + 8 * stage
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_free = v_full + 8 * STAGES;                // consumers are done with a K stage
  const uint32_t v_free = k_free + 8 * STAGES;                // ... with a V stage

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < QS; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_free + 8 * i, CONSUMERS * 128);
    }
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_free + 8 * s, CONSUMERS * 128);
      mbar_init(v_free + 8 * s, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == CONSUMERS) {
    // producer warpgroup: one thread keeps Q's slots and the K/V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(T::PRODUCER_REGS) : "memory");
    if (tid == CONSUMERS * 128) {
      int it = 0;                                  // K/V tiles loaded so far
      int n = 0;                                   // units started so far
      for (; n * gridDim.x < n_units; ++n) {
        const int u = unit_of(n);
        if (u >= n_units) break;                   // the last round is partial
        const Work w = work_unit<DT>(u, B, Sq, Skv, H, K, causal);
        const int qs = n % QS;
        if (n >= QS) mbar_wait(q_free + 8 * qs, ((n / QS) - 1) & 1);
        mbar_expect_tx(q_full + 8 * qs, T::Q_BYTES);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p)
          tma_load(sQ + qs * T::Q_BYTES + p * T::Q_PANEL, &tm_q, q_full + 8 * qs, p * PD, w.h,
                   w.q0, w.b);
        for (int t = 0; t < w.n_tiles; ++t, ++it) {
          const int s = it % STAGES;
          const uint32_t parity = ((it / STAGES) - 1) & 1;   // the stage's previous use
          const int k0 = t * BK;
          if (it >= STAGES) mbar_wait(k_free + 8 * s, parity);
          mbar_expect_tx(k_full + 8 * s, T::KV_BYTES);
#pragma unroll
          for (int p = 0; p < T::PANELS; ++p)
            tma_load(sK + s * T::KV_BYTES + p * T::KV_PANEL, &tm_k, k_full + 8 * s, p * PD,
                     w.kvh, k0, w.b);
          if (it >= STAGES) mbar_wait(v_free + 8 * s, parity);
          mbar_expect_tx(v_full + 8 * s, T::KV_BYTES);
#pragma unroll
          for (int p = 0; p < T::PANELS; ++p)
            tma_load(sV + s * T::KV_BYTES + p * T::KV_PANEL, &tm_v, v_full + 8 * s, p * PD,
                     w.kvh, k0, w.b);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64*wg ... + 63 of each unit
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(T::CONSUMER_REGS) : "memory");
    const int lane = tid % 32;
    const int row = 16 * ((tid % 128) / 32) + lane / 4;   // this thread's rows: row and row + 8
    const int col0 = 2 * (lane % 4);                      // accumulator column of element 0
    int it = 0;                                           // K/V tiles consumed so far
    int n = 0;
    for (; n * gridDim.x < n_units; ++n) {
      const int u = unit_of(n);
      if (u >= n_units) break;
      const Work w = work_unit<DT>(u, B, Sq, Skv, H, K, causal);
      const int qs = n % QS;
      const int qrow0 = w.q0 + 64 * wg;
      const int qpos[2] = {qrow0 + row, qrow0 + row + 8};
      const uint32_t q_wg = sQ + qs * T::Q_BYTES + wg * 64 * T::ROW;   // this warpgroup's Q rows
      // tiles that cross the diagonal or the end of the keys take the mask
      const int mask_from = min(Skv - BK, causal ? qrow0 - BK + 1 : Skv);   // k0 > mask_from
      // causal: the unit's key tiles wholly above this warpgroup's last row
      // are not computed (the ring still passes through them)
      const int n_mine = causal ? min(w.n_tiles, (min(Skv, qrow0 + 64) + BK - 1) / BK) : w.n_tiles;

      float acc[T::PANELS][PD / 2];
#pragma unroll
      for (int p = 0; p < T::PANELS; ++p)
#pragma unroll
        for (int i = 0; i < PD / 2; ++i) acc[p][i] = 0.f;
      uint32_t pa[BK / 16][4];          // P in E, the A operand of P.V
      RowState st = {{NEG_INF, NEG_INF}, {0.f, 0.f}};
      float sc[BK / 2];
      float alpha[2];

      // tile 0: S, softmax, P
      mbar_wait(q_full + 8 * qs, (n / QS) & 1);
      {
        const int s = it % STAGES;
        mbar_wait(k_full + 8 * s, (it / STAGES) & 1);
        wgmma_fence();
        issue_s<DT, F16>(sc, q_wg, sK + s * T::KV_BYTES);
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(k_free + 8 * s);
        softmax_tile<BK>(sc, st, alpha, 0 > mask_from, 0, Skv, causal, qpos, col0, scale_log2);
        rescale_and_pack<DT, F16>(acc, pa, sc, alpha);
      }

      // tile t >= 1: issue S = Q . K_t^T and then P.V of tile t - 1 in one
      // wgmma window; tile t's softmax runs while that P.V is on the tensor
      // cores, and O is rescaled and P rewritten once it is done
      for (int t = 1; t < n_mine; ++t) {
        const int s = (it + t) % STAGES;
        const int sp = (it + t - 1) % STAGES;
        mbar_wait(k_full + 8 * s, ((it + t) / STAGES) & 1);
        mbar_wait(v_full + 8 * sp, ((it + t - 1) / STAGES) & 1);
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p) fence_regs(acc[p]);
        fence_regs(pa);
        wgmma_fence();
        issue_s<DT, F16>(sc, q_wg, sK + s * T::KV_BYTES);
        issue_pv<DT, F16>(acc, pa, sV + sp * T::KV_BYTES);
        wgmma_wait<1>();                  // S is done; P.V may still run
        fence_regs(sc);
        mbar_arrive(k_free + 8 * s);
        softmax_tile<BK>(sc, st, alpha, t * BK > mask_from, t * BK, Skv, causal, qpos, col0,
                     scale_log2);
        wgmma_wait<0>();                  // the previous tile's P.V is done
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p) fence_regs(acc[p]);
        fence_regs(pa);
        mbar_arrive(v_free + 8 * sp);
        rescale_and_pack<DT, F16>(acc, pa, sc, alpha);
      }
      mbar_arrive(q_free + 8 * qs);       // every S of this unit is done

      // the last computed tile's P.V
      const int last = (it + n_mine - 1) % STAGES;
      mbar_wait(v_full + 8 * last, ((it + n_mine - 1) / STAGES) & 1);
#pragma unroll
      for (int p = 0; p < T::PANELS; ++p) fence_regs(acc[p]);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<DT, F16>(acc, pa, sV + last * T::KV_BYTES);
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < T::PANELS; ++p) fence_regs(acc[p]);
      mbar_arrive(v_free + 8 * last);
      // ... and the tiles it does not compute: released once loaded, in order
      for (int t = n_mine; t < w.n_tiles; ++t) {
        const int s = (it + t) % STAGES;
        const uint32_t parity = ((it + t) / STAGES) & 1;
        mbar_wait(k_full + 8 * s, parity);
        mbar_arrive(k_free + 8 * s);
        mbar_wait(v_full + 8 * s, parity);
        mbar_arrive(v_free + 8 * s);
      }
      it += w.n_tiles;

      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float l = st.l[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        inv[r] = 1.f / fmaxf(l, 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (qpos[r] >= Sq) continue;
        E* orow = o + ((static_cast<size_t>(w.b) * Sq + qpos[r]) * H + w.h) * D;
#pragma unroll
        for (int p = 0; p < T::PANELS; ++p)
#pragma unroll
          for (int j = 0; j < PD / 8; ++j) {
            if (p * 64 + 8 * j >= D) continue;          // the tile's zero-padded columns
            const float* e = &acc[p][4 * j + 2 * r];
            const uint32_t pair = pack2<F16>(e[0] * inv[r], e[1] * inv[r]);
            *reinterpret_cast<E2*>(orow + p * 64 + 8 * j + col0) =
                *reinterpret_cast<const E2*>(&pair);
          }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through cudaGetDriverEntryPoint
// (so the library links no libcuda).
int encode_fn(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (status != cudaDriverEntryPointSuccess || p == nullptr)
      return kErrEntryPoint + static_cast<int>(status);
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// A (B, S, heads, D) bf16 or (F16) f16 tensor as a 4-D map (dims D, heads,
// S, B), box (PD, 1, rows, 1), swizzled as the wgmma descriptors expect;
// rows past S and columns from D up to the tile's DT read as zeros.  D * 2
// bytes, the row stride, must be a multiple of 16: D % 8 == 0.
template <int DT, bool F16>
int encode_bshd(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int S,
                int heads, int D, int rows) {
  using T = Tile<DT>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(S) * heads * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::PD), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            T::PD == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + static_cast<int>(r);
}

template <int DT, bool F16>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
                 int Sq, int Skv, int D, int causal, float scale, cudaStream_t stream) {
  EncodeTiled encode;
  int err = encode_fn(&encode);
  if (err) return err;
  CUtensorMap tm_q, tm_k, tm_v;
  constexpr int BK = Tile<DT>::BK;
  if ((err = encode_bshd<DT, F16>(encode, &tm_q, q, B, Sq, H, D, Tile<DT>::BQ))) return err;
  if ((err = encode_bshd<DT, F16>(encode, &tm_k, k, B, Skv, K, D, BK))) return err;
  if ((err = encode_bshd<DT, F16>(encode, &tm_v, v, B, Skv, K, D, BK))) return err;
  const size_t smem = Tile<DT>::SMEM;
  cudaError_t cerr = cudaFuncSetAttribute(flash_attention_wgmma<DT, F16>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  int device, sms;
  if ((cerr = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int n_units = (Sq + Tile<DT>::BQ - 1) / Tile<DT>::BQ * B * H;
  const float log2e = 1.4426950408889634f;
  flash_attention_wgmma<DT, F16><<<min(n_units, sms), Tile<DT>::THREADS, smem, stream>>>(
      tm_q, tm_k, tm_v, o, B, Sq, Skv, H, K, D, causal, scale * log2e, n_units);
  return static_cast<int>(cudaGetLastError());
}

template <bool F16>
int launch_dim(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
               int Sq, int Skv, int D, int causal, float scale, cudaStream_t stream) {
  if (D <= 32) return launch_typed<32, F16>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, stream);
  if (D <= 64) return launch_typed<64, F16>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, stream);
  if (D <= 128) return launch_typed<128, F16>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, stream);
  return launch_typed<256, F16>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, stream);
}

}  // namespace tensor_core

// ---------------------------------------------------------------------------
// D > 256, any dtype: the panel kernel (CUDA cores)
// ---------------------------------------------------------------------------
namespace panel {

// A block of 256 threads owns 64 query rows of one (batch, head) and one
// window of 64 output columns; thread (ty, tx) owns rows 4 ty + (0..3),
// keys 4 tx + (0..3) of each 64-key tile and output columns 4 tx + (0..3)
// of the window.  S = Q . K^T is summed over D in panels of 64 columns
// that stream through shared memory (widened to f32; q and k are read
// again for every key tile), so no tile grows with D; each window recomputes
// the same S, in the same order, and so the same softmax.  The softmax is
// the tiled kernels' (exp2 with scale*log2(e) folded in, -1e30 under the
// mask, tiles wholly above the diagonal skipped); P is rounded to the
// operands' type before P.V, as the tensor-core kernel and the plain
// version round it.  No atomics.  Simple, not fast: S costs D/64 windows
// over.
constexpr int THREADS = 256;
constexpr int TX = 16;
constexpr int BQ = 64;            // query rows a block
constexpr int BK = 64;            // keys a tile
constexpr int DP = 64;            // head-dim columns a panel, and output columns a window
constexpr int LD = DP + 1;        // shared-memory row stride (floats): no bank conflicts down a column
constexpr size_t SMEM = sizeof(float) * 4 * BQ * LD;   // sQ, sK, sP, sV: 66,560 B

template <typename E> __device__ __forceinline__ float widen(E x);
template <> __device__ __forceinline__ float widen<float>(float x) { return x; }
template <> __device__ __forceinline__ float widen<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float widen<__half>(__half x) { return __half2float(x); }

template <typename E> __device__ __forceinline__ E narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half narrow<__half>(float x) { return __float2half_rn(x); }

// Rows [r0, r0 + 64) x columns [c0, c0 + 64) of a (B, S, heads, D) tensor at
// head `hd`, widened to f32, into a (64, LD) tile; past S or D, zeros.
template <typename E>
__device__ __forceinline__ void load_tile(float* dst, const E* __restrict__ src, int b, int r0,
                                          int S, int heads, int hd, int D, int c0, int tid) {
  for (int e = tid; e < 64 * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    const int pos = r0 + r, col = c0 + c;
    float x = 0.f;
    if (pos < S && col < D)
      x = widen<E>(src[((static_cast<size_t>(b) * S + pos) * heads + hd) * D + col]);
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
flash_attention_panels(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, E* __restrict__ o, int B, int Sq, int Skv,
                       int H, int K, int D, int causal, float scale_log2) {
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sP = sK + BK * LD;
  float* sV = sP + BQ * LD;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  // blocks: window fastest, then head, batch, and query tile from the last
  const int n_win = (D + DP - 1) / DP;
  const int n_qt = (Sq + BQ - 1) / BQ;
  int u = blockIdx.x;
  const int win = u % n_win;
  u /= n_win;
  const int h = u % H;
  u /= H;
  const int b = u % B;
  const int q0 = (n_qt - 1 - u / B) * BQ;
  const int kvh = h / (H / K);
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  float m_run[4], l_run[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DP) {       // S over D's panels, d ascending
      __syncthreads();                         // the last panel's (or tile's) reads are done
      load_tile<E>(sQ, q, b, q0, Sq, H, h, D, c0, tid);
      load_tile<E>(sK, k, b, k0, Skv, K, kvh, D, c0, tid);
      __syncthreads();
      for (int d = 0; d < DP; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = sQ[(4 * ty + i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = sK[(4 * tx + j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }
    load_tile<E>(sV, v, b, k0, Skv, K, kvh, D, win * DP, tid);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + 4 * tx + j;
        if (kpos >= Skv || (causal && kpos > qpos)) s[i][j] = NEG_INF;
      }
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) mx = fmaxf(mx, s[i][j]);
      const float m_new = fmaxf(m_run[i], group_max(mx));
      const float alpha = exp2f(__fmul_rn(__fsub_rn(m_run[i], m_new), scale_log2));
      const float neg = __fmul_rn(-m_new, scale_log2);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(fmaf(s[i][j], scale_log2, neg));
        psum = __fadd_rn(psum, p);
        sP[(4 * ty + i) * LD + 4 * tx + j] = widen<E>(narrow<E>(p));
      }
      l_run[i] = __fadd_rn(__fmul_rn(alpha, l_run[i]), psum);
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = __fmul_rn(acc[i][c], alpha);
    }
    __syncthreads();                           // P and V are in
    for (int kk = 0; kk < BK; ++kk) {          // O += P . V, keys ascending
      float vv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) vv[c] = sV[kk * LD + 4 * tx + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(4 * ty + i) * LD + kk];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = fmaxf(group_sum(l_run[i]), 1e-30f);
    const int qpos = q0 + 4 * ty + i;
    if (qpos >= Sq) continue;
    E* orow = o + ((static_cast<size_t>(b) * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = win * DP + 4 * tx + c;
      if (col < D) orow[col] = narrow<E>(__fdiv_rn(acc[i][c], l));
    }
  }
}

template <typename E>
int launch_typed(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
                 int Sq, int Skv, int D, int causal, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_panels<E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>((Sq + BQ - 1) / BQ) * B * H *
                           ((D + DP - 1) / DP);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float log2e = 1.4426950408889634f;
  flash_attention_panels<E><<<static_cast<unsigned>(blocks), THREADS, SMEM, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
      static_cast<E*>(o), B, Sq, Skv, H, K, D, causal, scale * log2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace panel

}  // namespace

// Plain C entry point (loaded with ctypes).  Device pointers on card
// `device`, contiguous, 16-byte aligned; dtype 0 = float32, 1 = bfloat16,
// 2 = float16; D % 8 == 0 (else cudaErrorInvalidValue).  A D <= 256 runs
// the tiled kernel of its dtype: the CUDA-core kernel for float32, the
// wgmma kernel for the 16-bit types; a larger D runs the panel kernel.
// Launches on `stream`, does not synchronise.
// Returns 0 on success, else a cudaError_t (below 1000), 1000 + the
// CUresult of a failed tensor-map encode, or 2000 + the status of a failed
// cudaGetDriverEntryPoint lookup.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype, int B,
                                      int H, int K, int Sq, int Skv, int D,
                                      int causal, float scale, int device,
                                      void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (B <= 0 || H <= 0 || K <= 0 || H % K != 0 || Sq <= 0 || Skv <= 0 || D <= 0 ||
      D % kTileStep != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > kMaxTileDim) {
    switch (dtype) {
      case kF32: return panel::launch_typed<float>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, st);
      case kBF16:
        return panel::launch_typed<__nv_bfloat16>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, st);
      case kF16: return panel::launch_typed<__half>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (dtype) {
    case kF32:
      return cuda_core::launch_dim(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, st);
    case kBF16:
      return tensor_core::launch_dim<false>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, st);
    case kF16:
      return tensor_core::launch_dim<true>(q, k, v, o, B, H, K, Sq, Skv, D, causal, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
