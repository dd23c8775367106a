// GEMM for sm_90a: C = A B on 128x128 block tiles, with split-K; each
// operand f32 or bf16 (amp), C f32 or bf16, the arithmetic f32 on the
// CUDA cores, but for bf16 x bf16 -> bf16 with A i-major and B k-major
// (#1's y = ctx W_out), which runs on tensor cores (gemm_tc, below).
//
// Shared by the fused-projection kernels: the backward pair (#2 + #3 in
// qkv_attention_bwd.cu: the q|k|v and dctx projections, dx and dW) and
// #1's output projection (qkv_attention.cu: y = ctx W_out); conv_bn.cu's
// #19 runs gemm_tile with a statistics epilogue of its own, and gemm.cu
// exports the GEMM alone.  256 threads, an 8x8 patch of each C tile per
// thread, operands staged k-major in shared memory and read as float4.
// Every element of C is summed in increasing k (split-K partials are added
// in slab order by sum_splits): no atomics, so two calls on the same
// inputs give the same bits.
//
// Bound: f32 FMA work on the CUDA cores (TF32 off): 64 FMAs for every 4
// float4 reads of shared memory.  The loads run one stage ahead of the
// math in a ring of two shared-memory stages: an operand whose staged
// dimension is contiguous comes in by 16-byte cp.async, an i-major one as
// float4 loads along k into registers, stored transposed after the
// stage's math.  Only tiles at the operands' edges (or not 16-byte
// aligned) check bounds, element by element.  The tile keeps 64
// accumulators and both operands' staging in the 128 registers two blocks
// an SM allow, with none to spare.  On an H100 every change to it measured
// slower at the pair's or #19's shapes: i-major operands staged as they lie
// by cp.async and read as float4 along k, a third ring stage, an XOR
// swizzle or a thread mapping that frees the transposed stores of their
// 2-way bank conflicts, float4 stores of C, persistent #19 blocks, and one
// block an SM with the registers that frees (PERF.md).  No TMA: later
// work.
//
// bf16 operands (amp): each operand's element type is its own template
// parameter (the backward pair multiplies its f32 dq|dk|dv scratch by bf16
// x or W).  A bf16 operand comes in through registers, 4 elements (8
// bytes) a load, and is converted to f32 as it is stored into the stage,
// so every shared-memory layout and read is the f32 tile's; C is
// accumulated in f32 and rounded to its type when stored.  The f32
// instantiations are the f32 tile unchanged.
//
// Summation depth (C13): a split product (the pair's dW sums, K = b * t)
// is cut into slabs of at most kMaxSlab = 1024 k, so no element of it is
// one running f32 sum over more than 1024 terms; unsplit products (the
// projections, dx, #19) sum their K <= 3hd in one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "dtype.cuh"
#include "mma.cuh"

namespace {

constexpr int GNT = 256;     // threads of a GEMM block
constexpr int GT = 128;      // rows and columns of a C tile
constexpr int GK = 16;       // reduction depth of one stage
constexpr int GS = GT + 4;   // row stride of the k-major shared tiles
constexpr int GSTAGE = GK * GS;  // floats of one operand's stage
//: floats of shared memory gemm_tile takes: two stages of both operands
constexpr int GEMM_SMEM = 4 * GSTAGE;
//: float4s a thread stages of one operand per stage
constexpr int G4 = GK * GT / 4 / GNT;
static_assert(G4 >= 1 && GK % 4 == 0, "a stage is whole float4s a thread");
constexpr int kMaxSlab = 1024;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One operand of gemm_tile on its way through shared memory.  Element (i0
// + ii, k0 + kk) of a stage lands at kk * GS + ii.  The operand is
// k-major when element (i, k) is src[k * ld + i], else i-major, src[i *
// ld + k].  Thread `tid`'s r-th quad of a stage is four consecutive
// elements in memory: i = 4 (f % (GT / 4)).. of k row f / (GT / 4) when
// k-major, k = 4 (f % (GK / 4)).. of i row f / (GK / 4) when i-major,
// with f = tid + r * GNT (consecutive threads on consecutive addresses).
// An f32 k-major operand is copied by cp.async; every other one is loaded
// into registers (`held`: a float4 of f32, the raw 8 bytes of bf16) and
// stored, converted to f32, after the stage's math.
template <bool KMAJOR, class T = float>
struct GemmStager {
  static constexpr int kPerRow = KMAJOR ? GT / 4 : GK / 4;
  static constexpr int kRows = GNT / kPerRow;  // rows one pass covers
  static constexpr bool kF32 = sizeof(T) == 4;
  //: the f32 k-major operand lands by cp.async, not through registers
  static constexpr bool kAsync = KMAJOR && kF32;
  using Held = typename std::conditional<kF32, float4, uint2>::type;

  const T* p;  // this thread's first element at the next stage
  int64_t row_step;  // elements from one pass's row to the next's
  int64_t k_step;    // elements from one stage to the next
  int ii, kk;        // where the first quad lands in a stage
  int n_i, k;        // rows of the operand; this thread's first k
  bool inside;       // the tile's rows all < n_i and the quads aligned
  Held held[G4];     // the stage loaded, not yet stored

  __device__ __forceinline__ GemmStager(const T* src, int ld, int i0,
                                        int n_i_, int k_begin) {
    const int f = threadIdx.x;
    const int row = f / kPerRow;
    const int col = (f % kPerRow) * 4;
    ii = KMAJOR ? col : row;
    kk = KMAJOR ? row : col;
    n_i = n_i_;
    k = k_begin + kk;
    p = KMAJOR ? src + (int64_t)k * ld + i0 + ii
               : src + (int64_t)(i0 + ii) * ld + k;
    row_step = (int64_t)kRows * ld;
    k_step = KMAJOR ? (int64_t)GK * ld : GK;
    inside = i0 + GT <= n_i && ld % 4 == 0 &&
             reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
    n_i -= i0;
  }

  // Element c of this thread's r-th quad at the current stage, 0 outside
  // [0, n_i) x [0, k_end): the checked path of edge tiles.
  __device__ __forceinline__ float at(int r, int c, int k_end) const {
    const int i = KMAJOR ? ii + c : ii + r * kRows;
    const int kc = KMAJOR ? k + r * kRows : k + c;
    return i < n_i && kc < k_end ? to_f32(p[r * row_step + c]) : 0.f;
  }

  __device__ __forceinline__ float4 at4(int r, int k_end) const {
    return make_float4(at(r, 0, k_end), at(r, 1, k_end), at(r, 2, k_end),
                       at(r, 3, k_end));
  }

  // f32 values of a held quad
  __device__ __forceinline__ static float4 unpack(const Held& h) {
    if constexpr (kF32) {
      return h;
    } else {
      return load4(reinterpret_cast<const T*>(&h));
    }
  }

  // Start the current stage's loads into `stage`: by cp.async (f32
  // k-major) or into registers.  `full`: no element is outside.
  __device__ __forceinline__ void load(float* stage, bool full, int k_end) {
#pragma unroll
    for (int r = 0; r < G4; ++r) {
      if constexpr (kAsync) {
        float* dst = stage + (kk + r * kRows) * GS + ii;
        if (full)
          cp_async16(dst, reinterpret_cast<const float*>(p + r * row_step));
        else
          *reinterpret_cast<float4*>(dst) = at4(r, k_end);
      } else if constexpr (kF32) {
        held[r] = full ? __ldg(reinterpret_cast<const float4*>(
                             p + r * row_step))
                       : at4(r, k_end);
      } else if (full) {
        held[r] = __ldg(reinterpret_cast<const uint2*>(p + r * row_step));
      } else {  // values of bf16 elements: packing them back is exact
        const float4 v = at4(r, k_end);
        store4(reinterpret_cast<T*>(&held[r]), v);
      }
    }
  }

  // Store the held stage into `stage` (i-major: transposed).
  __device__ __forceinline__ void store(float* stage) const {
    if constexpr (!kAsync) {
#pragma unroll
      for (int r = 0; r < G4; ++r) {
        const float4 v = unpack(held[r]);
        if (KMAJOR) {
          *reinterpret_cast<float4*>(stage + (kk + r * kRows) * GS + ii) =
              v;
        } else {
          float* dst = stage + kk * GS + ii + r * kRows;
          dst[0] = v.x;
          dst[GS] = v.y;
          dst[2 * GS] = v.z;
          dst[3 * GS] = v.w;
        }
      }
    }
  }

  __device__ __forceinline__ void next() {
    p += k_step;
    k += GK;
  }
};

// Row (col) of a C tile held in acc row i (col j) by thread row ty (col
// tx): {4ty.., 64 + 4ty..}.
__device__ __forceinline__ int gemm_tile_row(int i, int t) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + i - 4;
}

// acc = sum over k in [k_begin, k_end) of A(m0 + row, k) B(k, n0 + col)
// for this thread's 8x8 patch of the 128x128 C tile at (m0, n0), summed
// in increasing k; rows >= M and columns >= N read zeros.  A and B hold
// TA and TB elements (f32 or bf16), read as f32.  A(m, k) is
// a[k * lda + m] when A_KM, else a[m * lda + k]; B(k, n) is b[k * ldb + n]
// when B_KM, else b[n * ldb + k].  k_begin is a multiple of GK.  smem is
// GEMM_SMEM floats of 16-byte aligned shared memory, free again when this
// returns; every thread of the block calls this.
template <bool A_KM, bool B_KM, class TA = float, class TB = float>
__device__ __forceinline__ void gemm_tile(
    const TA* __restrict__ a, int lda, const TB* __restrict__ b,
    int ldb, int M, int N, int m0, int n0, int k_begin, int k_end,
    float* smem, float (&acc)[8][8]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int steps = (k_end - k_begin + GK - 1) / GK;
  if (steps <= 0) return;

  GemmStager<A_KM, TA> sa(a, lda, m0, M, k_begin);
  GemmStager<B_KM, TB> sb(b, ldb, n0, N, k_begin);
  // Stage s sits in ring slot s % 2: A at slot * 2 GSTAGE, B after it.
  // Only an edge tile, or the last stage of a K that is no multiple of
  // GK, takes the checked loads.
  const bool k_whole = (k_end - k_begin) % GK == 0;
  sa.load(smem, sa.inside && (steps > 1 || k_whole), k_end);
  sb.load(smem + GSTAGE, sb.inside && (steps > 1 || k_whole), k_end);
  cp_async_commit();
  sa.store(smem);
  sb.store(smem + GSTAGE);
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const float* a_s = smem + (s & 1) * 2 * GSTAGE;
    const float* b_s = a_s + GSTAGE;
    float* a_next = smem + ((s + 1) & 1) * 2 * GSTAGE;
    float* b_next = a_next + GSTAGE;
    const bool more = s + 1 < steps;
    if (more) {  // stage s + 1 into the slot stage s - 1 left
      const bool last_whole = s + 2 < steps || k_whole;
      sa.next();
      sb.next();
      sa.load(a_next, sa.inside && last_whole, k_end);
      sb.load(b_next, sb.inside && last_whole, k_end);
      cp_async_commit();
    }
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(a_s + kk * GS +
                                                         ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a_s + kk * GS + 64 +
                                                         ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + kk * GS +
                                                         tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + kk * GS + 64 +
                                                         tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
    }
    if (more) {
      sa.store(a_next);
      sb.store(b_next);
    }
    cp_async_wait_all();
    __syncthreads();  // stage s + 1 has landed; stage s is consumed
  }
}

// C[m, n] = sum_k A(m, k) B(k, n) over k in split blockIdx.z's slab
// [z * k_slab, (z + 1) * k_slab), written to c + z * split_stride as TC;
// A and B as gemm_tile reads them.
template <bool A_KM, bool B_KM, class TA = float, class TB = float,
          class TC = float>
__global__ void __launch_bounds__(GNT, 2)
gemm_kernel(const TA* __restrict__ a, int lda,
            const TB* __restrict__ b, int ldb, TC* c, int ldc,
            size_t split_stride, int M, int N, int K, int k_slab) {
  __shared__ __align__(16) float smem[GEMM_SMEM];
  const int n0 = blockIdx.x * GT;
  const int m0 = blockIdx.y * GT;
  const int k_begin = blockIdx.z * k_slab;
  const int k_end = min(K, k_begin + k_slab);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float acc[8][8];
  gemm_tile<A_KM, B_KM, TA, TB>(a, lda, b, ldb, M, N, m0, n0, k_begin,
                                k_end, smem, acc);

  c += blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + gemm_tile_row(i, ty);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + gemm_tile_row(j, tx);
      if (n < N) c[(size_t)m * ldc + n] = from_f32<TC>(acc[i][j]);
    }
  }
}

// c[m * ldc + n] = sum over s = 0, 1, ... of part[s][m][n], in that
// order, rounded to TC.
template <class TC = float>
__global__ void __launch_bounds__(GNT)
sum_splits(const float* __restrict__ part, int splits, int M, int N,
           TC* c, int ldc) {
  const size_t mn = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)GNT + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * GNT) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * mn + i];
    c[(i / N) * ldc + i % N] = from_f32<TC>(s);
  }
}

// One GEMM operand of T elements: element (i, k) at p[k * ld + i] when
// kmajor, else at p[i * ld + k].
template <class T = float>
struct OperandOf {
  const T* p;
  int ld;
  bool kmajor;
};
using Operand = OperandOf<float>;

// Split-K of a product on a card of `sms` SMs (two blocks an SM hold
// `slots` tiles in one wave).  Where the C tiles alone would not fill the
// card, as many slabs as one wave holds; in any case slabs at most
// kMaxSlab deep (C13), and when that bound asks for more slabs than one
// wave holds, as many as fill the waves it needs.  Each slab at least 32
// deep (so a b = 1 prefill's y = ctx W_out, 256 x 512 x 512, runs as 128
// blocks on 132 SMs).
int gemm_splits(int M, int N, int K, int sms, int* k_slab) {
  const int tiles = ((M + GT - 1) / GT) * ((N + GT - 1) / GT);
  const int slots = 2 * sms;
  int splits = tiles >= sms ? 1 : slots / tiles;
  const int deep = (K + kMaxSlab - 1) / kMaxSlab;
  if (deep > splits) {
    const int waves = (tiles * deep + slots - 1) / slots;
    splits = std::max(deep, waves * slots / tiles);
  }
  splits = std::max(1, std::min(splits, K / 32));
  int slab = (K + splits - 1) / splits;
  slab = (slab + GK - 1) / GK * GK;
  *k_slab = slab;
  return (K + slab - 1) / slab;
}

// Floats of partial sums a split GEMM of this shape needs (0 unsplit).
int64_t gemm_partials(int M, int N, int K, int sms) {
  int slab;
  const int splits = gemm_splits(M, N, K, sms, &slab);
  return splits > 1 ? (int64_t)splits * M * N : 0;
}

// ---------------------------------------------------------------------------
// bf16 x bf16 -> bf16 on tensor cores: #1's y = ctx W_out in amp
// ---------------------------------------------------------------------------
//
// C [M, N] = A B with A i-major (ctx [b t, hd]) and B k-major (W_out [hd,
// dm]), both bf16: mma.sync m16n8k16, exact products summed in f32 (the
// reference's y product, f32 on the widened bf16 operands), C rounded to
// bf16 once, or f32 partial sums of a split product added in slab order
// by sum_splits.  The same 128 x 128 C tiles, split-K choice
// (gemm_splits) and partials as the f32 tile, so #1's scratch contract
// (ptt_qkv_fwd_scratch) holds; every element is summed in increasing k
// stages (two k16 steps a stage), no atomics: y repeats its bits.
//
// 256 threads, 8 warps of 64 rows x 32 columns (4 x 4 m16n8 tiles, 64 f32
// accumulators); a stage is 32 k of A ([128][32], rows padded to 40
// elements) and B ([32][128], rows padded to 136), copied by 16-byte
// cp.async into a ring of three stages (two in flight while one
// multiplies); A's fragments by ldmatrix, B's by ldmatrix.trans, both
// padded so that the 8 rows of a matrix fall in distinct bank groups.
// Rows past M, columns past N and k past the slab come in as zeros (N
// and K multiples of 8).  55.5 KB of shared memory (kGemmTcSmem) and 127
// registers: two blocks an SM.  MMA work is the function's (no split).
// Bound at the amp step's y (8192 x 512 x 512): bytes (16.8 MB: 0.0050
// ms) over the MMAs (4.3 GFLOP: 0.0043 ms at 989 TFLOP/s).
constexpr int TC_K = 32;                  // reduction depth of a stage
constexpr int TC_ALD = TC_K + 8;          // row stride of an A stage
constexpr int TC_BLD = GT + 8;            // row stride of a B stage
constexpr int TC_STAGE = GT * TC_ALD + TC_K * TC_BLD;  // bf16 elements
constexpr int TC_STAGES = 3;
constexpr size_t kGemmTcSmem = TC_STAGES * TC_STAGE * sizeof(bf16);

// Start the copy of stage k0.. (A rows m0.., B columns n0..) into st.
__device__ __forceinline__ void gemm_tc_stage(bf16* st, const bf16* a,
                                              int lda, const bf16* b,
                                              int ldb, int M, int N, int m0,
                                              int n0, int k0, int k_end) {
#pragma unroll
  for (int u = 0; u < GT * TC_K / 8 / GNT; ++u) {  // A: 4 copies a row
    const int idx = threadIdx.x + u * GNT;
    const int row = idx / (TC_K / 8);
    const int c8 = idx % (TC_K / 8) * 8;
    const bool in = m0 + row < M && k0 + c8 < k_end;
    tc::copy16(st + row * TC_ALD + c8,
               in ? a + (int64_t)(m0 + row) * lda + k0 + c8 : a,
               in ? 16 : 0);
  }
  bf16* bs = st + GT * TC_ALD;
#pragma unroll
  for (int u = 0; u < TC_K * GT / 8 / GNT; ++u) {  // B: 16 copies a row
    const int idx = threadIdx.x + u * GNT;
    const int row = idx / (GT / 8);
    const int c8 = idx % (GT / 8) * 8;
    const bool in = k0 + row < k_end && n0 + c8 < N;
    tc::copy16(bs + row * TC_BLD + c8,
               in ? b + (int64_t)(k0 + row) * ldb + n0 + c8 : b,
               in ? 16 : 0);
  }
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = tc::pack(x, y);
}

// C[m, n] = sum_k A(m, k) B(k, n) over split blockIdx.z's slab, written
// to c + z * split_stride as TC (bf16 unsplit, f32 partials when split).
template <class TC>
__global__ void __launch_bounds__(GNT, 2)
gemm_tc_kernel(const bf16* __restrict__ a, int lda,
               const bf16* __restrict__ b, int ldb, TC* c, int ldc,
               size_t split_stride, int M, int N, int K, int k_slab) {
  extern __shared__ float smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  const int n0 = blockIdx.x * GT;
  const int m0 = blockIdx.y * GT;
  const int k_begin = blockIdx.z * k_slab;
  const int k_end = min(K, k_begin + k_slab);
  const int steps = (k_end - k_begin + TC_K - 1) / TC_K;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;  // the warp's rows and columns
  const int wn = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // stage s in ring slot s % 3; a group is committed every step, empty
  // past the last stage, so that wait<1> always means "stage s landed"
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < steps)
      gemm_tc_stage(sm + s * TC_STAGE, a, lda, b, ldb, M, N, m0, n0,
                    k_begin + s * TC_K, k_end);
    tc::commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::wait<TC_STAGES - 2>();
    __syncthreads();  // stage s has landed; slot (s + 2) % 3 is consumed
    if (s + TC_STAGES - 1 < steps)
      gemm_tc_stage(sm + (s + TC_STAGES - 1) % TC_STAGES * TC_STAGE, a, lda,
                    b, ldb, M, N, m0, n0, k_begin + (s + TC_STAGES - 1) *
                    TC_K, k_end);
    tc::commit();
    const bf16* as = sm + s % TC_STAGES * TC_STAGE;
    const bf16* bs = as + GT * TC_ALD;
#pragma unroll
    for (int ks = 0; ks < TC_K / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tc::ldsm4(af[i], as + tc::frag_offset(TC_ALD, wm + 16 * i, 16 * ks));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bf[4];
        tc::ldsm4_t(bf, bs + tc::frag_offset(TC_BLD, 16 * ks, wn + 16 * jp));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          tc::mma(acc[i][2 * jp], af[i], bf[0], bf[1]);
          tc::mma(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  c += blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * r;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * (lane & 3);
        if (n < N)
          store_pair(c + (size_t)m * ldc + n, acc[i][j][2 * r],
                     acc[i][j][2 * r + 1]);
      }
    }
}

template <class TC>
cudaError_t launch_gemm_tc(dim3 grid, cudaStream_t stream, const bf16* a,
                           int lda, const bf16* b, int ldb, TC* c, int ldc,
                           size_t stride, int M, int N, int K, int slab) {
  static bool configured = false;
  cudaError_t err = allow_smem(gemm_tc_kernel<TC>, kGemmTcSmem, configured);
  if (err != cudaSuccess) return err;
  gemm_tc_kernel<TC><<<grid, GNT, kGemmTcSmem, stream>>>(
      a, lda, b, ldb, c, ldc, stride, M, N, K, slab);
  return cudaGetLastError();
}

// gemm() of bf16 A (i-major) and B (k-major) into bf16 C on tensor cores
// (T = bf16; a template, so that only the sources that call it compile
// its kernels); cudaErrorInvalidValue unless N, K, the leading dimensions
// and ldc allow the tile's 16-byte copies and pair stores.
template <class T>
cudaError_t gemm_tc(OperandOf<T> A, OperandOf<T> B, T* c, int ldc, int M,
                    int N, int K, bool split, float* partials, int sms,
                    cudaStream_t stream) {
  static_assert(std::is_same<T, bf16>::value, "the tile is bf16");
  if (N % 8 || K % 8 || A.ld % 8 || B.ld % 8 || ldc % 2 ||
      reinterpret_cast<uintptr_t>(A.p) % 16 ||
      reinterpret_cast<uintptr_t>(B.p) % 16 ||
      reinterpret_cast<uintptr_t>(c) % 4)
    return cudaErrorInvalidValue;
  int slab = K;
  const int splits = split ? gemm_splits(M, N, K, sms, &slab) : 1;
  const size_t stride = (size_t)M * N;
  dim3 grid((N + GT - 1) / GT, (M + GT - 1) / GT, splits);
  if (splits == 1)
    return launch_gemm_tc<bf16>(grid, stream, A.p, A.ld, B.p, B.ld, c, ldc,
                                stride, M, N, K, slab);
  cudaError_t err = launch_gemm_tc<float>(grid, stream, A.p, A.ld, B.p,
                                          B.ld, partials, N, stride, M, N,
                                          K, slab);
  if (err != cudaSuccess) return err;
  const int blocks =
      (int)std::min<size_t>((stride + GNT - 1) / GNT, 4 * (size_t)sms);
  sum_splits<bf16><<<blocks, GNT, 0, stream>>>(partials, splits, M, N, c,
                                               ldc);
  return cudaGetLastError();
}

template <bool A_KM, bool B_KM, class TA, class TB, class TC>
void launch_gemm_kernel(dim3 grid, cudaStream_t stream, const TA* a, int lda,
                        const TB* b, int ldb, TC* c, int ldc, size_t stride,
                        int M, int N, int K, int slab) {
  gemm_kernel<A_KM, B_KM, TA, TB, TC><<<grid, GNT, 0, stream>>>(
      a, lda, b, ldb, c, ldc, stride, M, N, K, slab);
}

// C [M, N] (row stride ldc) = A B on a card of `sms` SMs, C of TC
// elements.  With split, a K too deep for the C tiles to fill the card is
// cut into slabs whose f32 partial sums go to `partials` (gemm_partials
// floats) and are added in order.
template <class TA = float, class TB = float, class TC = float>
cudaError_t gemm(OperandOf<TA> A, OperandOf<TB> B, TC* c, int ldc, int M,
                 int N, int K, bool split, float* partials, int sms,
                 cudaStream_t stream) {
  if constexpr (std::is_same<TA, bf16>::value &&
                std::is_same<TB, bf16>::value &&
                std::is_same<TC, bf16>::value) {
    if (!A.kmajor && B.kmajor)  // #1's y layout: the tensor-core tile
      return gemm_tc(A, B, c, ldc, M, N, K, split, partials, sms, stream);
  }
  int slab = K;
  const int splits = split ? gemm_splits(M, N, K, sms, &slab) : 1;
  const size_t stride = (size_t)M * N;
  dim3 grid((N + GT - 1) / GT, (M + GT - 1) / GT, splits);
  if (A.kmajor && !B.kmajor)
    return cudaErrorInvalidValue;  // no caller takes A k-major, B not
  if (splits > 1) {  // f32 partial sums, then added in order into c
    if (A.kmajor)
      launch_gemm_kernel<true, true>(grid, stream, A.p, A.ld, B.p, B.ld,
                                     partials, N, stride, M, N, K, slab);
    else if (B.kmajor)
      launch_gemm_kernel<false, true>(grid, stream, A.p, A.ld, B.p, B.ld,
                                      partials, N, stride, M, N, K, slab);
    else
      launch_gemm_kernel<false, false>(grid, stream, A.p, A.ld, B.p, B.ld,
                                       partials, N, stride, M, N, K, slab);
  } else if (A.kmajor) {
    launch_gemm_kernel<true, true>(grid, stream, A.p, A.ld, B.p, B.ld, c,
                                   ldc, stride, M, N, K, slab);
  } else if (B.kmajor) {
    launch_gemm_kernel<false, true>(grid, stream, A.p, A.ld, B.p, B.ld, c,
                                    ldc, stride, M, N, K, slab);
  } else {
    launch_gemm_kernel<false, false>(grid, stream, A.p, A.ld, B.p, B.ld, c,
                                     ldc, stride, M, N, K, slab);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int blocks =
      (int)std::min<size_t>((stride + GNT - 1) / GNT, 4 * (size_t)sms);
  sum_splits<TC><<<blocks, GNT, 0, stream>>>(partials, splits, M, N, c, ldc);
  return cudaGetLastError();
}

}  // namespace
