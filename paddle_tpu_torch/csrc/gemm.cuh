// GEMM for sm_90a: C = A B on 128x128 block tiles, with split-K: f32 on
// the CUDA cores (the f32 tile, gemm_tile), bf16 (amp) on tensor cores
// (gemm_tc, below).
//
// Shared by the fused-projection kernels: the backward pair (#2 + #3 in
// qkv_attention_bwd.cu: the q|k|v and dctx projections, dx and dW) and
// #1's output projection (qkv_attention.cu: y = ctx W_out); conv_bn.cu's
// #19 runs gemm_tile with a statistics epilogue of its own in f32, and
// gemm_tc with the STATS epilogue in bf16 (gemm_tc_col_stats); gemm.cu
// exports both tiles alone.  The f32 tile: 256 threads, an 8x8 patch of
// each C tile per thread, operands staged k-major in shared memory and
// read as float4.
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
// A k-major operand is copied by cp.async; an i-major one is loaded into
// registers (`held`) and stored transposed after the stage's math.
template <bool KMAJOR>
struct GemmStager {
  static constexpr int kPerRow = KMAJOR ? GT / 4 : GK / 4;
  static constexpr int kRows = GNT / kPerRow;  // rows one pass covers

  const float* p;  // this thread's first element at the next stage
  int64_t row_step;  // elements from one pass's row to the next's
  int64_t k_step;    // elements from one stage to the next
  int ii, kk;        // where the first quad lands in a stage
  int n_i, k;        // rows of the operand; this thread's first k
  bool inside;       // the tile's rows all < n_i and the quads aligned
  float4 held[G4];   // the stage loaded, not yet stored

  __device__ __forceinline__ GemmStager(const float* src, int ld, int i0,
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
             reinterpret_cast<uintptr_t>(src) % 16 == 0;
    n_i -= i0;
  }

  // Element c of this thread's r-th quad at the current stage, 0 outside
  // [0, n_i) x [0, k_end): the checked path of edge tiles.
  __device__ __forceinline__ float at(int r, int c, int k_end) const {
    const int i = KMAJOR ? ii + c : ii + r * kRows;
    const int kc = KMAJOR ? k + r * kRows : k + c;
    return i < n_i && kc < k_end ? p[r * row_step + c] : 0.f;
  }

  __device__ __forceinline__ float4 at4(int r, int k_end) const {
    return make_float4(at(r, 0, k_end), at(r, 1, k_end), at(r, 2, k_end),
                       at(r, 3, k_end));
  }

  // Start the current stage's loads into `stage`: by cp.async (k-major)
  // or into registers.  `full`: no element is outside.
  __device__ __forceinline__ void load(float* stage, bool full, int k_end) {
#pragma unroll
    for (int r = 0; r < G4; ++r) {
      if constexpr (KMAJOR) {
        float* dst = stage + (kk + r * kRows) * GS + ii;
        if (full)
          cp_async16(dst, p + r * row_step);
        else
          *reinterpret_cast<float4*>(dst) = at4(r, k_end);
      } else {
        held[r] = full ? __ldg(reinterpret_cast<const float4*>(
                             p + r * row_step))
                       : at4(r, k_end);
      }
    }
  }

  // Store the held stage into `stage` (i-major: transposed).
  __device__ __forceinline__ void store(float* stage) const {
    if constexpr (!KMAJOR) {
#pragma unroll
      for (int r = 0; r < G4; ++r) {
        const float4 v = held[r];
        float* dst = stage + kk * GS + ii + r * kRows;
        dst[0] = v.x;
        dst[GS] = v.y;
        dst[2 * GS] = v.z;
        dst[3 * GS] = v.w;
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
// in increasing k; rows >= M and columns >= N read zeros.  A(m, k) is
// a[k * lda + m] when A_KM, else a[m * lda + k]; B(k, n) is b[k * ldb + n]
// when B_KM, else b[n * ldb + k].  k_begin is a multiple of GK.  smem is
// GEMM_SMEM floats of 16-byte aligned shared memory, free again when this
// returns; every thread of the block calls this.
template <bool A_KM, bool B_KM>
__device__ __forceinline__ void gemm_tile(
    const float* __restrict__ a, int lda, const float* __restrict__ b,
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

  GemmStager<A_KM> sa(a, lda, m0, M, k_begin);
  GemmStager<B_KM> sb(b, ldb, n0, N, k_begin);
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
// [z * k_slab, (z + 1) * k_slab), written to c + z * split_stride; A and
// B as gemm_tile reads them.  TA, TB and TC are f32 (bf16 products run on
// gemm_tc_kernel).
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
  gemm_tile<A_KM, B_KM>(a, lda, b, ldb, M, N, m0, n0, k_begin, k_end, smem,
                        acc);

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
// bf16 products on tensor cores: #1's y, #19's and the pair's five (amp)
// ---------------------------------------------------------------------------
//
// C [M, N] = A B on mma.sync m16n8k16 with f32 accumulators: #1's y = ctx
// W_out, #19's y = x2 w2^T (with its column statistics), and the pair #2 +
// #3's q|k|v = x W_qkv, dctx = g W_out^T, dx =
// [dq | dk | dv] W_qkv^T, dW_qkv = x^T [dq | dk | dv] and dW_out = ctx^T g
// (qkv_attention_bwd.cu).  An operand (TcOperand) is bf16, or an f32 value
// held as two bf16 planes hi + lo (mma.cuh's split; lo != 0 is the lo
// plane's offset from the hi plane, in elements).  A bf16 x bf16 product
// is one MMA a tile and k16 chunk, exact products summed in f32 (the
// reference's products of widened bf16 operands); a split operand times
// a bf16 one is two, hi and lo (the value to 2^-16 of itself; the other
// operand is exact).  Element (i, k) of an operand is p[k * ld + i] when
// it is k-major, else p[i * ld + k]: A i-major (x, g, ctx of y, the
// pair's dq|dk|dv, #19's x2) or k-major (x^T, ctx^T of the dW products),
// B k-major (W_qkv, W_out, g, dq|dk|dv) or i-major (W_out^T, W_qkv^T,
// #19's w2^T).  C is bf16
// (rounded once), f32 (an f32 C, or the partial sums of a split product,
// added in slab order by sum_splits), or hi/lo planes of its f32 value
// (the pair's projections, which the walks read); the dctx product also
// forms delta = rowsum(dctx * ctx) per head from its f32 accumulators,
// and #19 the column sums of its stored bf16 y (STATS).
// The same 128 x 128 C tiles, split-K choice (gemm_splits: no dW sum
// runs over more than kMaxSlab k) and partials as the f32 tile: every
// element is summed in increasing k stages (two k16 steps a stage), no
// atomics, so two calls give the same bits.
//
// 256 threads, 8 warps of 64 rows x 32 columns (4 x 4 m16n8 tiles, 64 f32
// accumulators); a stage is 32 k of each plane of A and B, copied as it
// lies in memory by 16-byte cp.async into a ring of three stages (two in
// flight while one multiplies): a tile whose rows run along k ([128][32],
// rows padded to 40 elements) or along i ([32][128], padded to 136), so
// that the 8 rows ldmatrix reads at once fall in distinct bank groups.
// A's fragments by ldmatrix (i-major) or ldmatrix.trans (k-major), B's by
// ldmatrix.trans (k-major) or ldmatrix (i-major).  Rows past M, columns
// past N and k past the slab come in as zeros.  Shared memory
// TcTile::kSmem: 55.5 KB (bf16 operands) to 88.5 KB (dx, A split), two
// blocks an SM; registers and spills in the build log (-Xptxas -v).
// Bound at the amp step's shapes (b 32, t 256, d_model 512, 8 heads):
// the MMAs, 73.0 GFLOP issued for the pair's 47.2 (dx and dW_qkv twice)
// at 989 TFLOP/s; y's bytes (16.8 MB: 0.0050 ms) over its MMAs (4.3
// GFLOP: 0.0043 ms).
constexpr int TC_K = 32;          // reduction depth of a stage
constexpr int TC_ALD = TC_K + 8;  // row stride of a [128][32] tile
constexpr int TC_BLD = GT + 8;    // row stride of a [32][128] tile
constexpr int TC_STAGES = 3;

// One operand of the tensor-core tile: bf16 elements, (i, k) at p[k * ld
// + i] when kmajor, else p[i * ld + k]; lo != 0: the lo plane of a split
// f32 operand starts lo elements after p (the hi plane).
struct TcOperand {
  const bf16* p;
  int ld;
  bool kmajor;
  int64_t lo;
};

// Shared memory of one ring stage: each plane's tile of A, then of B.
template <bool A_KM, bool B_KM, bool A_LO, bool B_LO>
struct TcTile {
  static constexpr int kA = A_KM ? TC_K * TC_BLD : GT * TC_ALD;
  static constexpr int kB = B_KM ? TC_K * TC_BLD : GT * TC_ALD;
  static constexpr int kStage = kA * (A_LO ? 2 : 1) + kB * (B_LO ? 2 : 1);
  static constexpr size_t kSmem = TC_STAGES * kStage * sizeof(bf16);
};

// Start the copy of one plane's tile of the stage at k0 into dst: rows
// i0.. of an operand of n_i rows (A's M or B's N) laid out as KM says
// (tile [TC_K][TC_BLD] when k-major, [GT][TC_ALD] else); elements outside
// [n_i) x [k_end) come in as zeros.
template <bool KM>
__device__ __forceinline__ void gemm_tc_copy(bf16* dst, const bf16* src,
                                             int ld, int n_i, int i0,
                                             int k0, int k_end) {
  constexpr int kPerRow = (KM ? GT : TC_K) / 8;  // 16-byte copies a row
#pragma unroll
  for (int u = 0; u < GT * TC_K / 8 / GNT; ++u) {
    const int idx = threadIdx.x + u * GNT;
    const int row = idx / kPerRow;
    const int c8 = idx % kPerRow * 8;
    const int i = KM ? i0 + c8 : i0 + row;
    const int k = KM ? k0 + row : k0 + c8;
    const bool in = i < n_i && k < k_end;
    tc::copy16(dst + row * (KM ? TC_BLD : TC_ALD) + c8,
               in ? src + (KM ? (int64_t)k * ld + i : (int64_t)i * ld + k)
                  : src,
               in ? 16 : 0);
  }
}

template <bool A_KM, bool B_KM, bool A_LO, bool B_LO>
__device__ __forceinline__ void gemm_tc_stage(bf16* st, const TcOperand& a,
                                              const TcOperand& b, int M,
                                              int N, int m0, int n0, int k0,
                                              int k_end) {
  using Tile = TcTile<A_KM, B_KM, A_LO, B_LO>;
  gemm_tc_copy<A_KM>(st, a.p, a.ld, M, m0, k0, k_end);
  if (A_LO) gemm_tc_copy<A_KM>(st + Tile::kA, a.p + a.lo, a.ld, M, m0, k0,
                               k_end);
  bf16* bs = st + Tile::kA * (A_LO ? 2 : 1);
  gemm_tc_copy<B_KM>(bs, b.p, b.ld, N, n0, k0, k_end);
  if (B_LO) gemm_tc_copy<B_KM>(bs + Tile::kB, b.p + b.lo, b.ld, N, n0, k0,
                               k_end);
}

// The A fragment of rows r0.. at k0.. of an A plane's tile.
template <bool KM>
__device__ __forceinline__ void tc_frag_a(uint32_t (&f)[4], const bf16* tile,
                                          int r0, int k0) {
  if (KM)
    tc::ldsm4_t(f, tile + tc::frag_offset_nk(TC_BLD, k0, r0));
  else
    tc::ldsm4(f, tile + tc::frag_offset(TC_ALD, r0, k0));
}

// The B fragments of n tiles n0.. (f[0], f[1]) and n0 + 8.. (f[2], f[3])
// at k0.. of a B plane's tile.
template <bool KM>
__device__ __forceinline__ void tc_frag_b(uint32_t (&f)[4], const bf16* tile,
                                          int n0, int k0) {
  if (KM)
    tc::ldsm4_t(f, tile + tc::frag_offset(TC_BLD, k0, n0));
  else
    tc::ldsm4(f, tile + tc::frag_offset_nk(TC_ALD, n0, k0));
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<uint32_t*>(p) = tc::pack(x, y);
}

// Where a tensor-core product's C goes: c [M, N] of row stride ldc, split
// z's partial sums at c + z * split; with C_LO the hi plane of an f32 C,
// its lo plane lo elements after c; with DELTA (a head width, 64 or 128)
// also delta[(bi * h + head) * t + r] = sum over head's DELTA columns of
// C(m, .) * ctx(m, .) for row m = bi * t + r (ctx [M, N] of row stride
// ldc); with STATS (#19 in bf16,
// unsplit) also the sum and the sum of squares of each column of the
// stored C (rounded to TC) over the block's rows, at part[(stat *
// gridDim.y + blockIdx.y) * N + n] (stat 0 the sum, 1 the squares).
template <class TC>
struct TcOut {
  TC* c;
  int ldc;
  size_t split;
  int64_t lo;
  const bf16* ctx;
  float* delta;
  int t, h;
  float* part;
};

// The pair of values store_pair keeps at C, as f32.
__device__ __forceinline__ float2 stored_pair(const float*, float x,
                                              float y) {
  return make_float2(x, y);
}
__device__ __forceinline__ float2 stored_pair(const bf16*, float x,
                                              float y) {
  return __bfloat1622float2(__floats2bfloat162_rn(x, y));
}

template <bool A_KM, bool B_KM, bool A_LO, bool B_LO, class TC,
          bool C_LO = false, int DELTA = 0, bool STATS = false>
__global__ void __launch_bounds__(GNT, 2)
gemm_tc_kernel(TcOperand a, TcOperand b, TcOut<TC> out, int M, int N,
               int K, int k_slab) {
  static_assert(!(A_LO && B_LO), "one split operand");
  using Tile = TcTile<A_KM, B_KM, A_LO, B_LO>;
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
      gemm_tc_stage<A_KM, B_KM, A_LO, B_LO>(sm + s * Tile::kStage, a, b, M,
                                            N, m0, n0, k_begin + s * TC_K,
                                            k_end);
    tc::commit();
  }
  for (int s = 0; s < steps; ++s) {
    tc::wait<TC_STAGES - 2>();
    __syncthreads();  // stage s has landed; slot (s + 2) % 3 is consumed
    if (s + TC_STAGES - 1 < steps)
      gemm_tc_stage<A_KM, B_KM, A_LO, B_LO>(
          sm + (s + TC_STAGES - 1) % TC_STAGES * Tile::kStage, a, b, M, N,
          m0, n0, k_begin + (s + TC_STAGES - 1) * TC_K, k_end);
    tc::commit();
    const bf16* as = sm + s % TC_STAGES * Tile::kStage;
    const bf16* bs = as + Tile::kA * (A_LO ? 2 : 1);
#pragma unroll
    for (int ks = 0; ks < TC_K / 16; ++ks) {
      if constexpr (A_LO) {  // B's fragments held, A's hi then lo a row
        uint32_t bf[2][4];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
          tc_frag_b<B_KM>(bf[jp], bs, wn + 16 * jp, 16 * ks);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int plane = 0; plane < 2; ++plane) {
            uint32_t af[4];
            tc_frag_a<A_KM>(af, as + plane * Tile::kA, wm + 16 * i, 16 * ks);
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) {
              tc::mma(acc[i][2 * jp], af, bf[jp][0], bf[jp][1]);
              tc::mma(acc[i][2 * jp + 1], af, bf[jp][2], bf[jp][3]);
            }
          }
      } else {
        uint32_t af[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tc_frag_a<A_KM>(af[i], as, wm + 16 * i, 16 * ks);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp)
#pragma unroll
          for (int plane = 0; plane < (B_LO ? 2 : 1); ++plane) {
            uint32_t bf[4];
            tc_frag_b<B_KM>(bf, bs + plane * Tile::kB, wn + 16 * jp,
                            16 * ks);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              tc::mma(acc[i][2 * jp], af[i], bf[0], bf[1]);
              tc::mma(acc[i][2 * jp + 1], af[i], bf[2], bf[3]);
            }
          }
      }
    }
  }

  TC* c = out.c + blockIdx.z * out.split;
  // STATS: this thread's sums of its 8 columns (tile j, pair e) over its
  // 8 rows, in increasing i, then r
  float cs[4][2] = {}, cq[4][2] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + 16 * i + (lane >> 2) + 8 * r;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn + 8 * j + 2 * (lane & 3);
        if (n >= N) continue;
        const float x = acc[i][j][2 * r], y = acc[i][j][2 * r + 1];
        if constexpr (C_LO) {
          uint32_t hi, lo;
          tc::split(x, y, hi, lo);
          *reinterpret_cast<uint32_t*>(c + (size_t)m * out.ldc + n) = hi;
          *reinterpret_cast<uint32_t*>(c + out.lo + (size_t)m * out.ldc +
                                       n) = lo;
        } else {
          store_pair(c + (size_t)m * out.ldc + n, x, y);
        }
        if constexpr (STATS) {
          const float2 v = stored_pair(c, x, y);
          cs[j][0] += v.x;
          cs[j][1] += v.y;
          cq[j][0] += v.x * v.x;
          cq[j][1] += v.y * v.y;
        }
      }
    }
  if constexpr (STATS) {
    // the 8 lanes of a column (lane bits 2-4) summed by xor shuffles, then
    // the block's two warps of the column (rows 0-63, 64-127) in that
    // order through shared memory: one partial per (128-row tile, column)
    __syncthreads();  // the ring is read: its first 2 KB hold the sums
    float* red = smem;  // [stat][warp row][GT]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = cs[j][e], q = cq[j][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (lane < 4) {
          const int col = wn + 8 * j + 2 * lane + e;
          red[(warp >> 2) * GT + col] = s;
          red[(2 + (warp >> 2)) * GT + col] = q;
        }
      }
    __syncthreads();
    const int col = threadIdx.x % GT;
    const int stat = threadIdx.x / GT;
    const int n = n0 + col;
    if (n < N)
      out.part[((size_t)stat * gridDim.y + blockIdx.y) * N + n] =
          red[2 * stat * GT + col] + red[(2 * stat + 1) * GT + col];
  }
  if constexpr (DELTA) {
    // each warp's sum over its 32 columns of C * ctx for its rows (the
    // quad's lanes summed by shuffles), then the warps of a head's
    // columns added in one fixed order: the two of a 64-wide head; at
    // width 128 (the tile's columns, one head) the first two and the last
    // two, then those halves
    __syncthreads();  // the ring is read: its first 2 KB hold the sums
    float* red = smem;  // [GT][4]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wm + 16 * i + (lane >> 2) + 8 * r;
        const int m = m0 + row;
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = n0 + wn + 8 * j + 2 * (lane & 3);
          if (m < M && n < N) {
            const float2 cv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    out.ctx + (size_t)m * out.ldc + n));
            s += acc[i][j][2 * r] * cv.x + acc[i][j][2 * r + 1] * cv.y;
          }
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if ((lane & 3) == 0) red[row * 4 + (warp & 3)] = s;
      }
    __syncthreads();
    static_assert(DELTA == 64 || DELTA == GT, "a head is 64 or GT columns");
    if constexpr (DELTA == 64) {
      const int row = threadIdx.x >> 1;
      const int half = threadIdx.x & 1;
      const int m = m0 + row;
      const int col = n0 + 64 * half;
      if (m < M && col < N)
        out.delta[((size_t)(m / out.t) * out.h + col / 64) * out.t +
                  m % out.t] = red[row * 4 + 2 * half] +
                               red[row * 4 + 2 * half + 1];
    } else {
      const int row = threadIdx.x;
      const int m = m0 + row;
      if (row < GT && m < M && n0 < N)
        out.delta[((size_t)(m / out.t) * out.h + n0 / GT) * out.t +
                  m % out.t] = (red[row * 4] + red[row * 4 + 1]) +
                               (red[row * 4 + 2] + red[row * 4 + 3]);
    }
  }
}

template <bool A_KM, bool B_KM, bool A_LO, bool B_LO, class TC,
          bool C_LO = false, int DELTA = 0, bool STATS = false>
cudaError_t launch_gemm_tc(dim3 grid, cudaStream_t stream, TcOperand a,
                           TcOperand b, TcOut<TC> out, int M, int N, int K,
                           int slab) {
  constexpr size_t kSmem = TcTile<A_KM, B_KM, A_LO, B_LO>::kSmem;
  static bool configured = false;
  cudaError_t err = allow_smem(
      gemm_tc_kernel<A_KM, B_KM, A_LO, B_LO, TC, C_LO, DELTA, STATS>, kSmem,
      configured);
  if (err != cudaSuccess) return err;
  gemm_tc_kernel<A_KM, B_KM, A_LO, B_LO, TC, C_LO, DELTA, STATS>
      <<<grid, GNT, kSmem, stream>>>(a, b, out, M, N, K, slab);
  return cudaGetLastError();
}

// Whether an operand of n_i rows (A's M, B's N) and depth K takes the
// tile's 16-byte copies: its planes 16-byte aligned, ld a multiple of 8,
// and the dimension the copies run along (i when k-major, else k) a
// multiple of 8.
inline bool tc_fits(const TcOperand& o, int n_i, int K) {
  return o.ld % 8 == 0 && o.lo % 8 == 0 && (o.kmajor ? n_i : K) % 8 == 0 &&
         reinterpret_cast<uintptr_t>(o.p) % 16 == 0;
}

// C [M, N] (row stride ldc) of TC (bf16 or f32) = A B on tensor cores, A
// and B in the layouts and splits of the template (checked against the
// operands); with split, a K too deep for the C tiles to fill the card is
// cut into slabs whose f32 partial sums go to `partials`
// (gemm_partials floats) and are added in order.  cudaErrorInvalidValue
// unless the operands take the tile's copies (tc_fits) and C its pair
// stores (N and ldc even, c 4-byte aligned).
template <bool A_KM, bool B_KM, bool A_LO, bool B_LO, class TC>
cudaError_t gemm_tc(TcOperand A, TcOperand B, TC* c, int ldc, int M, int N,
                    int K, bool split, float* partials, int sms,
                    cudaStream_t stream) {
  if (A.kmajor != A_KM || B.kmajor != B_KM || (A.lo != 0) != A_LO ||
      (B.lo != 0) != B_LO || !tc_fits(A, M, K) || !tc_fits(B, N, K) ||
      N % 2 || ldc % 2 || reinterpret_cast<uintptr_t>(c) % 4)
    return cudaErrorInvalidValue;
  int slab = K;
  const int splits = split ? gemm_splits(M, N, K, sms, &slab) : 1;
  const size_t stride = (size_t)M * N;
  dim3 grid((N + GT - 1) / GT, (M + GT - 1) / GT, splits);
  if (splits == 1)
    return launch_gemm_tc<A_KM, B_KM, A_LO, B_LO, TC>(
        grid, stream, A, B, TcOut<TC>{c, ldc, stride}, M, N, K, slab);
  cudaError_t err = launch_gemm_tc<A_KM, B_KM, A_LO, B_LO, float>(
      grid, stream, A, B, TcOut<float>{partials, N, stride}, M, N, K, slab);
  if (err != cudaSuccess) return err;
  const int blocks =
      (int)std::min<size_t>((stride + GNT - 1) / GNT, 4 * (size_t)sms);
  sum_splits<TC><<<blocks, GNT, 0, stream>>>(partials, splits, M, N, c,
                                             ldc);
  return cudaGetLastError();
}

// The pair's projections on tensor cores: C [M, N] = A B (A bf16 i-major,
// B bf16 k-major or, B_KM false, i-major) unsplit, stored as the hi/lo
// planes of its f32 value (c, c + lo, row stride ldc); with DELTA, a head
// width (the dctx product, C = dctx [b t, h DELTA]), also delta [b, h, t]
// = rowsum(C * ctx) per head, from the f32 accumulators.
template <bool B_KM, int DELTA>
cudaError_t gemm_tc_planes(TcOperand A, TcOperand B, bf16* c, int ldc,
                           int64_t lo, const bf16* ctx, float* delta, int t,
                           int h, int M, int N, int K, cudaStream_t stream) {
  if (A.kmajor || A.lo || B.lo || B.kmajor != B_KM || !tc_fits(A, M, K) ||
      !tc_fits(B, N, K) || N % 2 || ldc % 2 || lo % 2 ||
      reinterpret_cast<uintptr_t>(c) % 4 ||
      (DELTA && (N % DELTA || reinterpret_cast<uintptr_t>(ctx) % 4)))
    return cudaErrorInvalidValue;
  dim3 grid((N + GT - 1) / GT, (M + GT - 1) / GT, 1);
  return launch_gemm_tc<false, B_KM, false, false, bf16, true, DELTA>(
      grid, stream, A, B, TcOut<bf16>{c, ldc, 0, lo, ctx, delta, t, h}, M,
      N, K, K);
}

// #19 in bf16: y [M, N] = x2 [M, K] w2^T (x2 and w2 [N, K] bf16, both
// i-major) unsplit, y rounded to bf16, with the column sums and sums of
// squares of the stored y at part[(stat * ceil(M / GT) + m tile) * N +
// n].  cudaErrorInvalidValue unless both operands take the tile's copies
// (tc_fits: K % 8 == 0, 16-byte aligned) and N is even.
inline cudaError_t gemm_tc_col_stats(const bf16* x2, const bf16* w2, bf16* y,
                                     float* part, int M, int N, int K,
                                     cudaStream_t stream) {
  const TcOperand A{x2, K, false, 0}, B{w2, K, false, 0};
  if (!tc_fits(A, M, K) || !tc_fits(B, N, K) || N % 2 ||
      reinterpret_cast<uintptr_t>(y) % 4)
    return cudaErrorInvalidValue;
  dim3 grid((N + GT - 1) / GT, (M + GT - 1) / GT, 1);
  TcOut<bf16> out{};
  out.c = y;
  out.ldc = N;
  out.part = part;
  return launch_gemm_tc<false, false, false, false, bf16, false, 0,
                        true>(grid, stream, A, B, out, M, N, K, K);
}

template <bool A_KM, bool B_KM, class TA, class TB, class TC>
void launch_gemm_kernel(dim3 grid, cudaStream_t stream, const TA* a, int lda,
                        const TB* b, int ldb, TC* c, int ldc, size_t stride,
                        int M, int N, int K, int slab) {
  gemm_kernel<A_KM, B_KM, TA, TB, TC><<<grid, GNT, 0, stream>>>(
      a, lda, b, ldb, c, ldc, stride, M, N, K, slab);
}

// C [M, N] (row stride ldc) = A B on a card of `sms` SMs: f32 on the
// f32 tile; bf16 (#1's y: A i-major, B k-major, the only bf16 caller) on
// the tensor-core tile.  With split, a K too deep for the C tiles to fill
// the card is cut into slabs whose f32 partial sums go to `partials`
// (gemm_partials floats) and are added in order.
template <class TA = float, class TB = float, class TC = float>
cudaError_t gemm(OperandOf<TA> A, OperandOf<TB> B, TC* c, int ldc, int M,
                 int N, int K, bool split, float* partials, int sms,
                 cudaStream_t stream) {
  if constexpr (!std::is_same<TA, float>::value ||
                !std::is_same<TB, float>::value ||
                !std::is_same<TC, float>::value) {
    static_assert(std::is_same<TA, bf16>::value &&
                      std::is_same<TB, bf16>::value &&
                      std::is_same<TC, bf16>::value,
                  "f32 or bf16 throughout");
    return gemm_tc<false, true, false, false, bf16>(
        {A.p, A.ld, A.kmajor, 0}, {B.p, B.ld, B.kmajor, 0}, c, ldc, M, N, K,
        split, partials, sms, stream);
  } else {
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
    sum_splits<TC><<<blocks, GNT, 0, stream>>>(partials, splits, M, N, c,
                                               ldc);
    return cudaGetLastError();
  }
}

}  // namespace
