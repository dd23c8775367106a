// f32 GEMM for sm_90a: C = A B on 128x128 block tiles, with split-K.
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
// block an SM with the registers that frees (PERF.md).
// No tensor cores, no TMA: later work.
//
// Summation depth (C13): a split product (the pair's dW sums, K = b * t)
// is cut into slabs of at most kMaxSlab = 1024 k, so no element of it is
// one running f32 sum over more than 1024 terms; unsplit products (the
// projections, dx, #19) sum their K <= 3hd in one.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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
// ld + k].  Thread `tid`'s r-th float4 of a stage is four consecutive
// elements in memory: i = 4 (f % (GT / 4)).. of k row f / (GT / 4) when
// k-major, k = 4 (f % (GK / 4)).. of i row f / (GK / 4) when i-major,
// with f = tid + r * GNT (consecutive threads on consecutive addresses).
template <bool KMAJOR>
struct GemmStager {
  static constexpr int kPerRow = KMAJOR ? GT / 4 : GK / 4;
  static constexpr int kRows = GNT / kPerRow;  // rows one pass covers

  const float* p;  // this thread's first element at the next stage
  int64_t row_step;  // floats from one pass's row to the next's
  int64_t k_step;    // floats from one stage to the next
  int ii, kk;        // where the first float4 lands in a stage
  int n_i, k;        // rows of the operand; this thread's first k
  bool inside;       // the tile's rows all < n_i and 16-byte aligned
  float4 held[G4];   // i-major: the stage loaded, not yet stored

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

  // Element c of this thread's r-th float4 at the current stage, 0 outside
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
  // or into registers (i-major).  `full`: no element is outside.
  __device__ __forceinline__ void load(float* stage, bool full, int k_end) {
#pragma unroll
    for (int r = 0; r < G4; ++r) {
      if (KMAJOR) {
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

  // i-major: store the held stage transposed into `stage`.
  __device__ __forceinline__ void store(float* stage) const {
    if (KMAJOR) return;
#pragma unroll
    for (int r = 0; r < G4; ++r) {
      float* dst = stage + kk * GS + ii + r * kRows;
      dst[0] = held[r].x;
      dst[GS] = held[r].y;
      dst[2 * GS] = held[r].z;
      dst[3 * GS] = held[r].w;
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
// B as gemm_tile reads them.
template <bool A_KM, bool B_KM>
__global__ void __launch_bounds__(GNT, 2)
gemm_kernel(const float* __restrict__ a, int lda,
            const float* __restrict__ b, int ldb, float* c, int ldc,
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
      if (n < N) c[(size_t)m * ldc + n] = acc[i][j];
    }
  }
}

// c[m * ldc + n] = sum over s = 0, 1, ... of part[s][m][n], in that order.
__global__ void __launch_bounds__(GNT)
sum_splits(const float* __restrict__ part, int splits, int M, int N,
           float* c, int ldc) {
  const size_t mn = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)GNT + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * GNT) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * mn + i];
    c[(i / N) * ldc + i % N] = s;
  }
}

// One GEMM operand: element (i, k) at p[k * ld + i] when kmajor, else at
// p[i * ld + k].
struct Operand {
  const float* p;
  int ld;
  bool kmajor;
};

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

// C [M, N] (row stride ldc) = A B on a card of `sms` SMs.  With split, a
// K too deep for the C tiles to fill the card is cut into slabs whose
// partial sums go to `partials` (gemm_partials floats) and are added in
// order.
cudaError_t gemm(Operand A, Operand B, float* c, int ldc, int M, int N,
                 int K, bool split, float* partials, int sms,
                 cudaStream_t stream) {
  int slab = K;
  const int splits = split ? gemm_splits(M, N, K, sms, &slab) : 1;
  float* out = splits > 1 ? partials : c;
  const int ld_out = splits > 1 ? N : ldc;
  const size_t stride = (size_t)M * N;
  dim3 grid((N + GT - 1) / GT, (M + GT - 1) / GT, splits);
  if (A.kmajor && B.kmajor)
    gemm_kernel<true, true><<<grid, GNT, 0, stream>>>(
        A.p, A.ld, B.p, B.ld, out, ld_out, stride, M, N, K, slab);
  else if (!A.kmajor && B.kmajor)
    gemm_kernel<false, true><<<grid, GNT, 0, stream>>>(
        A.p, A.ld, B.p, B.ld, out, ld_out, stride, M, N, K, slab);
  else if (!A.kmajor && !B.kmajor)
    gemm_kernel<false, false><<<grid, GNT, 0, stream>>>(
        A.p, A.ld, B.p, B.ld, out, ld_out, stride, M, N, K, slab);
  else
    return cudaErrorInvalidValue;  // no caller takes A k-major, B not
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int blocks =
      (int)std::min<size_t>((stride + GNT - 1) / GNT, 4 * (size_t)sms);
  sum_splits<<<blocks, GNT, 0, stream>>>(partials, splits, M, N, c, ldc);
  return cudaGetLastError();
}

}  // namespace
