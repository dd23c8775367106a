// f32 GEMM for sm_90a: C = A B on 128x128 block tiles, with split-K.
//
// Shared by the fused-projection kernels: the backward (#2, #3 in
// qkv_attention_bwd.cu: the q|k|v and dctx projections, dx and dW) and
// #1's output projection (qkv_attention.cu: y = ctx W_out); conv_bn.cu's
// #19 runs gemm_tile with a statistics epilogue of its own.  256 threads, an
// 8x8 patch of each C tile per thread, operands staged k-major in shared
// memory and read as float4.  Every element of C is summed in one fixed
// order (split-K partials are added in slab order by sum_splits): no
// atomics, so two calls on the same inputs give the same bits.
//
// Bound: f32 FMA work on the CUDA cores (TF32 off); ~44% of the f32 peak
// at the training step's shapes.  No tensor cores, no TMA, no load
// pipelining: later work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int GNT = 256;     // threads of a GEMM block
constexpr int GT = 128;      // rows and columns of a C tile
constexpr int GK = 16;       // reduction depth staged per step
constexpr int GS = GT + 4;   // row stride of the k-major shared tiles

// dst[kk * GS + ii] = operand element (i0 + ii, k0 + kk), zero outside
// [0, n_i) x [k0, k_end).  An operand is k-major when element (i, k) is
// src[k * ld + i] (consecutive threads then read consecutive i), else
// i-major, src[i * ld + k].
template <bool KMAJOR>
__device__ __forceinline__ void gemm_stage(float* dst, const float* src,
                                           int ld, int i0, int n_i, int k0,
                                           int k_end) {
  for (int idx = threadIdx.x; idx < GK * GT; idx += GNT) {
    const int kk = KMAJOR ? idx / GT : idx % GK;
    const int ii = KMAJOR ? idx % GT : idx / GK;
    const int i = i0 + ii;
    const int k = k0 + kk;
    float v = 0.f;
    if (i < n_i && k < k_end)
      v = KMAJOR ? src[(size_t)k * ld + i] : src[(size_t)i * ld + k];
    dst[kk * GS + ii] = v;
  }
}

// Row (col) of a C tile held in acc row i (col j) by thread row ty (col
// tx): {4ty.., 64 + 4ty..}.
__device__ __forceinline__ int gemm_tile_row(int i, int t) {
  return i < 4 ? t * 4 + i : 64 + t * 4 + i - 4;
}

// acc = sum over k in [k_begin, k_end) of A(m0 + row, k) B(k, n0 + col)
// for this thread's 8x8 patch of the 128x128 C tile at (m0, n0), summed
// in increasing k; rows >= M and columns >= N read zeros.  A(m, k) is
// a[k * lda + m] when A_KM, else a[m * lda + k]; B(k, n) is b[k * ldb + n]
// when B_KM, else b[n * ldb + k].  a_s and b_s are GK * GS floats of
// shared memory each; every thread of the block calls this.
template <bool A_KM, bool B_KM>
__device__ __forceinline__ void gemm_tile(
    const float* __restrict__ a, int lda, const float* __restrict__ b,
    int ldb, int M, int N, int m0, int n0, int k_begin, int k_end,
    float* a_s, float* b_s, float (&acc)[8][8]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += GK) {
    __syncthreads();  // the last step's tiles are consumed
    gemm_stage<A_KM>(a_s, a, lda, m0, M, k0, k_end);
    gemm_stage<B_KM>(b_s, b, ldb, n0, N, k0, k_end);
    __syncthreads();
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
  __shared__ __align__(16) float a_s[GK * GS];
  __shared__ __align__(16) float b_s[GK * GS];
  const int n0 = blockIdx.x * GT;
  const int m0 = blockIdx.y * GT;
  const int k_begin = blockIdx.z * k_slab;
  const int k_end = min(K, k_begin + k_slab);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float acc[8][8];
  gemm_tile<A_KM, B_KM>(a, lda, b, ldb, M, N, m0, n0, k_begin, k_end, a_s,
                        b_s, acc);

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

// Split-K only where the C tiles alone would not fill the card's 132 SMs:
// then enough slabs for two blocks per SM, each at least 32 deep (so a
// b = 1 prefill's y = ctx W_out, 256 x 512 x 512, runs as 128 blocks).
int gemm_splits(int M, int N, int K, int* k_slab) {
  const int tiles = ((M + GT - 1) / GT) * ((N + GT - 1) / GT);
  int splits = tiles >= 132 ? 1 : (264 + tiles - 1) / tiles;
  splits = std::max(1, std::min(splits, K / 32));
  int slab = (K + splits - 1) / splits;
  slab = (slab + GK - 1) / GK * GK;
  *k_slab = slab;
  return (K + slab - 1) / slab;
}

// Floats of partial sums a split GEMM of this shape needs (0 unsplit).
int64_t gemm_partials(int M, int N, int K) {
  int slab;
  const int splits = gemm_splits(M, N, K, &slab);
  return splits > 1 ? (int64_t)splits * M * N : 0;
}

// C [M, N] (row stride ldc) = A B.  With split, a K too deep for the C
// tiles to fill the card is cut into slabs whose partial sums go to
// `partials` (gemm_partials floats) and are added in order.
cudaError_t gemm(Operand A, Operand B, float* c, int ldc, int M, int N,
                 int K, bool split, float* partials, cudaStream_t stream) {
  int slab = K;
  const int splits = split ? gemm_splits(M, N, K, &slab) : 1;
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
  const int blocks = (int)std::min<size_t>((stride + GNT - 1) / GNT, 4 * 132);
  sum_splits<<<blocks, GNT, 0, stream>>>(partials, splits, M, N, c, ldc);
  return cudaGetLastError();
}

}  // namespace
