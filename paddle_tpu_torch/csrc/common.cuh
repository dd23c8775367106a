// Reductions and the single-query walk shared by the port's decode kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace ptt {

// head width the decode kernels are compiled for
constexpr int DH = 64;
// score of a masked row (the reference's -1e30)
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sum of v over the whole block; red_s holds one float per warp.  Every
// thread gets the result.  The barrier at its start keeps a later call
// from overwriting red_s before every thread has read this one's total.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red_s) {
  constexpr int NW = NT / 32;
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) total += red_s[w];
  return total;
}

// Where logical row r of one sequence's k (and v) cache starts: off(r),
// in floats from k (and v).  A row holds the h heads of DH floats,
// hd = h * DH.
//
// Ring: the sequence's contiguous slice of [L, b, max_t, h, DH]; k and v
// point at its row 0, and every row follows the one before.
struct RingRows {
  static constexpr bool kContiguous = true;
  const float* k;
  const float* v;
  int hd;
  __device__ __forceinline__ size_t off(int r) const {
    return (size_t)r * hd;
  }
};

// Paged: row r lives at block tab_s[r / block_t] of layer `layer` of the
// pool [L, num_blocks, block_t, h, DH], row r % block_t; k and v point at
// the pool, and rows r .. r + run(r) - 1 follow each other within one
// block.  tab_s is the sequence's table row, copied into shared memory by
// its block (the TPU kernels prefetch it as scalars instead).  A walk
// step of 32 rows may span several blocks.
struct PagedRows {
  static constexpr bool kContiguous = false;
  const float* k;
  const float* v;
  const int* tab_s;
  size_t layer_block0;  // layer * num_blocks
  int block_t;
  int hd;
  __device__ __forceinline__ size_t off(int r) const {
    return ((layer_block0 + tab_s[r / block_t]) * block_t + r % block_t) *
           hd;
  }
  __device__ __forceinline__ int run(int r) const {
    return block_t - r % block_t;
  }
};

// Online-softmax state of one warp for one head: running max, running sum
// and the lane's two context dims (2 * lane, 2 * lane + 1).
struct WalkState {
  float m;
  float l;
  float2 acc;
};

__device__ __forceinline__ WalkState walk_start() {
  return WalkState{-INFINITY, 0.f, make_float2(0.f, 0.f)};
}

// One warp's share of a single-query walk of head h: the 32-row steps
// c0 = first, first + stride, ... below n_valid, lane j scoring row c0 + j
// against qh [DH] (pre-scaled, in shared memory) and accumulating
// p_j * v_j into its two context dims.  A pool's v pass takes the step's
// rows in runs within one block, so it looks its table up once per block
// and not once per row.
template <class Rows>
__device__ __forceinline__ void walk_rows(const Rows& rows, int h,
                                          const float* qh, int n_valid,
                                          int first, int stride,
                                          WalkState& st) {
  const int lane = threadIdx.x & 31;
  for (int c0 = first; c0 < n_valid; c0 += stride) {
    const int r = c0 + lane;
    float s = kMaskValue;
    if (r < n_valid) {
      const float4* kr =
          reinterpret_cast<const float4*>(rows.k + rows.off(r) + h * DH);
      s = 0.f;
#pragma unroll
      for (int u = 0; u < DH / 4; ++u) {
        const float4 kv = kr[u];
        s += qh[4 * u] * kv.x + qh[4 * u + 1] * kv.y +
             qh[4 * u + 2] * kv.z + qh[4 * u + 3] * kv.w;
      }
    }
    const float m_new = fmaxf(st.m, warp_max(s));
    const float p = expf(s - m_new);
    const float alpha = expf(st.m - m_new);
    st.l = st.l * alpha + warp_sum(p);
    st.acc.x *= alpha;
    st.acc.y *= alpha;
    const int nr = min(32, n_valid - c0);
    if constexpr (Rows::kContiguous) {
      for (int j = 0; j < nr; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float2 vv = *reinterpret_cast<const float2*>(
            rows.v + rows.off(c0 + j) + h * DH + 2 * lane);
        st.acc.x += pj * vv.x;
        st.acc.y += pj * vv.y;
      }
    } else {
      for (int j = 0; j < nr;) {
        const int end = min(nr, j + rows.run(c0 + j));
        const float* vr = rows.v + rows.off(c0 + j) + h * DH + 2 * lane;
        for (; j < end; ++j, vr += rows.hd) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          const float2 vv = *reinterpret_cast<const float2*>(vr);
          st.acc.x += pj * vv.x;
          st.acc.y += pj * vv.y;
        }
      }
    }
    st.m = m_new;
  }
}

// Single-query attention of q_s [h, DH] (pre-scaled) against the first
// n_valid rows of one sequence's cache; one warp per head, the heads
// dealt round-robin to the NT / 32 warps of the block.  ctx_s [h, DH];
// n_valid == 0 gives 0 (the TPU kernels' l_safe).
template <int NT, class Rows>
__device__ void walk(const Rows& rows, int n_valid, int n_head,
                     const float* q_s, float* ctx_s) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  for (int h = threadIdx.x >> 5; h < n_head; h += NW) {
    WalkState st = walk_start();
    walk_rows(rows, h, q_s + h * DH, n_valid, 0, 32, st);
    const float inv = 1.f / (st.l == 0.f ? 1.f : st.l);
    ctx_s[h * DH + 2 * lane] = st.acc.x * inv;
    ctx_s[h * DH + 2 * lane + 1] = st.acc.y * inv;
  }
  __syncthreads();
}

}  // namespace ptt
