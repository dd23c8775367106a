// Flash-decode: single-query attention over a ring cache or a paged block
// pool, f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/decode_attention.py _decode_kernel (ring)
// and _paged_decode_kernel (paged): q [b, h, 64] against the first
// lengths[b] rows of one layer's cache, k/v [b, max_t, h, 64] or pools
// [num_blocks, block_t, h, 64] addressed through table [b, max_blocks].
// The walk is the megastep's (common.cuh); only the grid differs.
//
// Grid: one block per (head, sequence).  The TPU kernel takes one grid
// step per sequence and all heads at once; here that would fill one SM per
// sequence (8 of 132 at b = 1 even with one block per head).  Inside the
// block the 4 warps split the rows: warp w takes the 32-row steps
// w, w + 4, w + 8, ... and the four online-softmax states are merged in
// shared memory at the end.  A paged block first copies its sequence's
// table row into shared memory.  A sequence with length 0 gets a zero
// context, as the TPU kernels give (their l_safe).
//
// Bound: bytes.  Each block reads its head's slice of the valid rows
// once; q and the output are one row each.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using ptt::DH;

constexpr int NT = 128;
constexpr int NW = NT / 32;

// The block's head h of sequence i: walk, merge the warps' states, write
// out [DH].  q is pre-scaled in q_s.
template <class Rows>
__device__ void decode_head(const Rows& rows, int n_valid, int h,
                            const float* q_s, float* out) {
  __shared__ float m_s[NW];
  __shared__ float l_s[NW];
  __shared__ float acc_s[NW * DH];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  ptt::WalkState st = ptt::walk_start();
  ptt::walk_rows(rows, h, q_s, n_valid, 32 * warp, 32 * NW, st);
  if (lane == 0) {
    m_s[warp] = st.m;
    l_s[warp] = st.l;
  }
  acc_s[warp * DH + 2 * lane] = st.acc.x;
  acc_s[warp * DH + 2 * lane + 1] = st.acc.y;
  __syncthreads();
  if (threadIdx.x < DH) {
    float o = 0.f;
    if (n_valid > 0) {
      // a warp that walked no rows has m = -inf and weight exp(-inf) = 0
      float m = -INFINITY;
      for (int w = 0; w < NW; ++w) m = fmaxf(m, m_s[w]);
      float l = 0.f;
      for (int w = 0; w < NW; ++w) {
        const float a = expf(m_s[w] - m);
        l += l_s[w] * a;
        o += acc_s[w * DH + threadIdx.x] * a;
      }
      o /= l;
    }
    out[threadIdx.x] = o;
  }
}

__global__ void __launch_bounds__(NT)
flash_decode_kernel(const float* __restrict__ q, const float* k,
                    const float* v, const int* __restrict__ lengths,
                    float* __restrict__ out, int max_t, int n_head,
                    float scale) {
  __shared__ float q_s[DH];
  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const int hd = n_head * DH;
  const size_t head = ((size_t)i * n_head + h) * DH;
  if (threadIdx.x < DH) q_s[threadIdx.x] = q[head + threadIdx.x] * scale;
  __syncthreads();
  const size_t base = (size_t)i * max_t * hd;
  decode_head(ptt::RingRows{k + base, v + base, hd},
              min(max(lengths[i], 0), max_t), h, q_s, out + head);
}

__global__ void __launch_bounds__(NT)
flash_decode_paged_kernel(const float* __restrict__ q, const float* k_pool,
                          const float* v_pool, const int* __restrict__ table,
                          const int* __restrict__ lengths,
                          float* __restrict__ out, int n_head, int block_t,
                          int max_blocks, float scale) {
  extern __shared__ int tab_s[];  // [max_blocks]
  __shared__ float q_s[DH];
  const int h = blockIdx.x;
  const int i = blockIdx.y;
  const int hd = n_head * DH;
  const size_t head = ((size_t)i * n_head + h) * DH;
  if (threadIdx.x < DH) q_s[threadIdx.x] = q[head + threadIdx.x] * scale;
  for (int j = threadIdx.x; j < max_blocks; j += NT)
    tab_s[j] = table[(size_t)i * max_blocks + j];
  __syncthreads();
  decode_head(ptt::PagedRows{k_pool, v_pool, tab_s, 0, block_t, hd},
              min(max(lengths[i], 0), max_blocks * block_t), h, q_s,
              out + head);
}

}  // namespace

// q/out [b, n_head, 64]; k/v [b, max_t, n_head, 64]; lengths [b] int32.
extern "C" int ptt_flash_decode(const float* q, const float* k,
                                const float* v, const int* lengths,
                                float* out, int batch, int max_t, int n_head,
                                float scale, void* stream) {
  flash_decode_kernel<<<dim3(n_head, batch), NT, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      q, k, v, lengths, out, max_t, n_head, scale);
  return (int)cudaGetLastError();
}

// q/out [b, n_head, 64]; pools [num_blocks, block_t, n_head, 64] (one
// layer's slice); table [b, max_blocks] int32 pool block ids; lengths [b].
extern "C" int ptt_flash_decode_paged(const float* q, const float* k_pool,
                                      const float* v_pool, const int* table,
                                      const int* lengths, float* out,
                                      int batch, int n_head, int block_t,
                                      int max_blocks, float scale,
                                      void* stream) {
  flash_decode_paged_kernel<<<dim3(n_head, batch), NT,
                              sizeof(int) * max_blocks,
                              static_cast<cudaStream_t>(stream)>>>(
      q, k_pool, v_pool, table, lengths, out, n_head, block_t, max_blocks,
      scale);
  return (int)cudaGetLastError();
}
