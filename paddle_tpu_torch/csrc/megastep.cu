// Decode megastep: one decoder layer's attention half for one token, f32,
// for sm_90a, over ring caches or over paged block pools.
//
// Replaces paddle_tpu/kernels/decode_step.py _megastep_kernel (ring) and
// _paged_megastep_kernel (paged), each in its split-FFN mode; the
// feed-forward runs next, in ffn.cu.  One block per sequence, as one grid
// step per sequence on the TPU:
//
//   1. q, k, v = x @ Wqkv (packed q|k|v columns), q pre-scaled;
//   2. the k/v row is written IN PLACE into the self cache at row pos, for
//      active lanes only;
//   3. online-softmax walk over the first `lengths` rows of the self
//      cache, which includes the row just written;
//   4. x1 = LN1(x + ctx @ Wout);
//   5. cq = x1 @ Wcq, walk over the first `cross_lengths` rows of the
//      cross cache;
//   6. out = LN2(x1 + cctx @ Wcout).
//
// The two layouts differ only in where a row lives (common.cuh RingRows,
// PagedRows) and in the row write of step 2: the ring clamps pos into
// [0, max_t) as a 1-row dynamic_update_slice does; the paged write drops a
// row at or past max_blocks * block_t, as the reference's composition
// (paged_scatter_rows) does.  A paged block first copies its two table
// rows into shared memory.
//
// The fresh row reaches the walk through device memory: the threads that
// computed it store it, then __syncthreads() makes every global store of
// the block visible to every thread of the block, and the walk reads the
// cache with ordinary (coherent) loads, never the read-only path.
//
// Bound: bytes.  Each block streams the 6 h*dh x d_model weight matrices
// (6.3 MB at Transformer-base widths) and its cache prefix; q, k, v, the
// contexts and the normalized activations stay in shared memory.  One block
// per sequence reads the weights once per sequence and fills 1 of 132 SMs
// at batch 1, where a decode step's 6 layers do not fit the L2 and that one
// SM streams them from HBM: accepted for this first kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using ptt::DH;

constexpr int NT = 256;

// out_s[n] = mul * sum_k x_s[k] * W[k * ldw + n] for n < N (N % 4 == 0).
// Threads split the columns in float4s and, where there are threads to
// spare, K into `groups` slices summed in a fixed order afterwards.
__device__ void block_matvec(const float* x_s, const float* __restrict__ W,
                             int ldw, int K, int N, float* out_s,
                             float* part_s, float mul) {
  const int n4 = N >> 2;
  const int groups = n4 >= NT ? 1 : NT / n4;
  const int kspan = (K + groups - 1) / groups;
  for (int u = threadIdx.x; u < n4 * groups; u += NT) {
    const int c4 = u % n4;
    const int g = u / n4;
    const int k_lo = g * kspan;
    const int k_hi = min(K, k_lo + kspan);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* wp = W + (size_t)k_lo * ldw + c4 * 4;
#pragma unroll 8
    for (int k = k_lo; k < k_hi; ++k, wp += ldw) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wp));
      const float xv = x_s[k];
      acc.x += xv * w.x; acc.y += xv * w.y;
      acc.z += xv * w.z; acc.w += xv * w.w;
    }
    *reinterpret_cast<float4*>(part_s + g * N + c4 * 4) = acc;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += NT) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part_s[g * N + n];
    out_s[n] = s * mul;
  }
  __syncthreads();
}

// dst = LN(a + r) * scale + bias over n features, statistics in f32.
__device__ void residual_layer_norm(const float* a_s, const float* r_s,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ bias, int n,
                                    float eps, float* dst, float* red_s) {
  float local = 0.f;
  for (int j = threadIdx.x; j < n; j += NT) local += a_s[j] + r_s[j];
  const float mean = ptt::block_sum<NT>(local, red_s) / n;
  local = 0.f;
  for (int j = threadIdx.x; j < n; j += NT) {
    const float d = a_s[j] + r_s[j] - mean;
    local += d * d;
  }
  const float var = ptt::block_sum<NT>(local, red_s) / n;
  const float rstd = rsqrtf(var + eps);
  for (int j = threadIdx.x; j < n; j += NT)
    dst[j] = (a_s[j] + r_s[j] - mean) * rstd * scale[j] + bias[j];
  __syncthreads();
}

// The self and cross caches of one launch.  Ring: [L, b, rows, h, DH] with
// rows = max_t (self) and cross_t (cross); the tables are unused.  Paged:
// pools [L, nb, bt, h, DH] and tables [b, rows] with rows = max_blocks.
struct Caches {
  float* self_k;
  float* self_v;
  const float* cross_k;
  const float* cross_v;
  const int* self_tab;
  const int* cross_tab;
  int self_rows, cross_rows;
  int self_nb, cross_nb;
  int self_bt, cross_bt;
};

template <bool PAGED>
__global__ void __launch_bounds__(NT)
megastep_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                const float* __restrict__ wout,
                const float* __restrict__ ln1s,
                const float* __restrict__ ln1b,
                const float* __restrict__ wcq,
                const float* __restrict__ wcout,
                const float* __restrict__ ln2s,
                const float* __restrict__ ln2b, Caches c,
                const int* __restrict__ pos, const int* __restrict__ lengths,
                const int* __restrict__ cross_lengths,
                const int* __restrict__ active, float* out, int layer,
                int batch, int dm, int n_head, int part_len, float scale,
                float eps) {
  extern __shared__ float smem[];
  const int hd = n_head * DH;
  const int wide = max(dm, hd);
  float* x0_s = smem;                 // [dm]
  float* x1_s = x0_s + dm;            // [dm]
  float* q_s = x1_s + dm;             // [hd]
  float* k_s = q_s + hd;              // [hd]
  float* v_s = k_s + hd;              // [hd]
  float* ctx_s = v_s + hd;            // [hd]
  float* y_s = ctx_s + hd;            // [wide]
  float* red_s = y_s + wide;          // [32]
  float* part_s = red_s + 32;         // [part_len]
  int* stab_s = reinterpret_cast<int*>(part_s + part_len);  // paged only
  int* ctab_s = stab_s + c.self_rows;

  const int i = blockIdx.x;
  for (int j = threadIdx.x; j < dm; j += NT) x0_s[j] = x[(size_t)i * dm + j];
  if constexpr (PAGED) {
    for (int j = threadIdx.x; j < c.self_rows; j += NT)
      stab_s[j] = c.self_tab[(size_t)i * c.self_rows + j];
    for (int j = threadIdx.x; j < c.cross_rows; j += NT)
      ctab_s[j] = c.cross_tab[(size_t)i * c.cross_rows + j];
  }
  __syncthreads();

  // 1. fused qkv projection (columns [0, hd) are q, then k, then v)
  block_matvec(x0_s, wqkv, 3 * hd, dm, hd, q_s, part_s, scale);
  block_matvec(x0_s, wqkv + hd, 3 * hd, dm, hd, k_s, part_s, 1.f);
  block_matvec(x0_s, wqkv + 2 * hd, 3 * hd, dm, hd, v_s, part_s, 1.f);

  // 2. in-place row write
  const int p = pos[i];
  int n_self;
  size_t row = 0;
  bool write = active[i] != 0;
  if constexpr (PAGED) {
    const int logical = c.self_rows * c.self_bt;
    write = write && p >= 0 && p < logical;
    if (write)
      row = (((size_t)layer * c.self_nb + stab_s[p / c.self_bt]) * c.self_bt +
             p % c.self_bt) * hd;
    n_self = min(max(lengths[i], 0), logical);
  } else {
    const size_t base = ((size_t)layer * batch + i) * c.self_rows * hd;
    row = base + (size_t)min(max(p, 0), c.self_rows - 1) * hd;
    n_self = min(max(lengths[i], 0), c.self_rows);
  }
  if (write) {
    for (int n = threadIdx.x; n < hd; n += NT) {
      c.self_k[row + n] = k_s[n];
      c.self_v[row + n] = v_s[n];
    }
  }
  __syncthreads();  // the row is visible to the whole block from here on

  // 3. self-attention walk, 4. output projection + residual + LN1
  if constexpr (PAGED) {
    ptt::walk<NT>(ptt::PagedRows{c.self_k, c.self_v, stab_s,
                                 (size_t)layer * c.self_nb, c.self_bt, hd},
                  n_self, n_head, q_s, ctx_s);
  } else {
    const size_t base = ((size_t)layer * batch + i) * c.self_rows * hd;
    ptt::walk<NT>(ptt::RingRows{c.self_k + base, c.self_v + base, hd},
                  n_self, n_head, q_s, ctx_s);
  }
  block_matvec(ctx_s, wout, dm, hd, dm, y_s, part_s, 1.f);
  residual_layer_norm(x0_s, y_s, ln1s, ln1b, dm, eps, x1_s, red_s);

  // 5. cross-attention walk over the prefilled cache
  block_matvec(x1_s, wcq, hd, dm, hd, q_s, part_s, scale);
  if constexpr (PAGED) {
    const int n_cross =
        min(max(cross_lengths[i], 0), c.cross_rows * c.cross_bt);
    ptt::walk<NT>(ptt::PagedRows{c.cross_k, c.cross_v, ctab_s,
                                 (size_t)layer * c.cross_nb, c.cross_bt, hd},
                  n_cross, n_head, q_s, ctx_s);
  } else {
    const size_t base = ((size_t)layer * batch + i) * c.cross_rows * hd;
    const int n_cross = min(max(cross_lengths[i], 0), c.cross_rows);
    ptt::walk<NT>(ptt::RingRows{c.cross_k + base, c.cross_v + base, hd},
                  n_cross, n_head, q_s, ctx_s);
  }

  // 6. output projection + residual + LN2, straight to device memory
  block_matvec(ctx_s, wcout, dm, hd, dm, y_s, part_s, 1.f);
  residual_layer_norm(x1_s, y_s, ln2s, ln2b, dm, eps, out + (size_t)i * dm,
                      red_s);
}

// Launch megastep_kernel<PAGED>: shared memory for these widths (and, when
// paged, the two table rows), raised past 48 KB where needed.
template <bool PAGED>
int launch(const float* x, const float* wqkv, const float* wout,
           const float* ln1s, const float* ln1b, const float* wcq,
           const float* wcout, const float* ln2s, const float* ln2b,
           const Caches& c, const int* pos, const int* lengths,
           const int* cross_lengths, const int* active, float* out,
           int layer, int batch, int dm, int n_head, float scale, float eps,
           void* stream) {
  const int hd = n_head * DH;
  const int wide = dm > hd ? dm : hd;
  const int part = 4 * NT > wide ? 4 * NT : wide;
  const int tables = PAGED ? c.self_rows + c.cross_rows : 0;
  const int smem =
      (int)(sizeof(float) * (2 * dm + 4 * hd + wide + 32 + part) +
            sizeof(int) * tables);
  static int configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        megastep_kernel<PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  megastep_kernel<PAGED>
      <<<batch, NT, smem, static_cast<cudaStream_t>(stream)>>>(
          x, wqkv, wout, ln1s, ln1b, wcq, wcout, ln2s, ln2b, c, pos, lengths,
          cross_lengths, active, out, layer, batch, dm, n_head, part, scale,
          eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x/out [b, dm]; caches [L, b, max_t|cross_t, n_head, 64]; the int32
// vectors are [b].  cache_k/cache_v are updated in place.
extern "C" int ptt_megastep(const float* x, const float* wqkv,
                            const float* wout, const float* ln1s,
                            const float* ln1b, const float* wcq,
                            const float* wcout, const float* ln2s,
                            const float* ln2b, float* cache_k,
                            float* cache_v, const float* cross_k,
                            const float* cross_v, const int* pos,
                            const int* lengths, const int* cross_lengths,
                            const int* active, float* out, int layer,
                            int batch, int dm, int n_head, int max_t,
                            int cross_t, float scale, float eps,
                            void* stream) {
  const Caches c{cache_k, cache_v, cross_k, cross_v, nullptr, nullptr,
                 max_t,   cross_t, 0,       0,       0,       0};
  return launch<false>(x, wqkv, wout, ln1s, ln1b, wcq, wcout, ln2s, ln2b, c,
                       pos, lengths, cross_lengths, active, out, layer,
                       batch, dm, n_head, scale, eps, stream);
}

// x/out [b, dm]; pools [L, num_blocks, block_t, n_head, 64] (self) and
// [L, cross_num_blocks, cross_block_t, n_head, 64] (cross); tables
// [b, max_blocks] and [b, cross_max_blocks] of pool block ids; the int32
// vectors are [b].  pool_k/pool_v are updated in place.
extern "C" int ptt_megastep_paged(
    const float* x, const float* wqkv, const float* wout, const float* ln1s,
    const float* ln1b, const float* wcq, const float* wcout,
    const float* ln2s, const float* ln2b, float* pool_k, float* pool_v,
    const float* cross_k, const float* cross_v, const int* pos,
    const int* lengths, const int* cross_lengths, const int* self_table,
    const int* cross_table, const int* active, float* out, int layer,
    int batch, int dm, int n_head, int num_blocks, int block_t,
    int max_blocks, int cross_num_blocks, int cross_block_t,
    int cross_max_blocks, float scale, float eps, void* stream) {
  const Caches c{pool_k,     pool_v,           cross_k,    cross_v,
                 self_table, cross_table,      max_blocks, cross_max_blocks,
                 num_blocks, cross_num_blocks, block_t,    cross_block_t};
  return launch<true>(x, wqkv, wout, ln1s, ln1b, wcq, wcout, ln2s, ln2b, c,
                      pos, lengths, cross_lengths, active, out, layer, batch,
                      dm, n_head, scale, eps, stream);
}
