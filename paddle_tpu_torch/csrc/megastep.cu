// Decode megastep: one decoder layer's attention half for one token, f32,
// for sm_90a.
//
// Replaces paddle_tpu/kernels/decode_step.py _megastep_kernel (in its
// split-FFN mode; the feed-forward runs next, in ffn.cu).  One block per
// sequence, as one grid step per sequence on the TPU:
//
//   1. q, k, v = x @ Wqkv (packed q|k|v columns), q pre-scaled;
//   2. the k/v row is written IN PLACE into the ring cache
//      [L, b, max_t, h, dh] at row pos, for active lanes only;
//   3. online-softmax walk over the first `lengths` rows of the self
//      cache, which includes the row just written;
//   4. x1 = LN1(x + ctx @ Wout);
//   5. cq = x1 @ Wcq, walk over the first `cross_lengths` rows of the
//      cross cache;
//   6. out = LN2(x1 + cctx @ Wcout).
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

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int DH = 64;
constexpr float kMaskValue = -1e30f;

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

// Single-query attention of q_s [h, DH] (pre-scaled) against the first
// n_valid rows of one sequence's cache slice kc/vc [max_t, h, DH]; one
// warp per head, 32 rows per online-softmax step, lane j scoring row
// c0 + j and owning context dims 2j, 2j + 1.  n_valid == 0 gives 0.
__device__ void walk(const float* kc, const float* vc, int n_valid,
                     int n_head, const float* q_s, float* ctx_s) {
  const int lane = threadIdx.x & 31;
  const int hd = n_head * DH;
  for (int h = threadIdx.x >> 5; h < n_head; h += NW) {
    const float* qh = q_s + h * DH;
    float m = -INFINITY, l = 0.f;
    float2 acc = make_float2(0.f, 0.f);
    for (int c0 = 0; c0 < n_valid; c0 += 32) {
      const int r = c0 + lane;
      float s = kMaskValue;
      if (r < n_valid) {
        const float4* kr =
            reinterpret_cast<const float4*>(kc + (size_t)r * hd + h * DH);
        s = 0.f;
#pragma unroll
        for (int u = 0; u < DH / 4; ++u) {
          const float4 kv = kr[u];
          s += qh[4 * u] * kv.x + qh[4 * u + 1] * kv.y +
               qh[4 * u + 2] * kv.z + qh[4 * u + 3] * kv.w;
        }
      }
      const float m_new = fmaxf(m, ptt::warp_max(s));
      const float p = expf(s - m_new);
      const float alpha = expf(m - m_new);
      l = l * alpha + ptt::warp_sum(p);
      acc.x *= alpha;
      acc.y *= alpha;
      const int nr = min(32, n_valid - c0);
      for (int j = 0; j < nr; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float2 vv = *reinterpret_cast<const float2*>(
            vc + (size_t)(c0 + j) * hd + h * DH + 2 * lane);
        acc.x += pj * vv.x;
        acc.y += pj * vv.y;
      }
      m = m_new;
    }
    const float inv = 1.f / (l == 0.f ? 1.f : l);
    ctx_s[h * DH + 2 * lane] = acc.x * inv;
    ctx_s[h * DH + 2 * lane + 1] = acc.y * inv;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT)
megastep_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                const float* __restrict__ wout,
                const float* __restrict__ ln1s,
                const float* __restrict__ ln1b,
                const float* __restrict__ wcq,
                const float* __restrict__ wcout,
                const float* __restrict__ ln2s,
                const float* __restrict__ ln2b, float* cache_k,
                float* cache_v, const float* cross_k, const float* cross_v,
                const int* __restrict__ pos, const int* __restrict__ lengths,
                const int* __restrict__ cross_lengths,
                const int* __restrict__ active, float* out, int layer,
                int batch, int dm, int n_head, int max_t, int cross_t,
                float scale, float eps) {
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
  float* part_s = red_s + 32;         // [max(4 * NT, wide)]

  const int i = blockIdx.x;
  for (int j = threadIdx.x; j < dm; j += NT) x0_s[j] = x[(size_t)i * dm + j];
  __syncthreads();

  // 1. fused qkv projection (columns [0, hd) are q, then k, then v)
  block_matvec(x0_s, wqkv, 3 * hd, dm, hd, q_s, part_s, scale);
  block_matvec(x0_s, wqkv + hd, 3 * hd, dm, hd, k_s, part_s, 1.f);
  block_matvec(x0_s, wqkv + 2 * hd, 3 * hd, dm, hd, v_s, part_s, 1.f);

  // 2. in-place row write (a 1-row dynamic_update_slice clamps its start)
  const size_t self_base = ((size_t)layer * batch + i) * max_t * hd;
  if (active[i] != 0) {
    const int p = min(max(pos[i], 0), max_t - 1);
    float* krow = cache_k + self_base + (size_t)p * hd;
    float* vrow = cache_v + self_base + (size_t)p * hd;
    for (int n = threadIdx.x; n < hd; n += NT) {
      krow[n] = k_s[n];
      vrow[n] = v_s[n];
    }
  }
  __syncthreads();  // the row is visible to the whole block from here on

  // 3. self-attention walk, 4. output projection + residual + LN1
  const int n_self = min(max(lengths[i], 0), max_t);
  walk(cache_k + self_base, cache_v + self_base, n_self, n_head, q_s,
       ctx_s);
  block_matvec(ctx_s, wout, dm, hd, dm, y_s, part_s, 1.f);
  residual_layer_norm(x0_s, y_s, ln1s, ln1b, dm, eps, x1_s, red_s);

  // 5. cross-attention walk over the prefilled cache
  block_matvec(x1_s, wcq, hd, dm, hd, q_s, part_s, scale);
  const size_t cross_base = ((size_t)layer * batch + i) * cross_t * hd;
  const int n_cross = min(max(cross_lengths[i], 0), cross_t);
  walk(cross_k + cross_base, cross_v + cross_base, n_cross, n_head, q_s,
       ctx_s);

  // 6. output projection + residual + LN2, straight to device memory
  block_matvec(ctx_s, wcout, dm, hd, dm, y_s, part_s, 1.f);
  residual_layer_norm(x1_s, y_s, ln2s, ln2b, dm, eps, out + (size_t)i * dm,
                      red_s);
}

// Shared memory the megastep needs for these widths, in bytes.
int megastep_smem_bytes(int dm, int n_head) {
  const int hd = n_head * DH;
  const int wide = dm > hd ? dm : hd;
  const int part = 4 * NT > wide ? 4 * NT : wide;
  return (int)(sizeof(float) * (2 * dm + 4 * hd + wide + 32 + part));
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
  const int smem = megastep_smem_bytes(dm, n_head);
  static int configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        megastep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  megastep_kernel<<<batch, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, wqkv, wout, ln1s, ln1b, wcq, wcout, ln2s, ln2b, cache_k, cache_v,
      cross_k, cross_v, pos, lengths, cross_lengths, active, out, layer,
      batch, dm, n_head, max_t, cross_t, scale, eps);
  return (int)cudaGetLastError();
}
