// Fused-projection flash attention, forward only, f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/attention.py _qkv_fwd_kernel (the Pallas
// kernel behind flash_qkv_attention).  Computes, for one sequence,
//
//   y = sum_h softmax((x Wq_h)(x Wk_h)^T * scale + bias) (x Wv_h) Wout_h
//
// without q, k or v ever reaching device memory: each block projects its
// q tile and, for every key tile it walks, the k and v tiles straight into
// shared memory, runs the online softmax and writes its head's context.
// One GEMM of gemm.cuh then gives y = ctx W_out.
//
// Grid: (ceil(t / 64) query tiles, n_head, batch); 256 threads; every
// thread owns a 4x4 patch of each 64x64 tile.  The TPU kernel walks all
// heads inside one grid step and sums y in VMEM; here the heads run in
// parallel blocks, and the GEMM sums over them in a fixed order, so y is
// the same bits on every run.  (Atomic adds of each head's share into y
// would vary in the last bits; 12 layers deep, that moves the training
// step's gradients by up to 2x their distance to float64.)
//
// Bound: f32 FMA work (no tensor cores: the run is f32 with TF32 off).
// Cost accepted by this first kernel: the k/v tiles of a head are
// projected again by every query tile of that head, t/64 times in all
// (4 times at t = 256), which the TPU kernel's 512-row tiles avoid.
//
// Weights dropout, as in the bthd forward (flash_attention.cu): l sums
// the undropped p, the p tile multiplying v is dropped by
// hash_rng::keep_attn at (seed, b * n_head + head, q * t + k), the same
// bits #4 draws for that element, and ctx is scaled by 1 / (1 - rate).
// At rate 0 the entry point launches the instantiation that never hashes.
//
// Masking follows the TPU kernel: causal and out-of-range keys score
// -1e30; a query row with l == 0 or max <= -1e29 gets a zero context.
//
// The context ctx [b, t, h, 64] and lse [b, h, t] (+inf on a masked row)
// are the residuals the backward kernels (#2, #3 in qkv_attention_bwd.cu)
// read, as the TPU kernel always returns them; serving passes scratch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"
#include "hash_rng.cuh"

namespace {

using hash_rng::Dropout;

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per walk step
constexpr int DH = 64;       // head width
constexpr int KC = 32;       // reduction chunk of the projections
constexpr int NT = 256;      // threads per block
constexpr int AS = KC + 1;   // row stride of the activation tile
constexpr int QS = DH + 1;   // row stride of q / p tiles
constexpr int TS = DH + 4;   // row stride of k^T / v tiles (float4 rows)
constexpr float kMaskValue = -1e30f;

// shared-memory layout, in floats
constexpr int kAOff = 0;                       // x tile      [BQ][AS]
constexpr int kBOff = kAOff + BQ * AS;         // two w tiles [2][KC][DH]
constexpr int kQOff = kBOff + 2 * KC * DH;     // q           [BQ][QS]
constexpr int kKOff = kQOff + BQ * QS;         // k^T         [DH][TS]
constexpr int kVOff = kKOff + DH * TS;         // v           [BK][TS]
constexpr int kPOff = kVOff + BK * TS;         // p           [BQ][QS]
constexpr int kSmemFloats = kPOff + BQ * QS;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

// Load the activation tile x[rows r0.., cols k0..k0+KC) (zero past t).
__device__ __forceinline__ void load_x_tile(float* a_s, const float* xb,
                                            int r0, int t, int dm,
                                            int k0) {
  for (int idx = threadIdx.x; idx < BQ * (KC / 4); idx += NT) {
    int row = idx / (KC / 4);
    int c4 = idx % (KC / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < t)
      v = *reinterpret_cast<const float4*>(xb + (size_t)(r0 + row) * dm +
                                           k0 + c4 * 4);
    float* dst = a_s + row * AS + c4 * 4;
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
}

// Load the weight tile w[k0..k0+KC, col0..col0+DH) with row stride ldw.
__device__ __forceinline__ void load_w_tile(float* b_s, const float* w,
                                            int ldw, int k0, int col0) {
  for (int idx = threadIdx.x; idx < KC * (DH / 4); idx += NT) {
    int row = idx / (DH / 4);
    int c4 = idx % (DH / 4);
    *reinterpret_cast<float4*>(b_s + row * DH + c4 * 4) =
        *reinterpret_cast<const float4*>(w + (size_t)(k0 + row) * ldw +
                                         col0 + c4 * 4);
  }
}

template <bool DROP>
__global__ void __launch_bounds__(NT)
qkv_attention_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ w_qkv,
                         const float* __restrict__ bias,
                         int64_t bs_b, int64_t bs_h, int64_t bs_q,
                         int64_t bs_k, float* ctx, float* lse,
                         int t, int dm, int n_head, float scale,
                         int causal, Dropout drop) {
  extern __shared__ float smem[];
  float* a_s = smem + kAOff;
  float* b_s = smem + kBOff;
  float* q_s = smem + kQOff;
  float* kt_s = smem + kKOff;
  float* v_s = smem + kVOff;
  float* p_s = smem + kPOff;

  const int qt = blockIdx.x;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of every tile
  const int tx = tid % 16;  // cols tx*4 .. tx*4+3 of every tile
  const int hd = n_head * DH;
  const int ldw = 3 * hd;
  const int q0 = qt * BQ;
  const float* xb = x + (size_t)bi * t * dm;
  const uint32_t hseed =
      DROP ? hash_rng::attn_head_seed(drop.seed, (uint32_t)(bi * n_head + head))
           : 0u;

  // ---- q tile: (x[q0:q0+BQ] @ Wq_h) * scale ---------------------------
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < dm; k0 += KC) {
    load_x_tile(a_s, xb, q0, t, dm, k0);
    load_w_tile(b_s, w_qkv, ldw, k0, head * DH);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float4 bv = *reinterpret_cast<const float4*>(b_s + kk * DH + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float av = a_s[(ty * 4 + i) * AS + kk];
        acc[i][0] += av * bv.x; acc[i][1] += av * bv.y;
        acc[i][2] += av * bv.z; acc[i][3] += av * bv.w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q_s[(ty * 4 + i) * QS + tx * 4 + j] = acc[i][j] * scale;

  // ---- online-softmax walk over key tiles -----------------------------
  float m[4], l[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }
  int n_kv = (t + BK - 1) / BK;
  if (causal) {
    int last = min(q0 + BQ, t) - 1;
    n_kv = min(n_kv, last / BK + 1);
  }
  const float* bias_row = bias ? bias + bi * bs_b + head * bs_h : nullptr;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0r = kt * BK;
    // project this key tile's k and v into shared memory
    float ka[4][4], va[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { ka[i][j] = 0.f; va[i][j] = 0.f; }
    for (int k0 = 0; k0 < dm; k0 += KC) {
      load_x_tile(a_s, xb, k0r, t, dm, k0);
      load_w_tile(b_s, w_qkv, ldw, k0, hd + head * DH);
      load_w_tile(b_s + KC * DH, w_qkv, ldw, k0, 2 * hd + head * DH);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float4 bk = *reinterpret_cast<const float4*>(b_s + kk * DH + tx * 4);
        float4 bv = *reinterpret_cast<const float4*>(b_s + KC * DH +
                                                     kk * DH + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float av = a_s[(ty * 4 + i) * AS + kk];
          ka[i][0] += av * bk.x; ka[i][1] += av * bk.y;
          ka[i][2] += av * bk.z; ka[i][3] += av * bk.w;
          va[i][0] += av * bv.x; va[i][1] += av * bv.y;
          va[i][2] += av * bv.z; va[i][3] += av * bv.w;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kt_s[(tx * 4 + j) * TS + ty * 4 + i] = ka[i][j];
      *reinterpret_cast<float4*>(v_s + (ty * 4 + i) * TS + tx * 4) =
          make_float4(va[i][0], va[i][1], va[i][2], va[i][3]);
    }
    __syncthreads();

    // scores s = q k^T (+ bias, masks) for this thread's 4x4 patch
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float4 kv = *reinterpret_cast<const float4*>(kt_s + d * TS + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float qv = q_s[(ty * 4 + i) * QS + d];
        s[i][0] += qv * kv.x; s[i][1] += qv * kv.y;
        s[i][2] += qv * kv.z; s[i][3] += qv * kv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0r + tx * 4 + j;
        if (kpos >= t || (causal && kpos > qpos)) {
          s[i][j] = kMaskValue;
        } else if (bias_row) {
          s[i][j] += bias_row[min(qpos, t - 1) * bs_q + kpos * bs_k];
        }
      }
    }
    // row max / sum across the 16 threads that share a row group
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[i][j] *= alpha;
        float pv = s[i][j];
        if (DROP && !hash_rng::keep_attn(
                hseed, (uint32_t)qpos * t + k0r + tx * 4 + j,
                drop.threshold))
          pv = 0.f;
        p_s[(ty * 4 + i) * QS + tx * 4 + j] = pv;
      }
    }
    __syncthreads();
    // o += p @ v
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float4 vv = *reinterpret_cast<const float4*>(v_s + kk * TS + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float pv = p_s[(ty * 4 + i) * QS + kk];
        o[i][0] += pv * vv.x; o[i][1] += pv * vv.y;
        o[i][2] += pv * vv.z; o[i][3] += pv * vv.w;
      }
    }
    __syncthreads();
  }

  // ---- context (masked rows give 0) and lse ---------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool masked = (l[i] == 0.f) || (m[i] <= -1e29f);
    const float inv = masked ? 0.f
                             : (DROP ? drop.inv_keep / l[i] : 1.f / l[i]);
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= t) continue;
    *reinterpret_cast<float4*>(ctx + ((size_t)bi * t + qpos) * hd +
                               head * DH + tx * 4) =
        make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv,
                    o[i][3] * inv);
    if (tx == 0)
      lse[((size_t)bi * n_head + head) * t + qpos] =
          masked ? INFINITY : m[i] + logf(l[i]);
  }
}

template <bool DROP>
cudaError_t launch_fwd(const float* x, const float* w_qkv, const float* w_out,
                       const float* bias, int64_t bs_b, int64_t bs_h,
                       int64_t bs_q, int64_t bs_k, float* y, float* ctx,
                       float* lse, float* partials, int b, int t, int dm,
                       int n_head, float scale, int causal, Dropout drop,
                       cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        qkv_attention_fwd_kernel<DROP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((t + BQ - 1) / BQ, n_head, b);
  qkv_attention_fwd_kernel<DROP><<<grid, NT, kSmemBytes, stream>>>(
      x, w_qkv, bias, bs_b, bs_h, bs_q, bs_k, ctx, lse, t, dm, n_head,
      scale, causal, drop);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hd = n_head * DH;  // y [b*t, dm] = ctx [b*t, hd] W_out [hd, dm]
  return gemm({ctx, hd, false}, {w_out, dm, true}, y, dm, b * t, dm, hd,
              true, partials, stream);
}

}  // namespace

// Floats of the `partials` buffer ptt_qkv_attention_fwd needs at this
// shape (0: pass null).
extern "C" int64_t ptt_qkv_fwd_scratch(int b, int t, int dm, int n_head) {
  return gemm_partials(b * t, dm, n_head * DH);
}

// bias may be null; otherwise its element (b, h, q, k) lies at
// b*bs_b + h*bs_h + q*bs_q + k*bs_k.  Writes ctx [b, t, h, 64], lse
// [b, h, t] and y [b, t, dm]; partials holds ptt_qkv_fwd_scratch floats.
// Requires d_head == 64 and dm % 32 == 0 (checked by the caller).  rate 0
// runs without dropout; otherwise weights are kept where the hash of
// (seed, b*n_head + head, q*t + k) >= threshold (t*t <= 2^32, checked by
// the caller).
extern "C" int ptt_qkv_attention_fwd(const float* x, const float* w_qkv,
                                     const float* w_out, const float* bias,
                                     int64_t bs_b, int64_t bs_h,
                                     int64_t bs_q, int64_t bs_k, float* y,
                                     float* ctx, float* lse, float* partials,
                                     int b, int t, int dm, int n_head,
                                     float scale, int causal, double rate,
                                     unsigned seed, unsigned threshold,
                                     void* stream) {
  const Dropout drop = hash_rng::make_dropout(rate, seed, threshold);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(drop.on
      ? launch_fwd<true>(x, w_qkv, w_out, bias, bs_b, bs_h, bs_q, bs_k, y,
                         ctx, lse, partials, b, t, dm, n_head, scale, causal,
                         drop, st)
      : launch_fwd<false>(x, w_qkv, w_out, bias, bs_b, bs_h, bs_q, bs_k, y,
                          ctx, lse, partials, b, t, dm, n_head, scale,
                          causal, drop, st));
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
