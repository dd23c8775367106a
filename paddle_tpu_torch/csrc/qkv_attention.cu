// Fused-projection flash attention, forward only, f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/attention.py _qkv_fwd_kernel (the Pallas
// kernel behind flash_qkv_attention).  Computes, for one sequence,
//
//   y = sum_h softmax((x Wq_h)(x Wk_h)^T * scale + bias) (x Wv_h) Wout_h
//
// without q, k, v or the per-head context ever reaching device memory:
// each block projects its q tile and, for every key tile it walks, the
// k and v tiles straight into shared memory, runs the online softmax,
// and applies its head's slice of the output projection in the epilogue.
//
// Grid: (ceil(t / 64) query tiles, n_head, batch); 256 threads; every
// thread owns a 4x4 patch of each 64x64 tile.  The TPU kernel walks all
// heads inside one grid step and sums y in VMEM; here the heads run in
// parallel blocks, so their contributions meet in y through f32 atomic
// adds (y must be zeroed by the caller).  The order of those adds is not
// fixed, so y varies in its last bits from run to run.
//
// Bound: f32 FMA work (no tensor cores: the run is f32 with TF32 off).
// Cost accepted by this first kernel: the k/v tiles of a head are
// projected again by every query tile of that head, t/64 times in all
// (4 times at t = 256), which the TPU kernel's 512-row tiles avoid.
//
// Masking follows the TPU kernel: causal and out-of-range keys score
// -1e30; a query row with l == 0 or max <= -1e29 gets a zero context.
//
// Training asks for the residuals the backward kernels (#2, #3 in
// qkv_attention_bwd.cu) read, as the TPU kernel always returns them: each
// head's normalized context ctx [b, t, h, 64] and lse [b, h, t] (+inf on
// a masked row).  Serving passes null for both and writes neither.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per walk step
constexpr int DH = 64;       // head width
constexpr int KC = 32;       // reduction chunk of the projections
constexpr int NT = 256;      // threads per block
constexpr int AS = KC + 1;   // row stride of the activation tile
constexpr int QS = DH + 1;   // row stride of q / p / ctx tiles
constexpr int TS = DH + 4;   // row stride of k^T / v tiles (float4 rows)
constexpr float kMaskValue = -1e30f;

// shared-memory layout, in floats
constexpr int kAOff = 0;                       // x tile      [BQ][AS]
constexpr int kBOff = kAOff + BQ * AS;         // two w tiles [2][KC][DH]
constexpr int kQOff = kBOff + 2 * KC * DH;     // q           [BQ][QS]
constexpr int kKOff = kQOff + BQ * QS;         // k^T         [DH][TS]
constexpr int kVOff = kKOff + DH * TS;         // v           [BK][TS]
constexpr int kPOff = kVOff + BK * TS;         // p, then ctx [BQ][QS]
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

__global__ void __launch_bounds__(NT)
qkv_attention_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ w_qkv,
                         const float* __restrict__ w_out,
                         const float* __restrict__ bias,
                         int64_t bs_b, int64_t bs_h, int64_t bs_q,
                         int64_t bs_k, float* y, float* ctx, float* lse,
                         int t, int dm, int n_head, float scale,
                         int causal) {
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[i][j] *= alpha;
        p_s[(ty * 4 + i) * QS + tx * 4 + j] = s[i][j];
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

  // ---- context (masked rows give 0), kept in shared memory ------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool masked = (l[i] == 0.f) || (m[i] <= -1e29f);
    const float inv = masked ? 0.f : 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p_s[(ty * 4 + i) * QS + tx * 4 + j] = o[i][j] * inv;
    const int qpos = q0 + ty * 4 + i;
    if (ctx && qpos < t) {
      *reinterpret_cast<float4*>(ctx + ((size_t)bi * t + qpos) * hd +
                                 head * DH + tx * 4) =
          make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv,
                      o[i][3] * inv);
      if (tx == 0)
        lse[((size_t)bi * n_head + head) * t + qpos] =
            masked ? INFINITY : m[i] + logf(l[i]);
    }
  }

  // ---- output-projection epilogue: y[q0:q0+BQ] += ctx_h @ Wout_h ------
  float* wo_s = b_s;  // [DH][DH] tile of Wout_h (2*KC*DH == DH*DH floats)
  for (int c0 = 0; c0 < dm; c0 += DH) {
    __syncthreads();
    for (int idx = tid; idx < DH * (DH / 4); idx += NT) {
      int row = idx / (DH / 4);
      int c4 = idx % (DH / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + c4 * 4 < dm)
        v = *reinterpret_cast<const float4*>(
            w_out + (size_t)(head * DH + row) * dm + c0 + c4 * 4);
      *reinterpret_cast<float4*>(wo_s + row * DH + c4 * 4) = v;
    }
    __syncthreads();
    float ya[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ya[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float4 wv = *reinterpret_cast<const float4*>(wo_s + d * DH + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float cv = p_s[(ty * 4 + i) * QS + d];
        ya[i][0] += cv * wv.x; ya[i][1] += cv * wv.y;
        ya[i][2] += cv * wv.z; ya[i][3] += cv * wv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      if (qpos >= t) continue;
      float* yrow = y + ((size_t)bi * t + qpos) * dm + c0 + tx * 4;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + tx * 4 + j < dm) atomicAdd(yrow + j, ya[i][j]);
    }
  }
}

}  // namespace

// y [b, t, dm] must be zero on entry.  bias may be null; otherwise its
// element (b, h, q, k) lies at b*bs_b + h*bs_h + q*bs_q + k*bs_k.  ctx
// [b, t, h, 64] and lse [b, h, t] are both null (serving) or both given.
// Requires d_head == 64 and dm % 32 == 0 (checked by the caller).
extern "C" int ptt_qkv_attention_fwd(const float* x, const float* w_qkv,
                                     const float* w_out, const float* bias,
                                     int64_t bs_b, int64_t bs_h,
                                     int64_t bs_q, int64_t bs_k, float* y,
                                     float* ctx, float* lse, int b, int t,
                                     int dm, int n_head, float scale,
                                     int causal, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        qkv_attention_fwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((t + BQ - 1) / BQ, n_head, b);
  qkv_attention_fwd_kernel<<<grid, NT, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      x, w_qkv, w_out, bias, bs_b, bs_h, bs_q, bs_k, y, ctx, lse, t, dm,
      n_head, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
