// Flash attention over [b, t, h, 64] tensors (the "bthd" layout), forward
// and both backward passes, f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/attention.py _fwd_kernel_bthd (#4),
// _bwd_dq_kernel_bthd (#6) and _bwd_dkv_kernel_bthd (#7), the Pallas
// kernels behind flash_attention(fmt="bthd") and its VJP:
//
//   forward  o = softmax(q k^T * scale + bias) v,  lse = m + log(l) per row
//   dq       dq = sum_k p (dp - delta) * scale * k,  p = exp(s - lse)
//            recomputed from lse, dp = dO v^T, delta = rowsum(dO * o)
//   dkv      dv = sum_q p^T dO,  dk = sum_q (p (dp - delta) * scale)^T q
//
// Grid: the forward and dq take one block per (64-row q tile, head, batch
// row) and walk the k tiles; dkv takes one block per (64-row k tile,
// head, batch row) and walks the q tiles.  The TPU kernels walk all heads
// of a batch row in one grid step (whole-head tiles suit Mosaic's (8, 128)
// layout); here a head is a block, so b * h * t / 64 blocks fill the card.
// Every output element belongs to one block, which sums in a fixed order:
// no atomics, and the results are the same from run to run.
//
// The tiles, the tile product and both backward walks live in
// flash_walk.cuh, which the fused-projection backward (#2, #3) shares: 256
// threads, a 4x4 patch of every 64x64x64 tile product per thread.
//
// Bound: f32 FMA work on the CUDA cores (the run is f32 with TF32 off):
// 4, 6 and 8 * b*h*tq*tk*64 FLOPs for forward, dq and dkv against 67
// TFLOP/s.  Each reads 3 to 6 [b, t, h, 64] tensors once per tile walk,
// about a third of the FLOP time at t = 256.  The design stages each tile
// in shared memory once per block and does 16 FMAs per pair of operands a
// thread loads.  No tensor cores (wgmma, TF32), no load pipelining: later
// work.
//
// Weights dropout (the reference's dropout on the softmax, inside the
// kernels): the normalizer l sums the undropped p, the p tile multiplying
// v is dropped by hash_rng::keep_attn at (seed, b * h + head, q * tk + k),
// and the output is scaled by 1 / (1 - rate) at the end; the backward
// walks regenerate the same bits (flash_walk.cuh).  At rate 0 the entry
// points launch the instantiations that never hash.
//
// Masking follows the TPU kernels: causal (bottom-right aligned, offset
// tk - tq) and out-of-range keys score -1e30 in the forward; a row whose
// max score is <= -1e29, or that sees no key, gets a zero output and
// lse = +inf, so p = exp(s - lse) = 0 and its gradients are zero in both
// backward kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_walk.cuh"

namespace {

constexpr float kMaskValue = -1e30f;
constexpr size_t kFwdSmem = (2 * kATile + 2 * kBTile) * sizeof(float);

template <bool DROP>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(Rows q, Rows k, Rows v, Bias bias, float* o, float* lse,
                 int tq, int tk, int h, float scale, int causal,
                 Dropout drop) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [BT][AS] q * scale
  float* p_s = q_s + kATile;      // [BT][AS] probabilities of one k tile
  float* kt_s = p_s + kATile;     // [DH][BS] k^T
  float* v_s = kt_s + kBTile;     // [BT][BS] v

  const int q0 = blockIdx.x * BT;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int offset = tk - tq;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);

  load_rows(q_s, AS, q, bi, q0, tq, head, scale);
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  zero(acc);

  const int n_kv = kv_tiles(q0, tq, tk, causal);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the last tile's kt_s, v_s and p_s are consumed
    load_rows_t(kt_s, k, bi, k0, tk, head);
    load_rows(v_s, BS, v, bi, k0, tk, head);
    __syncthreads();
    float s[4][4];
    zero(s);
    tile_mma(q_s, kt_s, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        if (kpos >= tk || (causal && qpos + offset < kpos))
          s[i][j] = kMaskValue;
        else if (bias.p)
          s[i][j] += bias.at(bi, head, min(qpos, tq - 1), kpos);
      }
    }
    // online softmax; a row's 16 threads are one half warp
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
        acc[i][j] *= alpha;
        float pv = s[i][j];
        if (DROP && !hash_rng::keep_attn(
                hseed, (uint32_t)qpos * tk + k0 + tx * 4 + j,
                drop.threshold))
          pv = 0.f;
        p_s[(ty * 4 + i) * AS + tx * 4 + j] = pv;
      }
    }
    __syncthreads();
    tile_mma(p_s, v_s, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool masked = (l[i] == 0.f) || (m[i] <= -1e29f);
    const float inv = masked ? 0.f
                             : (DROP ? drop.inv_keep / l[i] : 1.f / l[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= inv;
    const int qpos = q0 + ty * 4 + i;
    if (tx == 0 && qpos < tq)
      lse[((size_t)bi * h + head) * tq + qpos] =
          masked ? INFINITY : m[i] + logf(l[i]);
  }
  store_rows(o, h * DH, acc, bi, q0, tq, head);
}

template <bool DROP>
cudaError_t launch_fwd(Rows q, Rows k, Rows v, Bias bias, float* o,
                       float* lse, int b, int tq, int tk, int h, float scale,
                       int causal, Dropout drop, cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_kernel<DROP>, kFwdSmem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + BT - 1) / BT, h, b);
  flash_fwd_kernel<DROP><<<grid, NT, kFwdSmem, stream>>>(
      q, k, v, bias, o, lse, tq, tk, h, scale, causal, drop);
  return cudaGetLastError();
}

}  // namespace

// q [b, tq, h, 64], k and v [b, tk, h, 64], o like q, lse [b, h, tq]; all
// contiguous f32.  bias may be null; otherwise its element (b, h, q, k)
// lies at b*bs_b + h*bs_h + q*bs_q + k*bs_k.  Head width 64 only (checked
// by the caller).  rate 0 runs without dropout; otherwise weights are kept
// where the hash of (seed, b*h + head, q*tk + k) >= threshold (tq*tk <=
// 2^32, checked by the caller).
extern "C" int ptt_flash_fwd(const float* q, const float* k, const float* v,
                             const float* bias, int64_t bs_b, int64_t bs_h,
                             int64_t bs_q, int64_t bs_k, float* o,
                             float* lse, int b, int tq, int tk, int h,
                             float scale, int causal, double rate,
                             unsigned seed, unsigned threshold,
                             void* stream) {
  const int ld = h * DH;
  const Rows rq{q, ld}, rk{k, ld}, rv{v, ld};
  const Bias bs{bias, bs_b, bs_h, bs_q, bs_k};
  const Dropout drop = hash_rng::make_dropout(rate, seed, threshold);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(drop.on ? launch_fwd<true>(rq, rk, rv, bs, o, lse, b, tq, tk,
                                          h, scale, causal, drop, st)
                       : launch_fwd<false>(rq, rk, rv, bs, o, lse, b, tq, tk,
                                           h, scale, causal, drop, st));
}

// dout like q; lse and delta = rowsum(dout * o) [b, h, tq]; dq like q;
// the forward's dropout arguments.
extern "C" int ptt_flash_bwd_dq(const float* q, const float* k,
                                const float* v, const float* bias,
                                int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                int64_t bs_k, const float* dout,
                                const float* lse, const float* delta,
                                float* dq, int b, int tq, int tk, int h,
                                float scale, int causal, double rate,
                                unsigned seed, unsigned threshold,
                                void* stream) {
  const int ld = h * DH;
  return (int)bwd_dq(Rows{q, ld}, Rows{k, ld}, Rows{v, ld},
                     Bias{bias, bs_b, bs_h, bs_q, bs_k}, Rows{dout, ld}, lse,
                     delta, dq, ld, b, tq, tk, h, scale, causal,
                     hash_rng::make_dropout(rate, seed, threshold),
                     static_cast<cudaStream_t>(stream));
}

// As ptt_flash_bwd_dq; dk and dv like k.
extern "C" int ptt_flash_bwd_dkv(const float* q, const float* k,
                                 const float* v, const float* bias,
                                 int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                 int64_t bs_k, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dk, float* dv, int b, int tq, int tk,
                                 int h, float scale, int causal, double rate,
                                 unsigned seed, unsigned threshold,
                                 void* stream) {
  const int ld = h * DH;
  return (int)bwd_dkv(Rows{q, ld}, Rows{k, ld}, Rows{v, ld},
                      Bias{bias, bs_b, bs_h, bs_q, bs_k}, Rows{dout, ld}, lse,
                      delta, dk, dv, ld, b, tq, tk, h, scale, causal,
                      hash_rng::make_dropout(rate, seed, threshold),
                      static_cast<cudaStream_t>(stream));
}
