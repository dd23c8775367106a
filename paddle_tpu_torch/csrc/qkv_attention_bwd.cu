// Fused-projection flash attention, backward, f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/attention.py _qkv_bwd_dq_kernel (#2) and
// _qkv_bwd_dkv_kernel (#3), the Pallas kernels of flash_qkv_attention's
// VJP.  Inputs: x [b, t, dm], the packed w_qkv [dm, 3hd] (q|k|v, heads in
// order within each third), w_out [hd, dm], the bias, g = dL/dy
// [b, t, dm] and #1's residuals ctx [b, t, h, 64] and lse [b, h, t].
// With q|k|v = x w_qkv, dctx = g w_out^T, delta = rowsum(dctx * ctx),
// p = exp(q k^T * scale + bias - lse), ds = p (dctx v^T - delta) * scale:
//
//   #2  dq = ds k;                dx_q  = dq Wq^T
//       dW_q = x^T dq,            dW_out = ctx^T g
//   #3  dk = ds^T q, dv = p^T dctx;  dx_kv = dk Wk^T + dv Wv^T
//       dW_k = x^T dk,               dW_v  = x^T dv
//
// Design.  The TPU kernels recompute q/k/v tile by tile inside one grid
// walk over all heads and carry dW across grid steps in VMEM.  On the card
// each is three stages, every one a kernel of this file, on PyTorch's
// stream:
//   1. gemm_kernel (gemm.cuh, shared with #1's residual mode): q|k|v =
//      x w_qkv and dctx = g w_out^T into scratch.
//      The projections run once per call on 128x128 tiles, where a walk
//      that recomputed them would redo k/v (or q/dctx) for every 64-row
//      tile of the other side: t/64 times the work (4x at t = 256).
//   2. row_delta (delta = rowsum(dctx * ctx)), then the flash backward
//      walk of flash_walk.cuh over the projected rows: dq for #2 (keys
//      walked), dk and dv for #3 (queries walked), one block per (64-row
//      tile, head, batch row), as #6 and #7 walk theirs.
//   3. gemm_kernel: dx and the dW from the walk's output.  A dW product
//      reduces over all b*t rows: split-K blocks write partial sums and
//      sum_splits adds them in split order.
// No atomics: each output element is summed in one fixed order, so two
// calls on the same inputs give the same bits.
//
// Bound: f32 FMA work (TF32 off).  The least work of #2 is 7 products of
// b*t*dm*hd MACs (3 projections, dctx, dx_q, dW_q, dW_out) and three
// t x t ones per head; #3 has 8 and four.  Stage 1 and 3 read their
// operands from shared memory as float4 (an 8x8 patch per thread: 64 FMAs
// for 4 loads); the walks are #6's and #7's.  No tensor cores, no TMA, no
// load pipelining: later work.
//
// Weights dropout: the walks of flash_walk.cuh regenerate #1's mask (the
// same hash of (seed, b * h + head, q * t + k)) from the seed, with delta
// from #1's dropped ctx.
//
// Masking follows #1: causal and out-of-range keys score nothing; a row
// whose lse is +inf (masked in the forward) gets p = 0, so zero gradients;
// rows past t in a ragged tile load as zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_walk.cuh"
#include "gemm.cuh"

namespace {

// ---------------------------------------------------------------------------
// stage 2: delta, then the walks of flash_walk.cuh
// ---------------------------------------------------------------------------

// delta[(bi * h + head) * t + r] = sum_d dctx(row, head, d) * ctx(row,
// head, d) over two [b * t, h * 64] matrices, row = bi * t + r: one thread
// per (row, head), summed in d order.
__global__ void __launch_bounds__(NT)
row_delta(const float* __restrict__ dctx, const float* __restrict__ ctx,
          float* delta, int b, int t, int h) {
  const int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x;
  if (i >= (int64_t)b * t * h) return;
  const int head = (int)(i % h);
  const int64_t row = i / h;
  const float4* a = reinterpret_cast<const float4*>(dctx + i * DH);
  const float4* c = reinterpret_cast<const float4*>(ctx + i * DH);
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < DH / 4; ++d) {
    const float4 x = a[d];
    const float4 y = c[d];
    s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  delta[((row / t) * h + head) * t + row % t] = s;
}

// Scratch of one call, in floats: q|k|v [b*t, 3hd], dctx [b*t, hd], the
// walk's output (dq [b*t, hd] or dk|dv [b*t, 2hd]), delta [b, h, t] and
// the dW partials.
struct Scratch {
  float* qkv;
  float* dctx;
  float* walk;
  float* delta;
  float* partials;
};

int64_t scratch_floats(int which, int b, int t, int dm, int hd,
                       Scratch* s, float* base) {
  const int64_t bt = (int64_t)b * t;
  const int walk_cols = which == 0 ? hd : 2 * hd;
  const int64_t part = which == 0
      ? std::max(gemm_partials(dm, hd, (int)bt),
               gemm_partials(hd, dm, (int)bt))
      : gemm_partials(dm, 2 * hd, (int)bt);
  const int64_t delta = bt * (hd / DH);
  if (s) {
    s->qkv = base;
    s->dctx = s->qkv + bt * 3 * hd;
    s->walk = s->dctx + bt * hd;
    s->delta = s->walk + bt * walk_cols;
    s->partials = s->delta + delta;
  }
  return bt * (4 * hd + walk_cols) + delta + part;
}

// Stages 1 and 2's delta, shared by both kernels: q|k|v = x w_qkv, dctx =
// g w_out^T, delta = rowsum(dctx * ctx).
cudaError_t project(const float* x, const float* w_qkv, const float* w_out,
                    const float* g, const float* ctx, const Scratch& s,
                    int b, int t, int dm, int n_head, cudaStream_t stream) {
  const int hd = n_head * DH;
  const int bt = b * t;
  cudaError_t err = gemm({x, dm, false}, {w_qkv, 3 * hd, true}, s.qkv,
                         3 * hd, bt, 3 * hd, dm, false, nullptr, stream);
  if (err != cudaSuccess) return err;
  err = gemm({g, dm, false}, {w_out, dm, false}, s.dctx, hd, bt, hd, dm,
             false, nullptr, stream);
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)bt * n_head;
  row_delta<<<(unsigned)((rows + NT - 1) / NT), NT, 0, stream>>>(
      s.dctx, ctx, s.delta, b, t, n_head);
  return cudaGetLastError();
}

// The projected q, k, v of one call as the walks read them.
Rows<Bthd> q_rows(const Scratch& s, int hd) {
  return Rows<Bthd>{s.qkv, Bthd{3 * hd}};
}
Rows<Bthd> k_rows(const Scratch& s, int hd) {
  return Rows<Bthd>{s.qkv + hd, Bthd{3 * hd}};
}
Rows<Bthd> v_rows(const Scratch& s, int hd) {
  return Rows<Bthd>{s.qkv + 2 * hd, Bthd{3 * hd}};
}

}  // namespace

// Floats of scratch the wrapper allocates for one call of
// ptt_qkv_bwd_dq (which == 0) or ptt_qkv_bwd_dkv (which == 1).
extern "C" int64_t ptt_qkv_bwd_scratch(int which, int b, int t, int dm,
                                       int n_head) {
  return scratch_floats(which, b, t, dm, n_head * DH, nullptr, nullptr);
}

// #2.  x, g, dx [b, t, dm]; w_qkv [dm, 3hd]; w_out [hd, dm]; ctx
// [b, t, h, 64]; lse [b, h, t]; dw_q [dm, hd]; dw_out [hd, dm]; all
// contiguous f32, hd = 64 * n_head.  bias may be null; otherwise its
// element (b, h, q, k) lies at b*bs_b + h*bs_h + q*bs_q + k*bs_k.
// scratch holds ptt_qkv_bwd_scratch(0, ...) floats.  rate, seed and
// threshold are #1's.
extern "C" int ptt_qkv_bwd_dq(const float* x, const float* w_qkv,
                              const float* w_out, const float* bias,
                              int64_t bs_b, int64_t bs_h, int64_t bs_q,
                              int64_t bs_k, const float* g, const float* ctx,
                              const float* lse, float* scratch, float* dx,
                              float* dw_q, float* dw_out, int b, int t,
                              int dm, int n_head, float scale, int causal,
                              double rate, unsigned seed,
                              unsigned threshold, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int hd = n_head * DH;
  const int bt = b * t;
  Scratch s;
  scratch_floats(0, b, t, dm, hd, &s, scratch);
  cudaError_t err =
      project(x, w_qkv, w_out, g, ctx, s, b, t, dm, n_head, stream);
  if (err != cudaSuccess) return (int)err;
  err = bwd_dq(q_rows(s, hd), k_rows(s, hd), v_rows(s, hd),
               Bias{bias, bs_b, bs_h, bs_q, bs_k},
               Rows<Bthd>{s.dctx, Bthd{hd}}, lse, s.delta, s.walk, Bthd{hd},
               b, t, t, n_head, scale, causal,
               hash_rng::make_dropout(rate, seed, threshold), stream);
  if (err != cudaSuccess) return (int)err;
  // dx_q = dq Wq^T; dW_q = x^T dq; dW_out = ctx^T g
  err = gemm({s.walk, hd, false}, {w_qkv, 3 * hd, false}, dx, dm, bt, dm,
             hd, false, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm({x, dm, true}, {s.walk, hd, true}, dw_q, hd, dm, hd, bt, true,
             s.partials, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm({ctx, hd, true}, {g, dm, true}, dw_out, dm, hd, dm, bt,
                   true, s.partials, stream);
}

// #3.  As ptt_qkv_bwd_dq; dw_kv [dm, 2hd] holds dW_k | dW_v.  scratch
// holds ptt_qkv_bwd_scratch(1, ...) floats.
extern "C" int ptt_qkv_bwd_dkv(const float* x, const float* w_qkv,
                               const float* w_out, const float* bias,
                               int64_t bs_b, int64_t bs_h, int64_t bs_q,
                               int64_t bs_k, const float* g,
                               const float* ctx, const float* lse,
                               float* scratch, float* dx, float* dw_kv,
                               int b, int t, int dm, int n_head, float scale,
                               int causal, double rate, unsigned seed,
                               unsigned threshold, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int hd = n_head * DH;
  const int bt = b * t;
  Scratch s;
  scratch_floats(1, b, t, dm, hd, &s, scratch);
  cudaError_t err =
      project(x, w_qkv, w_out, g, ctx, s, b, t, dm, n_head, stream);
  if (err != cudaSuccess) return (int)err;
  err = bwd_dkv(q_rows(s, hd), k_rows(s, hd), v_rows(s, hd),
                Bias{bias, bs_b, bs_h, bs_q, bs_k},
                Rows<Bthd>{s.dctx, Bthd{hd}}, lse, s.delta, s.walk,
                s.walk + hd, Bthd{2 * hd}, b, t, t, n_head, scale, causal,
                hash_rng::make_dropout(rate, seed, threshold), stream);
  if (err != cudaSuccess) return (int)err;
  // dx_kv = [dk | dv] [Wk | Wv]^T; [dW_k | dW_v] = x^T [dk | dv]
  err = gemm({s.walk, 2 * hd, false}, {w_qkv + hd, 3 * hd, false}, dx, dm,
             bt, dm, 2 * hd, false, nullptr, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)gemm({x, dm, true}, {s.walk, 2 * hd, true}, dw_kv, 2 * hd, dm,
                   2 * hd, bt, true, s.partials, stream);
}
