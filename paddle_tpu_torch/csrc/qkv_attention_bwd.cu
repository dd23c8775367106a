// Fused-projection flash attention, backward, f32 and bf16, for sm_90a.
//
// Replaces paddle_tpu/kernels/attention.py _qkv_bwd_dq_kernel (#2) and
// _qkv_bwd_dkv_kernel (#3), the Pallas kernels of flash_qkv_attention's
// VJP, as one pair.  Inputs: x [b, t, dm], the packed w_qkv [dm, 3hd]
// (q|k|v, heads in order within each third), w_out [hd, dm], the bias, g =
// dL/dy [b, t, dm] and #1's residuals ctx [b, t, h, d] and lse [b, h, t].
// With q|k|v = x w_qkv, dctx = g w_out^T, delta = rowsum(dctx * ctx),
// p = exp(q k^T * scale + bias - lse), ds = p (dctx v^T - delta) * scale:
//
//   #2  dq = ds k                         (the dq walk)
//   #3  dk = ds^T q, dv = p^T dctx        (the dkv walk)
//       dx = [dq | dk | dv] w_qkv^T,  dW_qkv = x^T [dq | dk | dv]
//       dW_out = ctx^T g
//
// Design.  The TPU kernels recompute q/k/v tile by tile inside one grid
// walk over all heads and carry dW across grid steps in VMEM.  On the card
// one entry, ptt_qkv_bwd, runs the walks a mask selects in three stages,
// every one a kernel of this file, on PyTorch's stream:
//   1. gemm_kernel (gemm.cuh, shared with #1's y): q|k|v = x w_qkv and
//      dctx = g w_out^T into scratch, then row_delta, once per call for
//      both walks.  On 128x128 tiles, where a walk that recomputed them
//      would redo k/v (or q/dctx) for every 64-row tile of the other side:
//      t/64 times the work (4x at t = 256).
//   2. the flash backward walks of flash_walk.cuh over the projected rows:
//      dq (#2, keys walked), dk and dv (#3, queries walked), one block per
//      (WM-row tile, head, batch row), as #6 and #7 walk theirs.  They
//      write the columns of one [b*t, 3hd] buffer dq|dk|dv in w_qkv's
//      q|k|v order.
//   3. gemm_kernel: dx as one product over the selected walks' columns (K
//      = 3hd for the pair), dW_qkv as one split-K product into the packed
//      [dm, 3hd] layout, and dW_out when the dq walk runs.  A dW product
//      reduces over all b*t rows: split-K blocks write partial sums and
//      sum_splits adds them in split order.
// No atomics: each output element is summed in one fixed order, so two
// calls on the same inputs give the same bits.
//
// Bound in f32: FMA work (TF32 off).  The pair's least work is 11
// products of b*t*dm*hd MACs (3 projections, dctx, 3 for dx, 3 for
// dW_qkv, dW_out) and seven t x t ones per head (three in the dq walk,
// four in the dkv walk).  Stages 1 and 3 run on gemm.cuh's pipelined f32
// tile; the walks are #6's and #7's (flash_walk.cuh: 128-row blocks and
// an 8x4 patch a thread at d 64, 64-row blocks and a 4x8 patch at 128,
// a cp.async ring).
//
// Weights dropout: the walks of flash_walk.cuh regenerate #1's mask (the
// same hash of (seed, b * h + head, q * t + k)) from the seed, with delta
// from #1's dropped ctx.
//
// bf16 (amp, ptt_qkv_bwd_bf16), on tensor cores: x, g, the weights, the
// bias and ctx are bf16.  The same three stages, every product an
// mma.sync kernel: 1. gemm.cuh's tensor-core tile projects q|k|v and dctx
// (exact bf16 products summed in f32) and stores them as hi/lo bf16
// planes in the scratch the f32 values would take (gemm_tc_planes; the
// dctx product also forms delta from its f32 accumulators, so no
// row_delta); 2. flash_bwd_tc.cuh's walks read the planes by cp.async and
// write dq|dk|dv as planes; 3. the tile takes dx = [dq|dk|dv] W_qkv^T (A
// split: two MMAs), dW_qkv = x^T [dq|dk|dv] (B split, split-K) and dW_out
// = ctx^T g (split-K).  The reference holds q, k, v, dctx, p, ds and
// dq|dk|dv in f32; each is split v = hi + lo (v to 2^-16 of itself), a
// product of two split operands is three MMAs (hi hi + hi lo + lo hi), of
// a split and a bf16 operand two.  dx is rounded to x's dtype once and
// dW_qkv, dW_out to the weights', as the reference's custom VJP returns
// them.  MMA work at the amp step's shapes (b 32, t 256, d_model 512, 8
// heads): 73.0 GFLOP in the GEMM stages and 45.1 in the walks, for the
// function's 47.2 + 15.0.
//
// Head width: both pairs take d = 64 and 128: in f32 qkv_bwd<D> (the
// walks on BthdOf<D>, row_delta summing a head's D columns in one fixed
// order; the GEMM stages take any hd), in bf16 qkv_bwd_tc<D> (the walks'
// Planes<D>, the dctx epilogue's delta summed over a head's 64 or 128
// columns in one fixed order, gemm.cuh).
//
// Masking follows #1: causal and out-of-range keys score nothing; a row
// whose lse is +inf (masked in the forward) gets p = 0, so zero gradients;
// rows past t in a ragged tile load as zeros.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_bwd_tc.cuh"
#include "flash_walk.cuh"
#include "gemm.cuh"

namespace {

// The walks of ptt_qkv_bwd's mask.
constexpr int kWalkDq = 1;   // #2
constexpr int kWalkDkv = 2;  // #3

// delta[(bi * h + head) * t + r] = sum_d dctx(row, head, d) * ctx(row,
// head, d) over two [b * t, h * D] matrices (dctx f32, ctx of T), row =
// bi * t + r: one thread per (row, head), summed in d order over the
// head's D columns.
template <class T, int D>
__global__ void __launch_bounds__(NT)
row_delta(const float* __restrict__ dctx, const T* __restrict__ ctx,
          float* delta, int b, int t, int h) {
  const int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x;
  if (i >= (int64_t)b * t * h) return;
  const int head = (int)(i % h);
  const int64_t row = i / h;
  const float4* a = reinterpret_cast<const float4*>(dctx + i * D);
  const T* c = ctx + i * D;
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    const float4 x = a[d];
    const float4 y = load4(c + 4 * d);
    s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  delta[((row / t) * h + head) * t + row % t] = s;
}

// The columns [c0, c0 + w) of the packed q|k|v that the selected walks
// produce: dq [0, hd), dk|dv [hd, 3hd).
struct Cols {
  int c0, w;
};

Cols walk_cols(int walks, int hd) {
  return {walks & kWalkDq ? 0 : hd,
          (walks & kWalkDq ? hd : 0) + (walks & kWalkDkv ? 2 * hd : 0)};
}

// Scratch of one call, in floats: q|k|v [b*t, 3hd], dctx [b*t, hd],
// dq|dk|dv [b*t, 3hd], the dW partials, delta [b, h, t].
struct Scratch {
  float* qkv;
  float* dctx;
  float* dqkv;
  float* partials;
  float* delta;
};

int64_t scratch_floats(int walks, int b, int t, int dm, int hd, int dh,
                       int sms, Scratch* s, float* base) {
  const int64_t bt = (int64_t)b * t;
  const Cols cols = walk_cols(walks, hd);
  const int64_t part = std::max(
      gemm_partials(dm, cols.w, (int)bt, sms),
      walks & kWalkDq ? gemm_partials(hd, dm, (int)bt, sms) : 0);
  if (s) {
    s->qkv = base;
    s->dctx = s->qkv + bt * 3 * hd;
    s->dqkv = s->dctx + bt * hd;
    s->partials = s->dqkv + bt * 3 * hd;
    s->delta = s->partials + part;
  }
  return bt * 7 * hd + part + bt * (hd / dh);
}

// The projected q, k, v of one call as the walks read them (heads D wide),
// and where they write dq, dk, dv: column offsets 0, hd, 2hd of a [b*t,
// 3hd] matrix.
template <int D>
Rows<BthdOf<D>> qkv_rows(const float* m, int hd, int third) {
  return Rows<BthdOf<D>>{m + third * hd, BthdOf<D>{3 * hd}};
}

}  // namespace

// Floats of scratch the wrapper allocates for one ptt_qkv_bwd call with
// these walks at head width d_head on a card of `sms` SMs.
extern "C" int64_t ptt_qkv_bwd_scratch(int walks, int b, int t, int dm,
                                       int n_head, int d_head, int sms) {
  return scratch_floats(walks, b, t, dm, n_head * d_head, d_head, sms,
                        nullptr, nullptr);
}

// Dynamic shared memory of a block of the bf16 pair's walks (walk 0: dq,
// 1: dkv) at head width dh (64 or 128; 0 for another) in bytes.
extern "C" int64_t ptt_qkv_bwd_walk_smem(int walk, int dh) {
  if (dh == 64)
    return (int64_t)(walk ? Bw<true, 64>::kDkvSmem : Bw<true, 64>::kDqSmem);
  if (dh == 128)
    return (int64_t)(walk ? Bw<true, 128>::kDkvSmem
                          : Bw<true, 128>::kDqSmem);
  return 0;
}

namespace {

// The pair in f32 at head width D: ptt_qkv_bwd's arguments.
template <int D>
int qkv_bwd(int walks, const float* x, const float* w_qkv,
            const float* w_out, const float* bias, int64_t bs_b,
            int64_t bs_h, int64_t bs_q, int64_t bs_k, const float* g,
            const float* ctx, const float* lse, float* scratch, float* dx,
            float* dw, float* dw_out, int b, int t, int dm, int n_head,
            int sms, float scale, int causal, double rate, unsigned seed,
            unsigned threshold, void* stream_ptr) {
  using T = float;
  if (walks < 1 || walks > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int hd = n_head * D;
  const int bt = b * t;
  const Cols cols = walk_cols(walks, hd);
  Scratch s;
  scratch_floats(walks, b, t, dm, hd, D, sms, &s, scratch);

  // 1. q|k|v = x w_qkv, dctx = g w_out^T, delta = rowsum(dctx * ctx)
  cudaError_t err = gemm<T, T, float>({x, dm, false}, {w_qkv, 3 * hd, true},
                                      s.qkv, 3 * hd, bt, 3 * hd, dm, false,
                                      nullptr, sms, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm<T, T, float>({g, dm, false}, {w_out, dm, false}, s.dctx, hd,
                          bt, hd, dm, false, nullptr, sms, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)bt * n_head;
  row_delta<T, D><<<(unsigned)((rows + NT - 1) / NT), NT, 0, stream>>>(
      s.dctx, ctx, s.delta, b, t, n_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2. the walks, into the q|k|v columns of dqkv
  const BiasOf<T> bs{bias, bs_b, bs_h, bs_q, bs_k};
  const Rows<BthdOf<D>> dctx{s.dctx, BthdOf<D>{hd}};
  const Dropout drop = hash_rng::make_dropout(rate, seed, threshold);
  if (walks & kWalkDq) {
    err = bwd_dq(qkv_rows<D>(s.qkv, hd, 0), qkv_rows<D>(s.qkv, hd, 1),
                 qkv_rows<D>(s.qkv, hd, 2), bs, dctx, lse, s.delta, s.dqkv,
                 BthdOf<D>{3 * hd}, b, t, t, n_head, scale, causal, drop,
                 stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (walks & kWalkDkv) {
    err = bwd_dkv(qkv_rows<D>(s.qkv, hd, 0), qkv_rows<D>(s.qkv, hd, 1),
                  qkv_rows<D>(s.qkv, hd, 2), bs, dctx, lse, s.delta,
                  s.dqkv + hd, s.dqkv + 2 * hd, BthdOf<D>{3 * hd}, b, t, t,
                  n_head, scale, causal, drop, stream);
    if (err != cudaSuccess) return (int)err;
  }

  // 3. dx = dqkv[:, cols] w_qkv[:, cols]^T; dW = x^T dqkv[:, cols];
  //    dW_out = ctx^T g
  const float* dqkv = s.dqkv + cols.c0;
  err = gemm<float, T, T>({dqkv, 3 * hd, false},
                          {w_qkv + cols.c0, 3 * hd, false}, dx, dm, bt, dm,
                          cols.w, false, nullptr, sms, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm<T, float, T>({x, dm, true}, {dqkv, 3 * hd, true}, dw, cols.w,
                          dm, cols.w, bt, true, s.partials, sms, stream);
  if (err != cudaSuccess || !(walks & kWalkDq)) return (int)err;
  return (int)gemm<T, T, T>({ctx, hd, true}, {g, dm, true}, dw_out, dm, hd,
                            dm, bt, true, s.partials, sms, stream);
}

// The pair in bf16 on tensor cores at head width D: ptt_qkv_bwd_bf16's
// arguments.  The scratch's q|k|v, dctx and dq|dk|dv regions hold hi/lo
// bf16 planes.
template <int D>
int qkv_bwd_tc(int walks, const bf16* x, const bf16* w_qkv,
               const bf16* w_out, const bf16* bias, int64_t bs_b,
               int64_t bs_h, int64_t bs_q, int64_t bs_k, const bf16* g,
               const bf16* ctx, const float* lse, float* scratch, bf16* dx,
               bf16* dw, bf16* dw_out, int b, int t, int dm, int n_head,
               int sms, float scale, int causal, double rate, unsigned seed,
               unsigned threshold, void* stream_ptr) {
  if (walks < 1 || walks > 3) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int hd = n_head * D;
  const int bt = b * t;
  const Cols cols = walk_cols(walks, hd);
  Scratch s;
  scratch_floats(walks, b, t, dm, hd, D, sms, &s, scratch);
  // each region's hi plane, its lo plane after it
  bf16* qkv = reinterpret_cast<bf16*>(s.qkv);
  bf16* dctx = reinterpret_cast<bf16*>(s.dctx);
  bf16* dqkv = reinterpret_cast<bf16*>(s.dqkv);
  const int64_t qkv_lo = (int64_t)bt * 3 * hd;
  const int64_t dctx_lo = (int64_t)bt * hd;

  // 1. q|k|v = x w_qkv; dctx = g w_out^T with delta = rowsum(dctx * ctx)
  cudaError_t err = gemm_tc_planes<true, 0>(
      {x, dm, false, 0}, {w_qkv, 3 * hd, true, 0}, qkv, 3 * hd, qkv_lo,
      nullptr, nullptr, t, n_head, bt, 3 * hd, dm, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tc_planes<false, D>(
      {g, dm, false, 0}, {w_out, dm, false, 0}, dctx, hd, dctx_lo, ctx,
      s.delta, t, n_head, bt, hd, dm, stream);
  if (err != cudaSuccess) return (int)err;

  // 2. the walks, into the q|k|v columns of dqkv
  const BiasOf<bf16> bs{bias, bs_b, bs_h, bs_q, bs_k};
  const Planes<D> qkv_p{qkv, qkv_lo, 3 * hd};
  const Planes<D> dctx_p{dctx, dctx_lo, hd};
  const PlanesOf<bf16, D> dqkv_p{dqkv, qkv_lo, 3 * hd};
  const Dropout drop = hash_rng::make_dropout(rate, seed, threshold);
  for (int walk = 0; walk < 2; ++walk) {
    if (!(walks & (walk ? kWalkDkv : kWalkDq))) continue;
    err = bwd_tc(walk, qkv_p, dctx_p, bs, lse, s.delta, dqkv_p, b, t,
                 n_head, scale, causal, drop, stream);
    if (err != cudaSuccess) return (int)err;
  }

  // 3. dx = dqkv[:, cols] w_qkv[:, cols]^T; dW = x^T dqkv[:, cols];
  //    dW_out = ctx^T g
  err = gemm_tc<false, false, true, false, bf16>(
      {dqkv + cols.c0, 3 * hd, false, qkv_lo},
      {w_qkv + cols.c0, 3 * hd, false, 0}, dx, dm, bt, dm, cols.w, false,
      nullptr, sms, stream);
  if (err != cudaSuccess) return (int)err;
  err = gemm_tc<true, true, false, true, bf16>(
      {x, dm, true, 0}, {dqkv + cols.c0, 3 * hd, true, qkv_lo}, dw, cols.w,
      dm, cols.w, bt, true, s.partials, sms, stream);
  if (err != cudaSuccess || !(walks & kWalkDq)) return (int)err;
  return (int)gemm_tc<true, true, false, false, bf16>(
      {ctx, hd, true, 0}, {g, dm, true, 0}, dw_out, dm, hd, dm, bt, true,
      s.partials, sms, stream);
}

}  // namespace

// #2 + #3.  walks: bit 0 runs the dq walk (#2), bit 1 the dkv walk (#3);
// with both the pair shares one projection stage and one set of output
// GEMMs.  x, g, dx [b, t, dm]; w_qkv [dm, 3hd]; w_out [hd, dm]; ctx
// [b, t, h, d_head]; lse [b, h, t]; all contiguous f32, hd = d_head *
// n_head; d_head 64 or 128 (anything else returns cudaErrorInvalidValue).
// dx is the selected walks' part of dL/dx; dw [dm, w] holds dW_qkv's
// columns [c0, c0 + w) of the selected walks (dW_q for bit 0 alone, dW_k
// | dW_v for bit 1 alone, the packed [dm, 3hd] for both); dw_out [hd, dm]
// is written when bit 0 is set (null otherwise).  bias may be null;
// otherwise its element (b, h, q, k) lies at b*bs_b + h*bs_h + q*bs_q +
// k*bs_k.  scratch holds ptt_qkv_bwd_scratch floats; sms is the card's SM
// count (the dW products' split-K).  rate, seed and threshold are #1's.
extern "C" int ptt_qkv_bwd(int walks, const float* x, const float* w_qkv,
                           const float* w_out, const float* bias,
                           int64_t bs_b, int64_t bs_h, int64_t bs_q,
                           int64_t bs_k, const float* g, const float* ctx,
                           const float* lse, float* scratch, float* dx,
                           float* dw, float* dw_out, int b, int t, int dm,
                           int n_head, int d_head, int sms, float scale,
                           int causal, double rate, unsigned seed,
                           unsigned threshold, void* stream_ptr) {
  if (d_head == 64)
    return qkv_bwd<64>(walks, x, w_qkv, w_out, bias, bs_b, bs_h, bs_q, bs_k,
                       g, ctx, lse, scratch, dx, dw, dw_out, b, t, dm, n_head,
                       sms, scale, causal, rate, seed, threshold, stream_ptr);
  if (d_head == 128)
    return qkv_bwd<128>(walks, x, w_qkv, w_out, bias, bs_b, bs_h, bs_q,
                        bs_k, g, ctx, lse, scratch, dx, dw, dw_out, b, t, dm,
                        n_head, sms, scale, causal, rate, seed, threshold,
                        stream_ptr);
  return (int)cudaErrorInvalidValue;
}

// #2 + #3 in bf16 (amp), on tensor cores: as ptt_qkv_bwd with x, the
// weights, the bias, g, ctx, dx, dw and dw_out bf16, lse f32, and the
// scratch of ptt_qkv_bwd_scratch floats (its regions hold bf16 planes);
// d_head 64 or 128.
extern "C" int ptt_qkv_bwd_bf16(int walks, const bf16* x, const bf16* w_qkv,
                                const bf16* w_out, const bf16* bias,
                                int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                int64_t bs_k, const bf16* g, const bf16* ctx,
                                const float* lse, float* scratch, bf16* dx,
                                bf16* dw, bf16* dw_out, int b, int t, int dm,
                                int n_head, int d_head, int sms, float scale,
                                int causal, double rate, unsigned seed,
                                unsigned threshold, void* stream_ptr) {
  if (d_head == 64)
    return qkv_bwd_tc<64>(walks, x, w_qkv, w_out, bias, bs_b, bs_h, bs_q,
                          bs_k, g, ctx, lse, scratch, dx, dw, dw_out, b, t,
                          dm, n_head, sms, scale, causal, rate, seed,
                          threshold, stream_ptr);
  if (d_head == 128)
    return qkv_bwd_tc<128>(walks, x, w_qkv, w_out, bias, bs_b, bs_h, bs_q,
                           bs_k, g, ctx, lse, scratch, dx, dw, dw_out, b, t,
                           dm, n_head, sms, scale, causal, rate, seed,
                           threshold, stream_ptr);
  return (int)cudaErrorInvalidValue;
}
