// Flash attention over [b, t, h, 64] tensors (the "bthd" layout) and over
// [b, h, t, 64] tensors (the "bhtd" layout), forward and both backward
// passes, in f32 and in bf16 (amp), for sm_90a.
//
// Replaces paddle_tpu/kernels/attention.py _fwd_kernel_bthd (#4),
// _bwd_dq_kernel_bthd (#6) and _bwd_dkv_kernel_bthd (#7), the Pallas
// kernels behind flash_attention(fmt="bthd") and its VJP, and _fwd_kernel
// (#5), _bwd_dq_kernel (#8) and _bwd_dkv_kernel (#9), those behind
// flash_attention(fmt="bhtd"), the layout of layers.contrib.fused_attention
// and of every site the attention_fuse pass rewrites:
//
//   forward  o = softmax(q k^T * scale + bias) v,  lse = m + log(l) per row
//   dq       dq = sum_k p (dp - delta) * scale * k,  p = exp(s - lse)
//            recomputed from lse, dp = dO v^T, delta = rowsum(dO * o)
//   dkv      dv = sum_q p^T dO,  dk = sum_q (p (dp - delta) * scale)^T q
//
// The two layouts are instantiations of the same kernels on a row layout
// (flash_walk.cuh Bthd, Bhtd), so each layout has its own kernels and
// entry points and both compute in the same order.  In bhtd a head's
// [t, 64] slab is contiguous, so a k or v tile is one contiguous 16 KB
// block (a single bulk copy for a later TMA design); the staging here reads
// it as the bthd kernels read their strided rows.
//
// Grid: every pass takes one block of 256 threads per (128-row tile, head,
// batch row): the forward and dq per q tile, walking the 64-row k tiles;
// dkv per k tile, walking the 64-row q tiles.  The TPU kernels walk all
// heads of a batch row in one grid step in bthd (whole-head tiles suit
// Mosaic's (8, 128) layout) and one (batch row, head) per grid row in
// bhtd; here a head is a block in both, so b * h * t / 128 blocks fill the
// card.  Every output element belongs to one block, which sums in a fixed
// order: no atomics, and the results are the same from run to run.
//
// The kernels live in flash_walk.cuh, which the fused-projection backward
// (#2, #3) shares: one block an SM, an 8x4 patch a thread of every [128,
// 64] tile product, each operand tile staged once as it lies in memory
// through a two-stage cp.async ring, the bias staged row by row.  The
// forward computes s = q k^T and acc += p v on that patch, with its online
// softmax on the 8 rows a thread owns.
//
// Bound: f32 FMA work on the CUDA cores (the run is f32 with TF32 off):
// 4, 6 and 8 * b*h*tq*tk*64 FLOPs for forward, dq and dkv against 67
// TFLOP/s.  Each reads 3 to 6 [b, t, h, 64] tensors once per tile walk,
// about a third of the FLOP time at t = 256.  Every product does 128 FMAs
// per 12 float4 reads of shared memory, which caps it at two thirds of the
// FMA rate.  No tensor cores (wgmma, TF32), no TMA: later work.
//
// Weights dropout (the reference's dropout on the softmax, inside the
// kernels): the normalizer l sums the undropped p, the p tile multiplying
// v is dropped by hash_rng::keep_attn at (seed, b * h + head, q * tk + k),
// and the output is scaled by 1 / (1 - rate) at the end; the backward
// walks regenerate the same bits (flash_walk.cuh).  The mask is the same
// in both layouts.  At rate 0 the entry points launch the instantiations
// that never hash.
//
// bf16 (amp, both layouts: ptt_flash_*_bf16 and ptt_flash_*_bhtd_bf16):
// q, k, v, the bias, o, dO, dq, dk and dv are bf16, lse and delta f32, and
// all three passes run on tensor cores (mma.sync): the forward in
// flash_tc.cuh (exact bf16 products for s, p split into hi/lo bf16s for p
// v), the backward walks in flash_bwd_tc.cuh on one bf16 plane (exact
// bf16 products for s and dp, p and ds split for dq += ds k, dv += p^T dO
// and dk += ds^T q), each output rounded to bf16 once.  Both files take
// the row layout as a template parameter, so #5, #8 and #9 in bf16 are the
// bthd kernels' instantiations on Bhtd.  The scale multiplies the f32
// scores, as the reference's f32 q * scale product does up to f32
// rounding.  flash_walk.cuh's walks are f32 only.  Every entry point takes
// the head width d_head after the heads: the f32 kernels take 64 (another
// width returns cudaErrorInvalidValue), the bf16 ones 64 and 128, each
// instantiated on BthdOf<d> or BhtdOf<d> (with_width).
//
// Masking follows the TPU kernels: causal (bottom-right aligned, offset
// tk - tq) and out-of-range keys score -1e30 in the forward; a row whose
// max score is <= -1e29, or that sees no key, gets a zero output and
// lse = +inf, so p = exp(s - lse) = 0 and its gradients are zero in both
// backward kernels.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_bwd_tc.cuh"
#include "flash_tc.cuh"
#include "flash_walk.cuh"

namespace {

// The three passes in f32 on operands of layout L (every tensor of a
// call shares it: q, dout, o and dq have tq rows, k, v, dk and dv tk
// rows).
template <class L>
int run_fwd(L l, const float* q, const float* k, const float* v,
            const float* bias, int64_t bs_b, int64_t bs_h, int64_t bs_q,
            int64_t bs_k, float* o, float* lse, int b, int tq, int tk, int h,
            float scale, int causal, double rate, unsigned seed,
            unsigned threshold, void* stream) {
  return (int)fwd(Rows<L>{q, l}, Rows<L>{k, l}, Rows<L>{v, l},
                  Bias{bias, bs_b, bs_h, bs_q, bs_k}, o, l, lse, b, tq, tk,
                  h, scale, causal,
                  hash_rng::make_dropout(rate, seed, threshold),
                  static_cast<cudaStream_t>(stream));
}

template <class L>
int run_dq(L l, const float* q, const float* k, const float* v,
           const float* bias, int64_t bs_b, int64_t bs_h, int64_t bs_q,
           int64_t bs_k, const float* dout, const float* lse,
           const float* delta, float* dq, int b, int tq, int tk, int h,
           float scale, int causal, double rate, unsigned seed,
           unsigned threshold, void* stream) {
  return (int)bwd_dq(Rows<L>{q, l}, Rows<L>{k, l}, Rows<L>{v, l},
                     Bias{bias, bs_b, bs_h, bs_q, bs_k}, Rows<L>{dout, l},
                     lse, delta, dq, l, b, tq, tk, h, scale, causal,
                     hash_rng::make_dropout(rate, seed, threshold),
                     static_cast<cudaStream_t>(stream));
}

template <class L>
int run_dkv(L l, const float* q, const float* k, const float* v,
            const float* bias, int64_t bs_b, int64_t bs_h, int64_t bs_q,
            int64_t bs_k, const float* dout, const float* lse,
            const float* delta, float* dk, float* dv, int b, int tq, int tk,
            int h, float scale, int causal, double rate, unsigned seed,
            unsigned threshold, void* stream) {
  return (int)bwd_dkv(Rows<L>{q, l}, Rows<L>{k, l}, Rows<L>{v, l},
                      Bias{bias, bs_b, bs_h, bs_q, bs_k}, Rows<L>{dout, l},
                      lse, delta, dk, dv, l, b, tq, tk, h, scale, causal,
                      hash_rng::make_dropout(rate, seed, threshold),
                      static_cast<cudaStream_t>(stream));
}

// The dq walk (walk 0: #6, #8) or the dkv walk (walk 1: #7, #9) in bf16
// on tensor cores, over bf16 rows of layout L (one plane each); dq, or dk
// and dv, rounded to bf16.
template <class L>
int run_bwd_tc(int walk, L l, const bf16* q, const bf16* k, const bf16* v,
               const bf16* bias, int64_t bs_b, int64_t bs_h, int64_t bs_q,
               int64_t bs_k, const bf16* dout, const float* lse,
               const float* delta, bf16* dq, bf16* dk, bf16* dv, int b,
               int tq, int tk, int h, float scale, int causal, double rate,
               unsigned seed, unsigned threshold, void* stream) {
  const FlashBw<L> a{q, k, v, dout,
                     BiasOf<bf16>{bias, bs_b, bs_h, bs_q, bs_k}, lse, delta,
                     dq, dk, dv, tq, tk, h, scale, causal,
                     hash_rng::make_dropout(rate, seed, threshold), l};
  return (int)flash_bwd_tc(walk, a, b, static_cast<cudaStream_t>(stream));
}

// The forward in bf16 on tensor cores over rows of layout L.
template <class L>
int run_fwd_tc(L l, const bf16* q, const bf16* k, const bf16* v,
               const bf16* bias, int64_t bs_b, int64_t bs_h, int64_t bs_q,
               int64_t bs_k, bf16* o, float* lse, int b, int tq, int tk,
               int h, float scale, int causal, double rate, unsigned seed,
               unsigned threshold, void* stream) {
  return (int)fwd_tc(Rows<L, bf16>{q, l}, Rows<L, bf16>{k, l},
                     Rows<L, bf16>{v, l},
                     BiasOf<bf16>{bias, bs_b, bs_h, bs_q, bs_k}, o, l, lse,
                     b, tq, tk, h, scale, causal,
                     hash_rng::make_dropout(rate, seed, threshold),
                     static_cast<cudaStream_t>(stream));
}

// f(the layout of h heads of width d_head): BthdOf, or BhtdOf with BHTD,
// at 64 or 128; cudaErrorInvalidValue at another width.
template <bool BHTD, class F>
int with_width(int h, int d_head, F&& f) {
  if constexpr (BHTD) {
    if (d_head == 64) return f(BhtdOf<64>{h});
    if (d_head == 128) return f(BhtdOf<128>{h});
  } else {
    if (d_head == 64) return f(BthdOf<64>{h * 64});
    if (d_head == 128) return f(BthdOf<128>{h * 128});
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Dynamic shared memory of a walk's block in bytes: the f32 dq walk (0),
// the f32 dkv walk (1), the f32 forward (2) at head width dh 64, or, at dh
// 64 or 128, the bf16 forward on tensor cores (3), the bf16 dq walk on
// tensor cores (4) or its dkv walk (5); 0 for another width.
extern "C" int64_t ptt_flash_walk_smem(int which, int dh) {
  if (dh == 128)
    return (int64_t)(which == 5   ? Bw<false, 128>::kDkvSmem
                     : which == 4 ? Bw<false, 128>::kDqSmem
                     : which == 3 ? FtShape<128>::kSmem
                                  : 0);
  if (dh != 64) return 0;
  return (int64_t)(which == 5   ? Bw<false, 64>::kDkvSmem
                   : which == 4 ? Bw<false, 64>::kDqSmem
                   : which == 3 ? kFwdTcSmem
                   : which == 2 ? kFwdSmem
                   : which      ? kDkvSmem
                                : kDqSmem);
}

// #4.  q [b, tq, h, 64], k and v [b, tk, h, 64], o like q, lse [b, h, tq];
// all contiguous f32.  bias may be null; otherwise its element (b, h, q, k)
// lies at b*bs_b + h*bs_h + q*bs_q + k*bs_k.  d_head is 64 (another width
// returns cudaErrorInvalidValue; the caller checks it).  rate 0 runs
// without dropout; otherwise weights are kept where the hash of (seed,
// b*h + head, q*tk + k) >= threshold (tq*tk <= 2^32, checked by the
// caller).
extern "C" int ptt_flash_fwd(const float* q, const float* k, const float* v,
                             const float* bias, int64_t bs_b, int64_t bs_h,
                             int64_t bs_q, int64_t bs_k, float* o,
                             float* lse, int b, int tq, int tk, int h,
                             int d_head, float scale, int causal,
                             double rate, unsigned seed, unsigned threshold,
                             void* stream) {
  if (d_head != DH) return (int)cudaErrorInvalidValue;
  return run_fwd(Bthd{h * DH}, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, o,
                 lse, b, tq, tk, h, scale, causal, rate, seed, threshold,
                 stream);
}

// #6.  dout like q; lse and delta = rowsum(dout * o) [b, h, tq]; dq like
// q; the forward's dropout arguments.
extern "C" int ptt_flash_bwd_dq(const float* q, const float* k,
                                const float* v, const float* bias,
                                int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                int64_t bs_k, const float* dout,
                                const float* lse, const float* delta,
                                float* dq, int b, int tq, int tk, int h,
                                int d_head, float scale, int causal,
                                double rate, unsigned seed,
                                unsigned threshold, void* stream) {
  if (d_head != DH) return (int)cudaErrorInvalidValue;
  return run_dq(Bthd{h * DH}, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, dout,
                lse, delta, dq, b, tq, tk, h, scale, causal, rate, seed,
                threshold, stream);
}

// #7.  As ptt_flash_bwd_dq; dk and dv like k.
extern "C" int ptt_flash_bwd_dkv(const float* q, const float* k,
                                 const float* v, const float* bias,
                                 int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                 int64_t bs_k, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dk, float* dv, int b, int tq, int tk,
                                 int h, int d_head, float scale, int causal,
                                 double rate, unsigned seed,
                                 unsigned threshold, void* stream) {
  if (d_head != DH) return (int)cudaErrorInvalidValue;
  return run_dkv(Bthd{h * DH}, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, dout,
                 lse, delta, dk, dv, b, tq, tk, h, scale, causal, rate, seed,
                 threshold, stream);
}

// #5.  As ptt_flash_fwd over [b, h, t, 64] tensors: q and o [b, h, tq, 64],
// k and v [b, h, tk, 64]; lse [b, h, tq].
extern "C" int ptt_flash_fwd_bhtd(const float* q, const float* k,
                                  const float* v, const float* bias,
                                  int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                  int64_t bs_k, float* o, float* lse, int b,
                                  int tq, int tk, int h, int d_head,
                                  float scale, int causal, double rate,
                                  unsigned seed, unsigned threshold,
                                  void* stream) {
  if (d_head != DH) return (int)cudaErrorInvalidValue;
  return run_fwd(Bhtd{h}, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, o, lse, b,
                 tq, tk, h, scale, causal, rate, seed, threshold, stream);
}

// #8.  As ptt_flash_bwd_dq over [b, h, t, 64] tensors.
extern "C" int ptt_flash_bwd_dq_bhtd(const float* q, const float* k,
                                     const float* v, const float* bias,
                                     int64_t bs_b, int64_t bs_h,
                                     int64_t bs_q, int64_t bs_k,
                                     const float* dout, const float* lse,
                                     const float* delta, float* dq,
                                     int b, int tq, int tk, int h,
                                     int d_head, float scale, int causal,
                                     double rate, unsigned seed,
                                     unsigned threshold, void* stream) {
  if (d_head != DH) return (int)cudaErrorInvalidValue;
  return run_dq(Bhtd{h}, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, dout, lse,
                delta, dq, b, tq, tk, h, scale, causal, rate, seed,
                threshold, stream);
}

// #9.  As ptt_flash_bwd_dkv over [b, h, t, 64] tensors.
extern "C" int ptt_flash_bwd_dkv_bhtd(const float* q, const float* k,
                                      const float* v, const float* bias,
                                      int64_t bs_b, int64_t bs_h,
                                      int64_t bs_q, int64_t bs_k,
                                      const float* dout,
                                      const float* lse,
                                      const float* delta, float* dk,
                                      float* dv, int b, int tq, int tk,
                                      int h, int d_head, float scale,
                                      int causal, double rate, unsigned seed,
                                      unsigned threshold, void* stream) {
  if (d_head != DH) return (int)cudaErrorInvalidValue;
  return run_dkv(Bhtd{h}, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, dout, lse,
                 delta, dk, dv, b, tq, tk, h, scale, causal, rate, seed,
                 threshold, stream);
}

// #4 in bf16 (amp): as ptt_flash_fwd with q, k, v, the bias and o bf16,
// lse f32, on tensor cores (flash_tc.cuh), at d_head 64 or 128.
extern "C" int ptt_flash_fwd_bf16(const bf16* q, const bf16* k,
                                  const bf16* v, const bf16* bias,
                                  int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                  int64_t bs_k, bf16* o, float* lse, int b,
                                  int tq, int tk, int h, int d_head,
                                  float scale, int causal, double rate,
                                  unsigned seed, unsigned threshold,
                                  void* stream) {
  return with_width<false>(h, d_head, [&](auto l) {
    return run_fwd_tc(l, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, o, lse, b,
                      tq, tk, h, scale, causal, rate, seed, threshold,
                      stream);
  });
}

// #6 in bf16: as ptt_flash_bwd_dq with dout and dq bf16, lse and delta
// f32, on tensor cores (flash_bwd_tc.cuh), at d_head 64 or 128.
extern "C" int ptt_flash_bwd_dq_bf16(const bf16* q, const bf16* k,
                                     const bf16* v, const bf16* bias,
                                     int64_t bs_b, int64_t bs_h,
                                     int64_t bs_q, int64_t bs_k,
                                     const bf16* dout, const float* lse,
                                     const float* delta, bf16* dq, int b,
                                     int tq, int tk, int h, int d_head,
                                     float scale, int causal, double rate,
                                     unsigned seed, unsigned threshold,
                                     void* stream) {
  return with_width<false>(h, d_head, [&](auto l) {
    return run_bwd_tc(0, l, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, dout,
                      lse, delta, dq, nullptr, nullptr, b, tq, tk, h, scale,
                      causal, rate, seed, threshold, stream);
  });
}

// #7 in bf16: as ptt_flash_bwd_dkv with dout, dk and dv bf16, on tensor
// cores, at d_head 64 or 128.
extern "C" int ptt_flash_bwd_dkv_bf16(const bf16* q, const bf16* k,
                                      const bf16* v, const bf16* bias,
                                      int64_t bs_b, int64_t bs_h,
                                      int64_t bs_q, int64_t bs_k,
                                      const bf16* dout, const float* lse,
                                      const float* delta, bf16* dk,
                                      bf16* dv, int b, int tq, int tk, int h,
                                      int d_head, float scale, int causal,
                                      double rate, unsigned seed,
                                      unsigned threshold, void* stream) {
  return with_width<false>(h, d_head, [&](auto l) {
    return run_bwd_tc(1, l, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, dout,
                      lse, delta, nullptr, dk, dv, b, tq, tk, h, scale,
                      causal, rate, seed, threshold, stream);
  });
}

// #5 in bf16 (amp): as ptt_flash_fwd_bhtd with q, k, v, the bias and o
// bf16 [b, h, t, d_head], lse f32, on tensor cores (flash_tc.cuh on
// BhtdOf), at d_head 64 or 128.
extern "C" int ptt_flash_fwd_bhtd_bf16(const bf16* q, const bf16* k,
                                       const bf16* v, const bf16* bias,
                                       int64_t bs_b, int64_t bs_h,
                                       int64_t bs_q, int64_t bs_k, bf16* o,
                                       float* lse, int b, int tq, int tk,
                                       int h, int d_head, float scale,
                                       int causal, double rate, unsigned seed,
                                       unsigned threshold, void* stream) {
  return with_width<true>(h, d_head, [&](auto l) {
    return run_fwd_tc(l, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, o, lse, b,
                      tq, tk, h, scale, causal, rate, seed, threshold,
                      stream);
  });
}

// #8 in bf16: as ptt_flash_bwd_dq_bhtd with dout and dq bf16, lse and
// delta f32, on tensor cores (flash_bwd_tc.cuh on BhtdOf), at d_head 64
// or 128.
extern "C" int ptt_flash_bwd_dq_bhtd_bf16(const bf16* q, const bf16* k,
                                          const bf16* v, const bf16* bias,
                                          int64_t bs_b, int64_t bs_h,
                                          int64_t bs_q, int64_t bs_k,
                                          const bf16* dout, const float* lse,
                                          const float* delta, bf16* dq,
                                          int b, int tq, int tk, int h,
                                          int d_head, float scale,
                                          int causal, double rate,
                                          unsigned seed, unsigned threshold,
                                          void* stream) {
  return with_width<true>(h, d_head, [&](auto l) {
    return run_bwd_tc(0, l, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, dout,
                      lse, delta, dq, nullptr, nullptr, b, tq, tk, h, scale,
                      causal, rate, seed, threshold, stream);
  });
}

// #9 in bf16: as ptt_flash_bwd_dkv_bhtd with dout, dk and dv bf16, on
// tensor cores, at d_head 64 or 128.
extern "C" int ptt_flash_bwd_dkv_bhtd_bf16(const bf16* q, const bf16* k,
                                           const bf16* v, const bf16* bias,
                                           int64_t bs_b, int64_t bs_h,
                                           int64_t bs_q, int64_t bs_k,
                                           const bf16* dout,
                                           const float* lse,
                                           const float* delta, bf16* dk,
                                           bf16* dv, int b, int tq, int tk,
                                           int h, int d_head, float scale,
                                           int causal, double rate,
                                           unsigned seed, unsigned threshold,
                                           void* stream) {
  return with_width<true>(h, d_head, [&](auto l) {
    return run_bwd_tc(1, l, q, k, v, bias, bs_b, bs_h, bs_q, bs_k, dout,
                      lse, delta, nullptr, dk, dv, b, tq, tk, h, scale,
                      causal, rate, seed, threshold, stream);
  });
}
