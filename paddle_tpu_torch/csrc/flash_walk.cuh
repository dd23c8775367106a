// Flash-attention walks: the forward and the two backward passes in f32,
// for sm_90a.
//
// Shared by the flash kernels (flash_attention.cu: the forward #4 / #5 and
// the backward #6, #7 / #8, #9) and the fused-projection backward in f32
// (qkv_attention_bwd.cu: #2 and #3 walk the rows their projection GEMM
// wrote).  The bf16 instantiations of these kernels (amp) run on tensor
// cores in kernels of their own: the forward in flash_tc.cuh, both
// backward walks (#6, #7 and the pair's) in flash_bwd_tc.cuh, which take
// the head width (64 or 128) from the layout (BthdOf<W>, BhtdOf<W>); the
// f32 walks here take 64 (Bthd, Bhtd).  Rows are
// addressed through a layout, a template parameter: Bthd
// reads q, k, v from [b, t, h, 64] tensors (row stride h * 64) or from the
// q|k|v columns of a [b * t, 3hd] projection (row stride 3hd); Bhtd from
// [b, h, t, 64] tensors, whose heads are contiguous [t, 64] slabs.  The
// layout changes the addresses only, never the arithmetic or its order:
//
//   fwd   o = softmax(q k^T * scale + bias) v,  lse = m + log(l) per row
//   dq    dq = sum_k p (dp - delta) * scale * k,  p = exp(s - lse)
//         recomputed from lse, dp = dO v^T, delta = rowsum(dO * o)
//   dkv   dv = sum_q p^T dO,  dk = sum_q (p (dp - delta) * scale)^T q
//
// Weights dropout (the DROP instantiations): the forward keeps p where
// hash_rng::keep_attn of the block's head seed at q * tk + k says so (l
// sums the undropped p, o is scaled by 1 / (1 - rate)); with that mask dp
// becomes keep ? dp * inv_keep : 0 in both backward walks, and dv sums
// (keep ? p * inv_keep : 0)^T dO, while ds keeps the undropped p; delta is
// then rowsum(dO * o) of the dropped output.  At rate 0 the callers launch
// the instantiation without the hash.
//
// Grid: the forward and dq take one block per (128-row q tile, head, batch
// row) and walk the k tiles, 64 rows a step; dkv one block per (128-row k
// tile, head, batch row) and walks the q tiles, 64 rows a step.  Every
// output element belongs to one block, which sums in a fixed order: no
// atomics, and the results are the same from run to run.
//
// Tiles: 256 threads, one block an SM.  Every tile product of a walk is a
// [128, 64] tile over a 64-deep sum (walk_mma): each thread owns an 8x4
// patch, rows ty + 16i, and reads its A rows as float4 along the sum; B is
// read either along the sum too (s = q k^T, dp = dO v^T and their
// transposes: columns tx + 16j) or along its rows (dq += ds k, dv += p^T
// dO, dk += ds^T q: columns 4tx..).  So every operand tile is staged once,
// as it lies in memory.  Per 4-deep slice a thread makes 12 conflict-free
// float4 reads (row strides 68 and 72) for 128 FMAs: 2.67 FMAs per word
// read, against a 4x4 patch's 2.  An SM's shared memory returns 32
// words a clock to 128 FMA lanes, so this holds a product to two thirds
// of the FMA rate.  An 8x8 patch (4 FMAs a word) needs 64 more
// accumulators a thread than the 246-254 registers these walks take, past
// the 255 a thread can have (its trials ran slower: PERF.md).
//
// Loads: 16-byte cp.async into a ring of two stages, the next step's k
// and v (the forward's with its bias, and dq's) or q, dO, lse and delta
// (dkv) in flight while this step computes; rows past t come in as zeros
// through cp.async's source size.
// A block's first loads come in two groups: s's (or s^T's) operands
// first, the rest while that product runs.  An additive bias is staged per
// step by cp.async, row by row as it lies in memory (16 bytes a copy where
// its rows allow, a bias broadcast along q stages one row), after this
// step's scores have consumed the last one.
//
// The forward's online softmax: a row's 16 threads are 8 lanes of each of
// two warps (a warp pair, threads 64p..), which exchange the row's
// maximum and sum of a k tile through shared memory under their own named
// barrier; p goes to its shared tile once a tile, which p v reads.
//
// Shared memory: kFwdSmem (q, two k/v and two bias stages, p, the pair's
// row maxima), kDqSmem (q, dO, two k/v stages, ds, bias) and kDkvSmem
// (k, v, two q/dO stages, p^T, one buffer for the bias and then ds^T,
// lse and delta): 211, 208 and 209 KB (KB = 1024 bytes).  At DH 128 the
// forward would take 307 KB and the dkv tile 337 KB, above a block's 227:
// the forward would fit in 205 KB with one k/v stage and one bias buffer,
// dkv with 64-row k tiles and one stage (169 KB).
//
// Bound: f32 FMA work on the CUDA cores (TF32 off): 4, 6 and 8 *
// b*h*tq*tk*64 FLOPs for the forward, dq and dkv against 67 TFLOP/s.  No
// tensor cores, no TMA: later work.
//
// Masking: causal keys (bottom-right aligned, offset tk - tq) and keys past
// tk give p = 0; a row masked in the forward has lse = +inf, so p = 0 and
// its gradients are zero.  Rows past t in a ragged tile load as zeros.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtype.cuh"
#include "hash_rng.cuh"

namespace {

using hash_rng::Dropout;

constexpr int BT = 64;      // rows of a q or k tile
constexpr int DH = 64;      // head width
constexpr int NT = 256;     // threads per block

// The walks' tiles (the forward's and both backward ones).
constexpr int WM = 128;       // rows a walk block owns
constexpr int WN = BT;        // rows of a tile it walks
constexpr int TS = DH + 4;    // row stride of q, k, v, dO tiles
constexpr int PS = WN + 8;    // row stride of p, ds and the dq bias tile
constexpr int QBS = WM + 4;   // row stride of the dkv bias tile [WN][WM]
constexpr int kOwnTile = WM * TS;  // floats
constexpr int kWalkTile = WN * TS;
constexpr int kPTile = WM * PS;
static_assert(WN * QBS <= kPTile, "the dkv bias tile fits its buffer");
constexpr size_t kDqSmem =
    (2 * kOwnTile + 4 * kWalkTile + 2 * kPTile) * sizeof(float);
constexpr size_t kDkvSmem =
    (2 * kOwnTile + 4 * kWalkTile + 2 * kPTile + 4 * WN) * sizeof(float);
//: the forward: q, two stages of k, v and the bias, p, and the half-row
//: maxima a warp pair exchanges ([2][16][8])
constexpr int kFwdMax = 2 * 16 * 8;
constexpr size_t kFwdSmem =
    (kOwnTile + 4 * kWalkTile + 3 * kPTile + kFwdMax) * sizeof(float);

//: the forward's score of a masked or out-of-range key
constexpr float kMaskValue = -1e30f;

// Additive bias of T elements broadcast to [b, h, tq, tk] through its four
// strides (a broadcast dim has stride 0); p == nullptr means no bias.
template <class T = float>
struct BiasOf {
  const T* p;
  int64_t sb, sh, sq, sk;
};
using Bias = BiasOf<float>;

// Layout of a [b * t, ld] matrix of heads W wide: head `head` of row r of
// batch row bi starts at (bi * t + r) * ld + head * W.  The f32 walks take
// W = 64 (Bthd); the tensor-core kernels (flash_tc.cuh, flash_bwd_tc.cuh)
// read their head width from the layout, 64 or 128.
template <int W>
struct BthdOf {
  static constexpr int kWidth = W;
  int ld;
  __device__ __forceinline__ size_t at(int bi, int t, int r,
                                       int head) const {
    return ((size_t)bi * t + r) * ld + head * W;
  }
};
using Bthd = BthdOf<DH>;

// Layout of a [b, h, t, W] tensor of h heads: row r of head `head` of
// batch row bi starts at ((bi * h + head) * t + r) * W.
template <int W>
struct BhtdOf {
  static constexpr int kWidth = W;
  int h;
  __device__ __forceinline__ size_t at(int bi, int t, int r,
                                       int head) const {
    return (((size_t)bi * h + head) * t + r) * W;
  }
};
using Bhtd = BhtdOf<DH>;

// The rows of one operand of T elements: its base pointer and its layout.
template <class L, class T = float>
struct Rows {
  const T* p;
  L l;
  __device__ __forceinline__ const T* at(int bi, int t, int r,
                                         int head) const {
    return p + l.at(bi, t, r, head);
  }
};

// 64-row k tiles a q tile of `rows` rows starting at q0 walks: all, or
// under the causal mask only those with a key at or before the tile's
// last query + offset.
__device__ __forceinline__ int kv_tiles(int q0, int tq, int tk, int causal,
                                        int rows) {
  int n = (tk + BT - 1) / BT;
  if (causal) {
    const int hi = min(q0 + rows, tq) - 1 + (tk - tq);
    n = hi < 0 ? 0 : min(n, hi / BT + 1);
  }
  return n;
}

// Seed of this block's head under weights dropout (0 without).
template <bool DROP>
__device__ __forceinline__ uint32_t block_head_seed(const Dropout& drop,
                                                    int bi, int h,
                                                    int head) {
  return DROP ? hash_rng::attn_head_seed(drop.seed, (uint32_t)(bi * h + head))
              : 0u;
}

// ---------------------------------------------------------------------------
// The walks
// ---------------------------------------------------------------------------

// 16-byte cp.async into shared memory: `bytes` (16 or 0) of them read from
// src, the rest zero-filled.
__device__ __forceinline__ void async_copy16(float* dst, const float* src,
                                             int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// 4-byte cp.async: `bytes` (4 or 0) read from src, the rest zero-filled.
__device__ __forceinline__ void async_copy4(float* dst, const float* src,
                                            int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A walk thread's place in every [WM, 64] tile product: rows ty + 16i
// (i < 8), columns tx + 16j or 4tx + j (j < 4).  A warp holds 4
// consecutive ty and 8 consecutive tx.
__device__ __forceinline__ int walk_ty() {
  return 4 * (threadIdx.x >> 6) + ((threadIdx.x >> 3) & 3);
}

__device__ __forceinline__ int walk_tx() {
  return 8 * ((threadIdx.x >> 5) & 1) + (threadIdx.x & 7);
}

// Start the copy of rows [r0, r0 + R) of head `head` of src into dst (row
// stride TS) by cp.async; rows at or past t come in as zeros.
template <int R, class L>
__device__ __forceinline__ void stage_rows(float* dst, Rows<L> src, int bi,
                                           int r0, int t, int head) {
#pragma unroll
  for (int u = 0; u < R * (DH / 4) / NT; ++u) {
    const int idx = threadIdx.x + u * NT;
    const int row = idx / (DH / 4);
    const int c4 = idx % (DH / 4);
    const bool in = r0 + row < t;
    async_copy16(dst + row * TS + c4 * 4,
                 src.at(bi, t, in ? r0 + row : r0, head) + c4 * 4,
                 in ? 16 : 0);
  }
}

// Start the copy of [tq] rows (lse or delta of one head) q0.. into dst
// (WN floats); rows past tq come in as zeros.  Threads [first, first + WN).
__device__ __forceinline__ void stage_stats(float* dst, const float* src,
                                            int q0, int tq, int first) {
  const int r = threadIdx.x - first;
  if (r >= 0 && r < WN) {
    const bool in = q0 + r < tq;
    async_copy4(dst + r, src + (in ? q0 + r : q0), in ? 4 : 0);
  }
}

// Start the copy of the bias of queries [q0, q0 + NQ) x keys [k0, k0 +
// NK) of one head into dst[(q - q0) * ld + k - k0], consecutive threads on
// consecutive keys (the bias's rows as they lie in memory); a bias
// broadcast along q (sq == 0) stages its one row.  Zero outside [tq] x
// [tk].  Rows of contiguous keys, 16-byte aligned, come in 16 bytes a
// copy, any other bias element by element.
template <int NQ, int NK>
__device__ __forceinline__ void stage_bias(float* dst, int ld,
                                           const Bias& bias, int bi,
                                           int head, int q0, int tq, int k0,
                                           int tk) {
  const float* base = bias.p + bi * bias.sb + head * bias.sh;
  const int rows = bias.sq ? NQ : 1;
  if (bias.sk == 1 && bias.sq % 4 == 0 && tk % 4 == 0 &&
      reinterpret_cast<uintptr_t>(base) % 16 == 0) {
    for (int idx = threadIdx.x; idx < rows * (NK / 4); idx += NT) {
      const int r = idx / (NK / 4);
      const int c = idx % (NK / 4) * 4;
      const bool in = q0 + r < tq && k0 + c < tk;
      async_copy16(dst + r * ld + c,
                   base + (in ? (q0 + r) * bias.sq + k0 + c : 0),
                   in ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * NK; idx += NT) {
    const int q = q0 + idx / NK;
    const int k = k0 + idx % NK;
    const bool in = q < tq && k < tk;
    async_copy4(dst + (idx / NK) * ld + idx % NK,
                base + (in ? q * bias.sq + k * bias.sk : 0), in ? 4 : 0);
  }
}

// Which rows of a [WM, 64] tile product a walk_mma computes: all, or
// only the first or the last 64 (rows ty + 16i for i < 4 or i >= 4).
enum WalkRows { kAllRows, kLowRows, kHighRows };

// c[i][j] += sum over kk < 64 of A(ty + 16i, kk) B(kk, col j), summed in
// increasing kk, for the rows ROWS selects.  A is row-major (row stride
// lda), read as float4 along kk.  With BT_ (B read along the sum) B(kk,
// n) = B[n * ldb + kk] and col j = tx + 16j; else B(kk, n) = B[kk * ldb +
// n] and col j = 4tx + j.
template <bool BT_, WalkRows ROWS = kAllRows>
__device__ __forceinline__ void walk_mma(const float* A, int lda,
                                         const float* B, int ldb,
                                         float (&c)[8][4]) {
  constexpr int i0 = ROWS == kHighRows ? 4 : 0;
  constexpr int i1 = ROWS == kLowRows ? 4 : 8;
  const int ty = walk_ty();
  const int tx = walk_tx();
  // 4 slices an iteration: the fastest of 1, 2, 4 and 16 on an H100 (16
  // overflow the instruction cache)
#pragma unroll 4
  for (int k0 = 0; k0 < DH; k0 += 4) {
    float a[8][4];
#pragma unroll
    for (int i = i0; i < i1; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(A + (ty + 16 * i) * lda + k0);
      a[i][0] = t.x; a[i][1] = t.y; a[i][2] = t.z; a[i][3] = t.w;
    }
    float b[4][4];  // b[kk][j]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(
          BT_ ? B + (tx + 16 * j) * ldb + k0 : B + (k0 + j) * ldb + 4 * tx);
      if (BT_) {
        b[0][j] = t.x; b[1][j] = t.y; b[2][j] = t.z; b[3][j] = t.w;
      } else {
        b[j][0] = t.x; b[j][1] = t.y; b[j][2] = t.z; b[j][3] = t.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = i0; i < i1; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) c[i][j] += a[i][kk] * b[kk][j];
  }
}

__device__ __forceinline__ void zero_patch(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// Store a walk thread's patch of a [WM, 64] tile (rows ty + 16i, columns
// 4tx..) into rows r0 + ty + 16i (below t) of head `head` of dst.
template <class L>
__device__ __forceinline__ void store_walk_rows(float* dst, L l,
                                                const float (&c)[8][4],
                                                int bi, int r0, int t,
                                                int head) {
  const int ty = walk_ty();
  const int tx = walk_tx();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r < t)
      store4(dst + l.at(bi, t, r, head) + tx * 4,
             make_float4(c[i][0], c[i][1], c[i][2], c[i][3]));
  }
}

// Barrier of the two warps that own rows ty of every walk tile (threads
// 64p .. 64p + 63 share ty = 4p.., one warp each half of the columns):
// named barrier 1 + p.
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + (threadIdx.x >> 6))
               : "memory");
}

// The forward of one (128-row q tile, head, batch row): o = softmax(q k^T
// * scale + bias) v and lse, walking the 64-row k tiles with an online
// softmax; o laid out by o_l, lse [b, h, tq].  Each thread owns rows ty +
// 16i of the tile: keys tx + 16j of s = q k^T (walk_mma<true>: both
// operands read along the head) and head columns 4tx.. of acc += p v
// (walk_mma<false>, p from p_s).  A row's 16 threads are two warps' 8
// lanes: the row maximum of a k tile is taken over the 8 lanes by
// shuffles and over the two halves through mx_s under the pair's barrier.
// A tile's row sum rs of p is added in a fixed order, that of a 16-lane
// sweep in which lane T holds keys 4T.. (summed in order) and lanes are
// added at distance 8, 4, 2, 1: thread tx reads lane T's keys from p_s,
// with T = tx with bits 0 and 3 swapped, so that the first three steps
// are shuffles within its warp and the last goes through mx_s.  That order
// is the one a row held by one half warp (4 keys a thread) gives, so with
// the head width's scale a power of two (1/8) o and lse do not depend on
// how many rows a block owns: the f32 training steps, held to float64 at
// twice the CPU's own error, see the same rounding as with 64-row blocks.
template <class L, bool DROP>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias, float* o,
                 L o_l, float* __restrict__ lse, int tq, int tk, int h,
                 float scale, int causal, Dropout drop) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // [WM][TS] q
  float* kv_s = q_s + kOwnTile;        // two stages of [WN][TS] k, v
  float* p_s = kv_s + 4 * kWalkTile;   // [WM][PS] p of one k tile
  float* bias_s = p_s + kPTile;        // two stages of [WM][PS] bias
  float* mx_s = bias_s + 2 * kPTile;   // [2 halves][16 ty][8 i] maxima,
                                       // then sums

  const int q0 = blockIdx.x * WM;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int ty = walk_ty();
  const int tx = walk_tx();
  const int half = (threadIdx.x >> 5) & 1;
  const int offset = tk - tq;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);
  const int brow = bias.sq ? PS : 0;  // a broadcast bias has one row
  const int n_kv = kv_tiles(q0, tq, tk, causal, WM);

  float m[8], l[8], acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  zero_patch(acc);
  if (n_kv > 0) {  // s's operands and the bias first, v while s is computed
    stage_rows<WM>(q_s, q, bi, q0, tq, head);
    stage_rows<WN>(kv_s, k, bi, 0, tk, head);
    if (bias.p) stage_bias<WM, WN>(bias_s, PS, bias, bi, head, q0, tq, 0, tk);
    async_commit();
    stage_rows<WN>(kv_s + kWalkTile, v, bi, 0, tk, head);
    async_commit();
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * WN;
    const int slot = kt & 1;
    const float* k_s = kv_s + slot * 2 * kWalkTile;
    const float* v_s = k_s + kWalkTile;
    const float* b_s = bias_s + slot * kPTile;
    const bool more = kt + 1 < n_kv;
    if (kt == 0)
      async_wait<1>();
    else
      async_wait<0>();
    __syncthreads();  // this step's k and bias have landed; the last
                      // step's stage, p_s and mx_s are consumed
    if (more) {  // the next k, v and bias into the stage the last step left
      float* next = kv_s + (slot ^ 1) * 2 * kWalkTile;
      stage_rows<WN>(next, k, bi, k0 + WN, tk, head);
      stage_rows<WN>(next + kWalkTile, v, bi, k0 + WN, tk, head);
      if (bias.p)
        stage_bias<WM, WN>(bias_s + (slot ^ 1) * kPTile, PS, bias, bi, head,
                           q0, tq, k0 + WN, tk);
      async_commit();
    }
    // a half of the block whose rows see none of this tile's keys skips
    // both products: the last 64 rows when they lie past tq, the first
    // 64 when the causal mask hides the whole tile from them (their
    // scores are masked below, so their p is 0 or, in a row that has seen
    // no key yet, leaves it masked)
    const WalkRows rows = q0 + WN >= tq ? kLowRows
                          : causal && q0 + WN - 1 + offset < k0 ? kHighRows
                                                                 : kAllRows;
    float s[8][4];
    zero_patch(s);
    if (rows == kAllRows)
      walk_mma<true>(q_s, TS, k_s, TS, s);
    else if (rows == kLowRows)
      walk_mma<true, kLowRows>(q_s, TS, k_s, TS, s);
    else
      walk_mma<true, kHighRows>(q_s, TS, k_s, TS, s);
    float mx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty + 16 * i;
      mx[i] = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float sv = s[i][j] * scale;
        if (kpos >= tk || (causal && qpos + offset < kpos))
          sv = kMaskValue;
        else if (bias.p)
          sv += b_s[(ty + 16 * i) * brow + tx + 16 * j];
        s[i][j] = sv;
        mx[i] = fmaxf(mx[i], sv);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }
    if ((threadIdx.x & 7) == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) mx_s[(half * 16 + ty) * 8 + i] = mx[i];
    }
    pair_sync();  // both halves' maxima of the pair's rows are in mx_s
    float alpha[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float m_new = fmaxf(
          m[i], fmaxf(mx[i], mx_s[((half ^ 1) * 16 + ty) * 8 + i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= alpha[i];
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = expf(s[i][j] - m_new);
      }
    }
    pair_sync();  // the pair's rows of p (undropped) are whole
    // rs of each row: lane T = tx with bits 0 and 3 swapped sums its keys
    // 4T.. in order; lanes T ^ 8, ^ 4, ^ 2 are lanes tx ^ 1, ^ 4, ^ 2 of
    // this warp, T ^ 1 the other half's (through mx_s, free again: its
    // maxima were read before the barrier)
    const int lane_t = (tx & 6) | (tx & 1) << 3 | tx >> 3;
    float rs[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(
          p_s + (ty + 16 * i) * PS + 4 * lane_t);
      rs[i] = ((p4.x + p4.y) + p4.z) + p4.w;
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 4);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
    }
    if ((threadIdx.x & 7) == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) mx_s[(half * 16 + ty) * 8 + i] = rs[i];
    }
    if (DROP) {  // p v takes the dropped p, once every rs has read p_s
      pair_sync();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t plane = (uint32_t)(q0 + ty + 16 * i) * tk + k0 + tx;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!hash_rng::keep_attn(hseed, plane + 16 * j, drop.threshold))
            p_s[(ty + 16 * i) * PS + tx + 16 * j] = 0.f;
      }
    }
    if (kt == 0) {  // v of the first step, for the whole block
      if (more)
        async_wait<1>();
      else
        async_wait<0>();
      __syncthreads();
    } else {
      pair_sync();  // the pair's rows of p_s and their rs halves are whole
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      l[i] = l[i] * alpha[i] +
             (rs[i] + mx_s[((half ^ 1) * 16 + ty) * 8 + i]);
    if (rows == kAllRows)
      walk_mma<false>(p_s, PS, v_s, TS, acc);
    else if (rows == kLowRows)
      walk_mma<false, kLowRows>(p_s, PS, v_s, TS, acc);
    else
      walk_mma<false, kHighRows>(p_s, PS, v_s, TS, acc);
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool masked = (l[i] == 0.f) || (m[i] <= -1e29f);
    const float inv = DROP ? drop.inv_keep / l[i] : 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = masked ? 0.f : acc[i][j] * inv;
    const int qpos = q0 + ty + 16 * i;
    if (tx == 0 && qpos < tq)
      lse[((size_t)bi * h + head) * tq + qpos] =
          masked ? INFINITY : m[i] + logf(l[i]);
  }
  store_walk_rows(o, o_l, acc, bi, q0, tq, head);
}

// dq of one (128-row q tile, head, batch row); lse and delta [b, h, tq];
// dq laid out by dq_l.
template <class L, bool DROP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias,
                    Rows<L> dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* dq, L dq_l,
                    int tq, int tk, int h, float scale, int causal,
                    Dropout drop) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // [WM][TS] q
  float* do_s = q_s + kOwnTile;        // [WM][TS] dO
  float* kv_s = do_s + kOwnTile;       // two stages of [WN][TS] k, v
  float* ds_s = kv_s + 4 * kWalkTile;  // [WM][PS] ds of one k tile
  float* bias_s = ds_s + kPTile;       // [WM][PS] bias of one k tile

  const int q0 = blockIdx.x * WM;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int ty = walk_ty();
  const int tx = walk_tx();
  const int offset = tk - tq;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);
  const int brow = bias.sq ? PS : 0;  // a broadcast bias has one row
  const int n_kv = kv_tiles(q0, tq, tk, causal, WM);

  float lse_r[8], delta_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qpos = q0 + ty + 16 * i;
    const size_t at = ((size_t)bi * h + head) * tq + qpos;
    lse_r[i] = qpos < tq ? lse[at] : INFINITY;
    delta_r[i] = qpos < tq ? delta[at] : 0.f;
  }
  float acc[8][4];
  zero_patch(acc);
  if (n_kv > 0) {  // s's operands first, the rest while s is computed
    stage_rows<WM>(q_s, q, bi, q0, tq, head);
    stage_rows<WN>(kv_s, k, bi, 0, tk, head);
    async_commit();
    stage_rows<WM>(do_s, dout, bi, q0, tq, head);
    stage_rows<WN>(kv_s + kWalkTile, v, bi, 0, tk, head);
    if (bias.p) stage_bias<WM, WN>(bias_s, PS, bias, bi, head, q0, tq, 0, tk);
    async_commit();
    async_wait<1>();
    __syncthreads();
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * WN;
    const float* k_s = kv_s + (kt & 1) * 2 * kWalkTile;
    const float* v_s = k_s + kWalkTile;
    const bool more = kt + 1 < n_kv;
    if (more) {  // the next k, v into the stage the last step left
      float* next = kv_s + ((kt + 1) & 1) * 2 * kWalkTile;
      stage_rows<WN>(next, k, bi, k0 + WN, tk, head);
      stage_rows<WN>(next + kWalkTile, v, bi, k0 + WN, tk, head);
      async_commit();
    }
    float s[8][4], dp[8][4];
    zero_patch(s);
    zero_patch(dp);
    walk_mma<true>(q_s, TS, k_s, TS, s);
    if (kt == 0) {  // dO, v and the bias of the first step
      if (more)
        async_wait<1>();
      else
        async_wait<0>();
      __syncthreads();
    }
    walk_mma<true>(do_s, TS, v_s, TS, dp);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float p = 0.f;
        if (qpos < tq && kpos < tk && !(causal && qpos + offset < kpos)) {
          float sv = s[i][j] * scale;
          if (bias.p) sv += bias_s[(ty + 16 * i) * brow + tx + 16 * j];
          p = expf(sv - lse_r[i]);
        }
        float dpv = dp[i][j];
        if (DROP)
          dpv = hash_rng::keep_attn(hseed, (uint32_t)qpos * tk + kpos,
                                    drop.threshold)
                    ? dpv * drop.inv_keep : 0.f;
        ds_s[(ty + 16 * i) * PS + tx + 16 * j] =
            p * (dpv - delta_r[i]) * scale;
      }
    }
    __syncthreads();  // ds_s is whole; bias_s is consumed
    if (more && bias.p) {
      stage_bias<WM, WN>(bias_s, PS, bias, bi, head, q0, tq, k0 + WN, tk);
      async_commit();
    }
    walk_mma<false>(ds_s, PS, k_s, TS, acc);
    async_wait<0>();
    __syncthreads();  // the next stage has landed; this one is consumed
  }
  store_walk_rows(dq, dq_l, acc, bi, q0, tq, head);
}

// dk and dv of one (128-row k tile, head, batch row), both laid out by
// dkv_l.
template <class L, bool DROP>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_kernel(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias,
                     Rows<L> dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* dk, float* dv,
                     L dkv_l, int tq, int tk, int h, float scale,
                     int causal, Dropout drop) {
  extern __shared__ float smem[];
  float* k_s = smem;                   // [WM][TS] k
  float* v_s = k_s + kOwnTile;         // [WM][TS] v
  float* qd_s = v_s + kOwnTile;        // two stages of [WN][TS] q, dO
  float* p_s = qd_s + 4 * kWalkTile;   // [WM][PS] p^T of one q tile
  float* bd_s = p_s + kPTile;          // [WN][QBS] bias, then [WM][PS] ds^T
  float* st_s = bd_s + kPTile;         // two stages of [WN] lse, delta

  const int k0 = blockIdx.x * WM;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int ty = walk_ty();  // key rows ty + 16i
  const int tx = walk_tx();  // query columns tx + 16j (d columns 4tx..)
  const int offset = tk - tq;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);
  const int brow = bias.sq ? QBS : 0;  // a broadcast bias has one row
  const float* lse_h = lse + ((size_t)bi * h + head) * tq;
  const float* delta_h = delta + ((size_t)bi * h + head) * tq;

  const int n_q = (tq + WN - 1) / WN;
  // under the causal mask, q tiles wholly before this tile's first key
  // (shifted by the offset) see none of its keys
  const int lo = causal ? max(k0 - offset, 0) / WN : 0;
  float dk_acc[8][4], dv_acc[8][4];
  zero_patch(dk_acc);
  zero_patch(dv_acc);
  if (lo < n_q) {  // s^T's operands first, the rest while it is computed
    const int q0 = lo * WN;
    stage_rows<WM>(k_s, k, bi, k0, tk, head);
    stage_rows<WN>(qd_s, q, bi, q0, tq, head);
    async_commit();
    stage_rows<WM>(v_s, v, bi, k0, tk, head);
    stage_rows<WN>(qd_s + kWalkTile, dout, bi, q0, tq, head);
    stage_stats(st_s, lse_h, q0, tq, 0);
    stage_stats(st_s + WN, delta_h, q0, tq, WN);
    if (bias.p) stage_bias<WN, WM>(bd_s, QBS, bias, bi, head, q0, tq, k0, tk);
    async_commit();
    async_wait<1>();
    __syncthreads();
  }

  for (int qt = lo; qt < n_q; ++qt) {
    const int q0 = qt * WN;
    const int slot = (qt - lo) & 1;
    const float* q_t = qd_s + slot * 2 * kWalkTile;
    const float* do_t = q_t + kWalkTile;
    const float* lse_t = st_s + slot * 2 * WN;
    const float* delta_t = lse_t + WN;
    const bool more = qt + 1 < n_q;
    if (more) {  // the next q, dO, lse, delta into the stage the last left
      float* next = qd_s + (slot ^ 1) * 2 * kWalkTile;
      float* next_st = st_s + (slot ^ 1) * 2 * WN;
      stage_rows<WN>(next, q, bi, q0 + WN, tq, head);
      stage_rows<WN>(next + kWalkTile, dout, bi, q0 + WN, tq, head);
      stage_stats(next_st, lse_h, q0 + WN, tq, 0);
      stage_stats(next_st + WN, delta_h, q0 + WN, tq, WN);
      async_commit();
    }
    float st[8][4], dpt[8][4];
    zero_patch(st);
    zero_patch(dpt);
    walk_mma<true>(k_s, TS, q_t, TS, st);
    if (qt == lo) {  // v, dO, lse, delta and the bias of the first step
      if (more)
        async_wait<1>();
      else
        async_wait<0>();
      __syncthreads();
    }
    walk_mma<true>(v_s, TS, do_t, TS, dpt);
    if (bias.p) {  // this tile's bias, started after the last step
      if (more)
        async_wait<1>();
      else
        async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qpos = q0 + qc;
        float p = 0.f;
        if (qpos < tq && kpos < tk && !(causal && qpos + offset < kpos)) {
          float sv = st[i][j] * scale;
          if (bias.p) sv += bd_s[qc * brow + ty + 16 * i];
          p = expf(sv - lse_t[qc]);
        }
        float pv = p, dpv = dpt[i][j];
        if (DROP) {
          // dv takes the kept, scaled p; ds the undropped p times the
          // dropped dp
          const bool kept = hash_rng::keep_attn(
              hseed, (uint32_t)qpos * tk + kpos, drop.threshold);
          pv = kept ? p * drop.inv_keep : 0.f;
          dpv = kept ? dpv * drop.inv_keep : 0.f;
        }
        p_s[(ty + 16 * i) * PS + qc] = pv;
        st[i][j] = p * (dpv - delta_t[qc]) * scale;  // ds
      }
    }
    __syncthreads();  // p_s is whole; the bias tile is consumed
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bd_s[(ty + 16 * i) * PS + tx + 16 * j] = st[i][j];
    walk_mma<false>(p_s, PS, do_t, TS, dv_acc);
    __syncthreads();  // ds^T is whole
    walk_mma<false>(bd_s, PS, q_t, TS, dk_acc);
    async_wait<0>();
    __syncthreads();  // the next stage has landed; this one is consumed
    if (more && bias.p) {
      stage_bias<WN, WM>(bd_s, QBS, bias, bi, head, q0 + WN, tq, k0, tk);
      async_commit();
    }
  }
  store_walk_rows(dk, dkv_l, dk_acc, bi, k0, tk, head);
  store_walk_rows(dv, dkv_l, dv_acc, bi, k0, tk, head);
}

template <class L, bool DROP>
cudaError_t launch_fwd(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias, float* o,
                       L o_l, float* lse, int b, int tq, int tk, int h,
                       float scale, int causal, Dropout drop,
                       cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err =
      allow_smem(flash_fwd_kernel<L, DROP>, kFwdSmem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + WM - 1) / WM, h, b);
  flash_fwd_kernel<L, DROP><<<grid, NT, kFwdSmem, stream>>>(
      q, k, v, bias, o, o_l, lse, tq, tk, h, scale, causal, drop);
  return cudaGetLastError();
}

// The forward over a grid of (128-row q tiles, heads, batch rows): the
// hashing instantiation only when drop.on.
template <class L>
cudaError_t fwd(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias, float* o, L o_l,
                float* lse, int b, int tq, int tk, int h, float scale,
                int causal, Dropout drop, cudaStream_t stream) {
  return drop.on
      ? launch_fwd<L, true>(q, k, v, bias, o, o_l, lse, b, tq, tk, h, scale,
                            causal, drop, stream)
      : launch_fwd<L, false>(q, k, v, bias, o, o_l, lse, b, tq, tk, h,
                             scale, causal, drop, stream);
}

template <class L, bool DROP>
cudaError_t launch_bwd_dq(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias,
                          Rows<L> dout, const float* lse, const float* delta,
                          float* dq, L dq_l, int b, int tq, int tk, int h,
                          float scale, int causal, Dropout drop,
                          cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err =
      allow_smem(flash_bwd_dq_kernel<L, DROP>, kDqSmem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + WM - 1) / WM, h, b);
  flash_bwd_dq_kernel<L, DROP><<<grid, NT, kDqSmem, stream>>>(
      q, k, v, bias, dout, lse, delta, dq, dq_l, tq, tk, h, scale, causal,
      drop);
  return cudaGetLastError();
}

// The dq walk over a grid of (128-row q tiles, heads, batch rows): the
// hashing instantiation only when drop.on.
template <class L>
cudaError_t bwd_dq(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias, Rows<L> dout,
                   const float* lse, const float* delta, float* dq, L dq_l,
                   int b, int tq, int tk, int h, float scale, int causal,
                   Dropout drop, cudaStream_t stream) {
  return drop.on
      ? launch_bwd_dq<L, true>(q, k, v, bias, dout, lse, delta, dq, dq_l, b,
                               tq, tk, h, scale, causal, drop, stream)
      : launch_bwd_dq<L, false>(q, k, v, bias, dout, lse, delta, dq, dq_l,
                                b, tq, tk, h, scale, causal, drop, stream);
}

template <class L, bool DROP>
cudaError_t launch_bwd_dkv(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias,
                           Rows<L> dout, const float* lse,
                           const float* delta, float* dk, float* dv,
                           L dkv_l, int b, int tq, int tk, int h,
                           float scale, int causal, Dropout drop,
                           cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err =
      allow_smem(flash_bwd_dkv_kernel<L, DROP>, kDkvSmem, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + WM - 1) / WM, h, b);
  flash_bwd_dkv_kernel<L, DROP><<<grid, NT, kDkvSmem, stream>>>(
      q, k, v, bias, dout, lse, delta, dk, dv, dkv_l, tq, tk, h, scale,
      causal, drop);
  return cudaGetLastError();
}

// The dkv walk over a grid of (128-row k tiles, heads, batch rows).
template <class L>
cudaError_t bwd_dkv(Rows<L> q, Rows<L> k, Rows<L> v, Bias bias,
                    Rows<L> dout, const float* lse, const float* delta,
                    float* dk, float* dv, L dkv_l, int b, int tq, int tk,
                    int h, float scale, int causal, Dropout drop,
                    cudaStream_t stream) {
  return drop.on
      ? launch_bwd_dkv<L, true>(q, k, v, bias, dout, lse, delta, dk, dv,
                                dkv_l, b, tq, tk, h, scale, causal, drop,
                                stream)
      : launch_bwd_dkv<L, false>(q, k, v, bias, dout, lse, delta, dk, dv,
                                 dkv_l, b, tq, tk, h, scale, causal, drop,
                                 stream);
}

}  // namespace
