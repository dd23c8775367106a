// The flash-attention backward walks in bf16 (amp) on tensor cores, for
// sm_90a: a dq walk and a dk, dv walk, on two kinds of operand.
//
//   * the pair's (SPLIT): #2's dq walk and #3's dk, dv walk over the
//     fused projection's rows, f32 values held as hi/lo bf16 planes
//     (bwd_dq_tc_kernel, bwd_dkv_tc_kernel).  Replaces
//     paddle_tpu/kernels/attention.py _qkv_bwd_dq_kernel (#2) and
//     _qkv_bwd_dkv_kernel (#3) for bf16 operands, with the GEMM stages of
//     qkv_attention_bwd.cu around them (ptt_qkv_bwd_bf16);
//   * bf16 rows (one plane): #6 and #7 over bf16 [b, t, h, d] tensors
//     and #8 and #9 over bf16 [b, h, t, d] tensors, the same walks on
//     the row layout L (flash_walk.cuh BthdOf, BhtdOf: flash_dq_tc_kernel,
//     flash_dkv_tc_kernel).  Replace _bwd_dq_kernel_bthd (#6),
//     _bwd_dkv_kernel_bthd (#7), _bwd_dq_kernel (#8) and _bwd_dkv_kernel
//     (#9) for bf16 operands (flash_attention.cu's ptt_flash_bwd_dq_bf16,
//     ptt_flash_bwd_dkv_bf16 and their _bhtd_bf16 twins).  In bhtd a
//     head's rows are contiguous (a row stride of 64): the ring's 16-byte
//     copies of a 64-row tile read one contiguous 8 KB block instead of 64
//     rows at a stride of h * 128 bytes.
//
// Both kinds share the tile helpers (bw_stage, bw_scores, bw_accumulate
// and bw_store take SPLIT) and keep kernels of their own: #6's and #7's
// arguments (tq != tk, the causal offset, k and v apart from q) in the
// pair's kernels gave the pair its bits but slowed it on an H100.
//
//   dq walk   s = q k^T, dp = dO v^T, p = exp(s * scale + bias - lse),
//             ds = p (dp - delta) * scale,  dq = sum over keys of ds k
//   dkv walk  s^T = k q^T, dp^T = v dO^T, p^T and ds^T likewise,
//             dv = sum over queries of p^T dO,  dk = sum of ds^T q
//
// Numerics.  The references hold p, ds and the sums in f32.  Every bf16 x
// bf16 product is exact in f32 and the tensor core sums in f32.  An f32
// value v is split as v = hi + lo, two bf16s (mma.cuh's split: v to 2^-16
// of itself).  With SPLIT, q, k, v and dctx come as hi/lo planes from the
// projections' epilogue (gemm.cuh gemm_tc_planes) and dq, dk, dv are
// stored split for the dx and dW products: every t x t product of two
// split operands is three MMAs, hi hi + hi lo + lo hi (the dropped lo lo
// is under 2^-16 of the product).  On bf16 rows, which the reference
// widens to f32 exactly, s and dp are one MMA each; p, the dropped p and
// ds are split in registers, and dq += ds k, dv += p^T dO and dk += ds^T q
// are two MMAs each, hi B + lo B; dq, dk and dv are rounded to bf16 once
// as they are stored.  lse and delta are f32 in both.
//
// Why two walks and no shared p or ds.  The dq walk owns 64 query rows and
// computes s and dp as accumulator fragments; p and ds are built in
// registers and ds, split, is at once the A operand of dq += ds k.  The
// dkv walk owns 64 key rows and computes the transposed scores s^T = k q^T
// and dp^T = v dO^T, so that p^T and ds^T are A fragments of dv += p^T dO
// and dk += ds^T q: no transposed product needs p or ds in shared memory.
// One walk of all five products would have to transpose p and ds through
// shared memory, or sum dq across blocks (atomics, or a fixed order at the
// cost of a second pass).  The two walks recompute s and dp each.  In
// t x t products of b h tq tk 64 x 2 FLOPs, against the function's 7: the
// pair's walks issue 21 MMA passes (dq 9, dkv 12), the one-plane walks 10
// (dq 4: s 1, dp 1, dq 2; dkv 6: s^T 1, dp^T 1, dv 2, dk 2).
//
// Block: 4 warps, 16 own rows each (64 rows of one head and batch row),
// walking 64-row tiles of the other side; grid (ceil(rows / 64), h, b).
// The own rows' planes stay in shared memory; the walked tiles (k, v or q,
// dO, each in its planes, and for the dkv walk the tile's lse and delta)
// come in by 16-byte (4-byte) cp.async into a ring of stages, the next
// tile in flight while this one computes.  Tiles are rows of 64 bf16
// padded to 72 (144 bytes), so that the 8 rows ldmatrix reads at once
// fall in distinct bank groups; the same tile is read by ldmatrix for s
// (k as B) and by ldmatrix.trans for dq (k as B along the keys).  The
// primitive is mma.sync m16n8k16 (bf16 in, f32 accumulators) fed by
// ldmatrix, as in flash_tc.cuh.
//
// The pair's walks: a 2-stage ring, 108 KB (dq) and 109 KB (dkv) of
// shared memory, two blocks an SM (209 and 250-254 registers, no spills;
// the bias read into registers from device memory).  The one-plane walks
// (#6, #7): a 2-stage ring that also carries each step's bias tile (read
// from device memory into registers instead, 16 (dq) or 32 (dkv) loads a
// lane a step, as the pair's walks read it, the walks were slower on an
// H100, and so with a key-padding row read once into registers), 72 KB
// (dq) and 73 KB (dkv) of shared memory, three blocks an SM (168
// registers, spills of 0-4 (dq) and 16 (dkv) bytes; against 2 blocks an
// SM, 128 registers and a third stage in chip_tc_phases.py, PERF.md);
// registers and spills in the build log.  At the amp
// step's cross-attention (b 32, h 8, tq = tk = 256) the dq walk issues 8.6
// GFLOP of MMAs and the dkv walk 12.9 for the function's 6.4 and 8.6; the
// bound is the bytes (q, k, v, dO and the outputs, 12.7 and 15.2 us at
// 3.35 TB/s) over the MMA time (8.7 and 13.0 us at 989 TFLOP/s).  What
// holds them at a quarter of it is measured in PERF.md (chip_tc_phases.py:
// the next tile's copies and the bias take the most of a block's clock).
//
// Head width 128 (the layouts' and Planes' width D, 64 or 128; the
// pair's walks take it as a template argument).  Every tile's rows are D
// + 8 elements; the bias tiles stay 64 keys wide (BW_BLD).  The one-plane
// walks keep 4 warps, each summing all D columns of its 16 rows: at 128
// dq takes 120 KB and 187-233 registers, dkv 121 KB and 255 registers
// with 40-56 bytes of spills (dk and dv alone hold 128 f32 a lane), one
// block an SM.  The pair's walks give each row group two warps, one for
// each 64 columns of dq, or of dk and dv, both computing the group's s
// and dp (12 products instead of 9 in the dq walk, 16 instead of 12 in
// the dkv walk): 204 KB (dq) and 205 KB (dkv), 256 threads, one block
// an SM, 244 and 255 registers with 20-68 bytes of spills, as at 64.
// Measured on an H100 at the amp step's shapes (b 32, 8 heads of 128, t
// 256; PERF.md): the one-plane walks with two warps a row group (187-255
// registers, no spills) were 8-16% slower than with one; the pair's with
// one (255 registers, 244-488 bytes of spills) 10% slower than with two.
// Both give the same bits: each output element is summed in the same
// order.
//
// Masking, bias, dropout: as flash_walk.cuh's bwd_dq and bwd_dkv.  Causal
// keys (bottom-right aligned: a key k is kept where q + tk - tq >= k; the
// pair has tq = tk) and keys past tk give p = 0, and the walks skip the
// tiles the mask hides wholly; a row whose lse is +inf (masked in the
// forward) gets p = 0, so zero gradients; rows past t load as zeros and
// are not stored.  The bias (BiasOf strides; a key-padding bias [b, 1, 1,
// tk] read in place through its zero strides) comes, in the one-plane
// walks, through the ring: 16-byte cp.async of its rows (one row where it
// is broadcast along the queries) where they are contiguous and 16-byte
// aligned, else element by element (a view may start at an odd element);
// a lane reads its elements from the staged tile as it forms p.  The
// pair's walks read it from device memory before the products: in the
// dq walk as bf16 pairs where the base is 4-byte aligned and the strides
// even, else element by element; in the dkv walk element by element (a
// fragment's pair runs along q), one register each (packed into pairs as
// they landed, they stalled the walk: 13% slower on an H100 at the amp
// step's decoder self-attention).  Under dropout p is kept where
// hash_rng::keep_attn(head seed, q * tk + k) says so: dv takes p *
// inv_keep where kept, ds the undropped p times the dropped dp.  Each of
// dq, dk, dv is summed in one fixed order by one block, no atomics: two
// calls give the same bits.  The softmax runs in base 2 (ex2.approx on the
// scores and lse times log2 e).

#pragma once

#include "flash_walk.cuh"
#include "mma.cuh"

namespace {

constexpr int BW_ROWS = 64;          // own rows of a block, a tile's rows
constexpr int BW_COLS = 64;          // the pair's head columns a warp sums
constexpr int BW_BLD = BW_ROWS + 8;  // row stride of a bias tile
constexpr int BW_STAGES = 2;         // the pair's walked tiles in the ring
constexpr int BW_MIN_BLOCKS = 2;     // the pair's blocks an SM (width 64)
constexpr int BW1_STAGES = 2;        // the one-plane walks' ring
constexpr int BW1_DQ_BLOCKS = 3;     // blocks an SM: the one-plane dq walk
constexpr int BW1_DKV_BLOCKS = 3;    // ... and its dkv walk (width 64)

// The walks' shape for hi/lo planes (SPLIT) or one bf16 plane at head
// width D (64 or 128).  A block owns 64 rows: 4 row groups of 16, each
// taken by kGroups warps, one for each kCols head columns of the outputs
// (warp w: rows 16 (w % 4).., columns kCols (w / 4)..).  The warps of a
// row group compute the same s and dp (over all D columns); each sums its
// own columns of dq, or of dk and dv.  The pair's walks split a head of
// 128 between two warps (kCols 64), so that a lane's accumulators stay 32
// (dq) or 64 (dk, dv) f32 beside the planes' fragments; the one-plane
// walks keep one warp a row group (kCols = D), its accumulators 64 or 128
// f32 at 128: fewer s and dp products, some spills, and faster on an H100
// (PERF.md, head width 128).
template <bool SPLIT, int D>
struct Bw {
  static constexpr bool kSplit = SPLIT;
  static constexpr int kWidth = D;
  static constexpr int kCols = SPLIT && D > BW_COLS ? BW_COLS : D;
  static constexpr int kGroups = D / kCols;
  static constexpr int kNt = 2 * BW_ROWS * kGroups;  // threads a block
  static constexpr int kLd = D + 8;            // row stride of the tiles
  static constexpr int kTile = BW_ROWS * kLd;  // one plane's tile
  static constexpr int kPlanes = SPLIT ? 2 : 1;
  static constexpr int kStages = SPLIT ? BW_STAGES : BW1_STAGES;
  //: the bias tiles of the one-plane walks' ring (64 keys wide at every
  //: head width)
  static constexpr int kBiasTiles = SPLIT ? 0 : kStages;
  static constexpr int kBiasTile = BW_ROWS * BW_BLD;
  //: the dq walk: q and dO, then the ring's k and v, each in its planes,
  //: then the ring's bias tiles
  static constexpr size_t kDqSmem =
      ((2 + 2 * kStages) * kPlanes * kTile + kBiasTiles * kBiasTile) *
      sizeof(bf16);
  //: the dkv walk: k and v, the ring's q and dO, the ring's lse and delta,
  //: then the ring's bias tiles
  static constexpr size_t kDkvSmem =
      kDqSmem + kStages * 2 * BW_ROWS * sizeof(float);
  //: blocks an SM (__launch_bounds__): at 128 shared memory holds one
  static constexpr int kDqBlocks =
      D == 64 ? (SPLIT ? BW_MIN_BLOCKS : BW1_DQ_BLOCKS) : 1;
  static constexpr int kDkvBlocks =
      D == 64 ? (SPLIT ? BW_MIN_BLOCKS : BW1_DKV_BLOCKS) : 1;
};

// A [b * t, ld] matrix of bf16 rows of heads D wide: head `head` of row r
// of batch row bi at hi + (bi * t + r) * ld + head * D; with SPLIT an f32
// matrix whose lo plane lies lo elements after its hi plane.
template <class T, int D>
struct PlanesOf {
  T* hi;
  int64_t lo;
  int ld;
  __device__ __forceinline__ T* at(int bi, int t, int r, int head) const {
    return hi + ((size_t)bi * t + r) * ld + head * D;
  }
};
template <int D>
using Planes = PlanesOf<const bf16, D>;

// The bf16 rows of layout L (flash_walk.cuh Bthd, Bhtd) that a one-plane
// walk writes.
template <class L>
struct OutRows {
  bf16* p;
  L l;
  __device__ __forceinline__ bf16* at(int bi, int t, int r,
                                      int head) const {
    return p + l.at(bi, t, r, head);
  }
};

// The one-plane walks' operands, bf16 rows of layout L (#6, #7: Bthd,
// [b, t, h, 64]; #8, #9: Bhtd, [b, h, t, 64]): q and dout (dO) of tq
// rows, k and v of tk rows; lse and delta f32 [b, h, tq]; dq (tq rows),
// dk and dv (tk rows) written by the walk that owns them.
template <class L>
struct FlashBw {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  BiasOf<bf16> bias;
  const float* lse;
  const float* delta;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int tq, tk, h;
  float scale;
  int causal;
  Dropout drop;
  L l;
};

// Start the copy of the 64 rows r0.. (each plane) of head `head` of src
// (Planes, or one plane's Rows of a layout) into dst (and dst + S::kTile
// for the lo plane); rows at or past t come in as zeros.
template <class S, class Src>
__device__ __forceinline__ void bw_stage(bf16* dst, const Src& src, int bi,
                                         int r0, int t, int head) {
  constexpr int D = S::kWidth;
#pragma unroll
  for (int u = 0; u < S::kPlanes * BW_ROWS * (D / 8) / S::kNt; ++u) {
    const int idx = threadIdx.x + u * S::kNt;
    const int plane = idx / (BW_ROWS * (D / 8));
    const int row = idx / (D / 8) % BW_ROWS;
    const int c8 = idx % (D / 8) * 8;
    const bool in = r0 + row < t;
    const bf16* from = src.at(bi, t, in ? r0 + row : r0, head) + c8;
    if constexpr (S::kSplit) from += plane * src.lo;
    tc::copy16(dst + plane * S::kTile + row * S::kLd + c8, from,
               in ? 16 : 0);
  }
}

// Start the copy of a bias tile into dst (row stride BW_BLD): rows r0.. (64
// queries, or the one row of a bias broadcast along them: sr == 0) x
// columns c0.. (64 keys), element (r, c) at base[r * sr + c * sc], zero
// past (nr, nc).  Rows of contiguous, 16-byte aligned keys come in by
// 16-byte cp.async; any other bias (a view at an odd element, say) is
// read element by element and stored now.  NT threads share the copies.
template <int NT>
__device__ __forceinline__ void bw_stage_bias(bf16* dst, const bf16* base,
                                              int64_t sr, int64_t sc,
                                              int r0, int nr, int c0,
                                              int nc) {
  const int rows = sr ? BW_ROWS : 1;
  if (sc == 1 && sr % 8 == 0 && nc % 8 == 0 &&
      reinterpret_cast<uintptr_t>(base) % 16 == 0) {
    for (int idx = threadIdx.x; idx < rows * (BW_ROWS / 8); idx += NT) {
      const int r = idx / (BW_ROWS / 8);
      const int c = idx % (BW_ROWS / 8) * 8;
      const bool in = r0 + r < nr && c0 + c < nc;
      tc::copy16(dst + r * BW_BLD + c,
                 base + (in ? (int64_t)(r0 + r) * sr + c0 + c : 0),
                 in ? 16 : 0);
    }
    return;
  }
  const uint16_t* b16 = reinterpret_cast<const uint16_t*>(base);
  uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
  for (int idx = threadIdx.x; idx < rows * BW_ROWS; idx += NT) {
    const int r = idx / BW_ROWS;
    const int c = idx % BW_ROWS;
    d16[r * BW_BLD + c] =
        r0 + r < nr && c0 + c < nc
            ? b16[(int64_t)(r0 + r) * sr + (int64_t)(c0 + c) * sc]
            : 0;
  }
}

// d0, d1 (+)= A B over one 16-deep chunk, B the n tiles of b as ldsm4
// gives them: one MMA each (both operands bf16).
__device__ __forceinline__ void mma1(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&a)[4],
                                     const uint32_t (&b)[4]) {
  tc::mma(d0, a, b[0], b[1]);
  tc::mma(d1, a, b[2], b[3]);
}

// As mma1 with A split (ah, al): hi B + lo B.
__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&b)[4]) {
  tc::mma(d0, ah, b[0], b[1]);
  tc::mma(d0, al, b[0], b[1]);
  tc::mma(d1, ah, b[2], b[3]);
  tc::mma(d1, al, b[2], b[3]);
}

// As mma1 with A split (ah, al) and B split (bh, bl): hi hi + hi lo + lo
// hi.
__device__ __forceinline__ void mma3(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[4],
                                     const uint32_t (&bl)[4]) {
  tc::mma(d0, ah, bh[0], bh[1]);
  tc::mma(d0, ah, bl[0], bl[1]);
  tc::mma(d0, al, bh[0], bh[1]);
  tc::mma(d1, ah, bh[2], bh[3]);
  tc::mma(d1, ah, bl[2], bl[3]);
  tc::mma(d1, al, bh[2], bh[3]);
}

// c (16 rows x 64 columns of the warp) = A B^T over the D-deep rows: A
// the 16 rows of row group rg of tile `a`, B the 64 rows of tile `b` (n
// tiles of 8 of its rows), each with its lo plane S::kTile further under
// SPLIT.
template <class S>
__device__ __forceinline__ void bw_scores(float (&c)[8][4], const bf16* a,
                                          const bf16* b, int rg) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < S::kWidth / 16; ++kc) {
    uint32_t ah[4], al[4];
    const int ao = tc::frag_offset(S::kLd, rg * 16, kc * 16);
    tc::ldsm4(ah, a + ao);
    if constexpr (S::kSplit) tc::ldsm4(al, a + S::kTile + ao);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t bh[4], bl[4];
      const int bo = tc::frag_offset_nk(S::kLd, g * 16, kc * 16);
      tc::ldsm4(bh, b + bo);
      if constexpr (S::kSplit) {
        tc::ldsm4(bl, b + S::kTile + bo);
        mma3(c[2 * g], c[2 * g + 1], ah, al, bh, bl);
      } else {
        mma1(c[2 * g], c[2 * g + 1], ah, bh);
      }
    }
  }
}

// acc (16 rows x 64 head columns c0..) += P B: P the warp's 16 x 64 f32
// fragments p (split here), B the 64 rows of tile `b` (its planes) read
// along its rows (ldmatrix.trans).
template <class S>
__device__ __forceinline__ void bw_accumulate(float (&acc)[S::kCols / 8][4],
                                              const float (&p)[8][4],
                                              const bf16* b, int c0) {
#pragma unroll
  for (int kk = 0; kk < BW_ROWS / 16; ++kk) {
    uint32_t ph[4], pl[4];
    tc::split_a(p[2 * kk], p[2 * kk + 1], ph, pl);
#pragma unroll
    for (int g = 0; g < S::kCols / 16; ++g) {
      uint32_t bh[4], bl[4];
      const int bo = tc::frag_offset(S::kLd, kk * 16, c0 + g * 16);
      tc::ldsm4_t(bh, b + bo);
      if constexpr (S::kSplit) {
        tc::ldsm4_t(bl, b + S::kTile + bo);
        mma3(acc[2 * g], acc[2 * g + 1], ph, pl, bh, bl);
      } else {
        mma2(acc[2 * g], acc[2 * g + 1], ph, pl, bh);
      }
    }
  }
}

// Store the warp's 16 rows (acc: row g and g + 8 of the lane, head columns
// c0 + 8n + 2c..) at rows r0 + rg * 16.. below t of head `head` of dst:
// split into its hi and lo planes (PlanesOf<bf16, D>), or rounded to bf16
// (one plane's OutRows of a layout).
template <class S, class Dst>
__device__ __forceinline__ void bw_store(const Dst& dst,
                                         const float (&acc)[S::kCols / 8][4],
                                         int bi, int r0, int t, int head,
                                         int rg, int c0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + rg * 16 + (lane >> 2) + 8 * r;
    if (row >= t) continue;
    bf16* p = dst.at(bi, t, row, head) + c0 + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < S::kCols / 8; ++n) {
      if constexpr (S::kSplit) {
        uint32_t hi, lo;
        tc::split(acc[n][2 * r], acc[n][2 * r + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(p + 8 * n) = hi;
        *reinterpret_cast<uint32_t*>(p + dst.lo + 8 * n) = lo;
      } else {
        *reinterpret_cast<uint32_t*>(p + 8 * n) =
            tc::pack(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

__device__ __forceinline__ float bf16_bits(uint32_t b) {
  const uint32_t w = b << 16;
  return *reinterpret_cast<const float*>(&w);
}

// ---------------------------------------------------------------------------
// The pair's walks (hi/lo planes)
// ---------------------------------------------------------------------------

// dq of one (64-row q tile, head, batch row): the q | k | v planes [b t,
// 3 h 64] (q at head columns of the first third, k the second, v the
// third), dctx [b t, h 64], lse and delta [b, h, t]; dq into the first
// third of the dq | dk | dv planes.
template <int D, bool DROP>
__global__ void __launch_bounds__(Bw<true, D>::kNt, Bw<true, D>::kDqBlocks)
bwd_dq_tc_kernel(Planes<D> qkv, Planes<D> dctx, BiasOf<bf16> bias,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, PlanesOf<bf16, D> dqkv,
                 int t, int h, float scale, int causal, Dropout drop) {
  using S = Bw<true, D>;
  constexpr int BW_TILE = S::kTile;
  extern __shared__ float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // hi, lo
  bf16* dc_s = q_s + 2 * BW_TILE;             // hi, lo
  bf16* kv_s = dc_s + 2 * BW_TILE;  // stage s: k hi, lo, v hi, lo at 4s

  const int q0 = blockIdx.x * BW_ROWS;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  // the warp's 16 own rows and its head columns
  const int rg = S::kGroups == 1 ? warp : warp % 4;
  const int c0 = S::kGroups == 1 ? 0 : warp / 4 * S::kCols;
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);
  const int hd = h * D;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);
  int n_kv = (t + BW_ROWS - 1) / BW_ROWS;
  if (causal) n_kv = min(n_kv, (min(q0 + BW_ROWS, t) - 1) / BW_ROWS + 1);
  const float scale2 = scale * tc::kLog2e;
  const Planes<D> q{qkv.hi, qkv.lo, qkv.ld};
  const Planes<D> k{qkv.hi + hd, qkv.lo, qkv.ld};
  const Planes<D> v{qkv.hi + 2 * hd, qkv.lo, qkv.ld};

  int qpos[2];
  float lse2[2], dlt[2];
  const bf16* brow[2] = {nullptr, nullptr};
  const bool bias_pairs =
      reinterpret_cast<uintptr_t>(bias.p) % 4 == 0 && bias.sk == 1 &&
      t % 2 == 0 && bias.sb % 2 == 0 && bias.sh % 2 == 0 &&
      bias.sq % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + rg * 16 + (lane >> 2) + 8 * r;
    const size_t at = ((size_t)bi * h + head) * t + qpos[r];
    lse2[r] = qpos[r] < t ? lse[at] * tc::kLog2e : INFINITY;
    dlt[r] = qpos[r] < t ? delta[at] : 0.f;
    if (bias.p)
      brow[r] = bias.p + bi * bias.sb + head * bias.sh +
                min(qpos[r], t - 1) * bias.sq;
  }

  float acc[S::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < S::kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // tile j in ring slot j % BW_STAGES, the own rows with tile 0; a group
  // is committed every step, so that wait<BW_STAGES - 2> always means
  // "tile kt has landed"
  if (n_kv > 0) {
    bw_stage<S>(q_s, q, bi, q0, t, head);
    bw_stage<S>(dc_s, dctx, bi, q0, t, head);
  }
#pragma unroll
  for (int j = 0; j < BW_STAGES - 1; ++j) {
    if (j < n_kv) {
      bw_stage<S>(kv_s + 4 * j * BW_TILE, k, bi, j * BW_ROWS, t, head);
      bw_stage<S>(kv_s + (4 * j + 2) * BW_TILE, v, bi, j * BW_ROWS, t,
                  head);
    }
    tc::commit();
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BW_ROWS;
    const bf16* k_s = kv_s + kt % BW_STAGES * 4 * BW_TILE;
    const bf16* v_s = k_s + 2 * BW_TILE;
    tc::wait<BW_STAGES - 2>();
    __syncthreads();  // this step's k and v (and q, dctx) have landed; the
                      // slot the next load takes was consumed last step
    const int next = kt + BW_STAGES - 1;
    if (next < n_kv) {
      bf16* st = kv_s + next % BW_STAGES * 4 * BW_TILE;
      bw_stage<S>(st, k, bi, next * BW_ROWS, t, head);
      bw_stage<S>(st + 2 * BW_TILE, v, bi, next * BW_ROWS, t, head);
    }
    tc::commit();
    // this lane's bias of the tile (keys 8n + col, + 1, as bf16 pairs),
    // loaded before the products
    uint32_t sb[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = k0 + 8 * n + col;
        sb[n][r] = 0u;
        if (bias.p && qpos[r] < t) {
          if (bias_pairs) {
            if (kpos < t)
              sb[n][r] = *reinterpret_cast<const uint32_t*>(brow[r] + kpos);
          } else {
            const uint16_t* b16 = reinterpret_cast<const uint16_t*>(brow[r]);
            const uint32_t lo = kpos < t ? b16[(int64_t)kpos * bias.sk] : 0u;
            const uint32_t hi =
                kpos + 1 < t ? b16[(int64_t)(kpos + 1) * bias.sk] : 0u;
            sb[n][r] = lo | hi << 16;
          }
        }
      }
    // p = exp(s * scale + bias - lse) into s, the bias's registers free
    // again before dp's
    float s[8][4], dp[8][4];
    bw_scores<S>(s, q_s, k_s, rg);
    const bool edge = k0 + BW_ROWS > t || (causal && k0 + BW_ROWS - 1 > q0);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * n + col + (e & 1);
        s[n][e] = tc::ex2(fmaf(s[n][e], scale2,
                               bf16_bits(sb[n][r] >> (16 * (e & 1))) *
                                   tc::kLog2e) -
                          lse2[r]);
        if (edge && (kpos >= t || (causal && qpos[r] < kpos))) s[n][e] = 0.f;
      }
    // ds = p (dp - delta) * scale, into s
    bw_scores<S>(dp, dc_s, v_s, rg);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float dpv = dp[n][e];
        if (DROP)
          dpv = hash_rng::keep_attn(
                    hseed, (uint32_t)qpos[r] * t + k0 + 8 * n + col + (e & 1),
                    drop.threshold)
                    ? dpv * drop.inv_keep
                    : 0.f;
        s[n][e] = s[n][e] * (dpv - dlt[r]) * scale;
      }
    bw_accumulate<S>(acc, s, k_s, c0);  // dq += ds k
  }
  const PlanesOf<bf16, D> dq{dqkv.hi, dqkv.lo, dqkv.ld};
  bw_store<S>(dq, acc, bi, q0, t, head, rg, c0);
}

// dk and dv of one (64-row k tile, head, batch row): the operands of
// bwd_dq_tc_kernel; dk and dv into the second and third thirds of the dq
// | dk | dv planes.
template <int D, bool DROP>
__global__ void __launch_bounds__(Bw<true, D>::kNt, Bw<true, D>::kDkvBlocks)
bwd_dkv_tc_kernel(Planes<D> qkv, Planes<D> dctx, BiasOf<bf16> bias,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, PlanesOf<bf16, D> dqkv,
                  int t, int h, float scale, int causal, Dropout drop) {
  using S = Bw<true, D>;
  constexpr int BW_TILE = S::kTile;
  extern __shared__ float smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // hi, lo
  bf16* v_s = k_s + 2 * BW_TILE;              // hi, lo
  bf16* qd_s = v_s + 2 * BW_TILE;  // stage s: q hi, lo, dctx hi, lo at 4s
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * BW_STAGES * BW_TILE);
                                   // stage s: lse, delta at 2s rows

  const int k0 = blockIdx.x * BW_ROWS;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  // the warp's 16 own rows and its head columns
  const int rg = S::kGroups == 1 ? warp : warp % 4;
  const int c0 = S::kGroups == 1 ? 0 : warp / 4 * S::kCols;
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);
  const int hd = h * D;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);
  const float scale2 = scale * tc::kLog2e;
  const Planes<D> q{qkv.hi, qkv.lo, qkv.ld};
  const Planes<D> k{qkv.hi + hd, qkv.lo, qkv.ld};
  const Planes<D> v{qkv.hi + 2 * hd, qkv.lo, qkv.ld};
  const float* lse_h = lse + ((size_t)bi * h + head) * t;
  const float* delta_h = delta + ((size_t)bi * h + head) * t;
  // under the causal mask, q tiles wholly before this tile's first key see
  // none of its keys
  const int first = causal ? k0 / BW_ROWS : 0;
  const int n_q = (t + BW_ROWS - 1) / BW_ROWS;

  int kpos[2];
  const bf16* bcol[2] = {nullptr, nullptr};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    kpos[r] = k0 + rg * 16 + (lane >> 2) + 8 * r;
    if (bias.p)
      bcol[r] = bias.p + bi * bias.sb + head * bias.sh +
                min(kpos[r], t - 1) * bias.sk;
  }
  // stage of q tile j: q, dctx (both planes) and its rows' lse, delta
  auto stage = [&](int j) {
    const int q0 = j * BW_ROWS;
    bf16* st = qd_s + (j - first) % BW_STAGES * 4 * BW_TILE;
    bw_stage<S>(st, q, bi, q0, t, head);
    bw_stage<S>(st + 2 * BW_TILE, dctx, bi, q0, t, head);
    float* stats = st_s + (j - first) % BW_STAGES * 2 * BW_ROWS;
    const int r = threadIdx.x % BW_ROWS;
    const bool in = q0 + r < t;
    if (S::kNt == 2 * BW_ROWS || threadIdx.x < 2 * BW_ROWS)
      async_copy4(stats + threadIdx.x,
                  (threadIdx.x < BW_ROWS ? lse_h : delta_h) +
                      (in ? q0 + r : 0),
                  in ? 4 : 0);
  };

  float dk[S::kCols / 8][4], dv[S::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < S::kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  if (first < n_q) {
    bw_stage<S>(k_s, k, bi, k0, t, head);
    bw_stage<S>(v_s, v, bi, k0, t, head);
  }
#pragma unroll
  for (int j = 0; j < BW_STAGES - 1; ++j) {
    if (first + j < n_q) stage(first + j);
    tc::commit();
  }

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * BW_ROWS;
    const bf16* q_t = qd_s + (qt - first) % BW_STAGES * 4 * BW_TILE;
    const bf16* dc_t = q_t + 2 * BW_TILE;
    const float* lse_t = st_s + (qt - first) % BW_STAGES * 2 * BW_ROWS;
    const float* delta_t = lse_t + BW_ROWS;
    tc::wait<BW_STAGES - 2>();
    __syncthreads();  // this step's tile (and k, v) has landed; the slot
                      // the next load takes was consumed last step
    if (qt + BW_STAGES - 1 < n_q) stage(qt + BW_STAGES - 1);
    tc::commit();
    // this lane's bias of the tile, loaded before the products: element
    // (key kpos[e >> 1], query q0 + 8n + col + (e & 1)), the bits of one
    // bf16 a register (packing two would wait on the loads here)
    uint32_t sb[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + 8 * n + col + (e & 1);
        sb[n][e] = bias.p && kpos[e >> 1] < t && qp < t
                       ? reinterpret_cast<const uint16_t*>(
                             bcol[e >> 1])[(int64_t)qp * bias.sq]
                       : 0u;
      }
    // p^T = exp(s^T * scale + bias - lse) into s, the bias's registers
    // free again before dp^T's
    float s[8][4], dp[8][4];
    bw_scores<S>(s, k_s, q_t, rg);  // s^T = k q^T
    const bool edge = q0 + BW_ROWS > t || k0 + BW_ROWS > t ||
                      (causal && q0 < k0 + BW_ROWS - 1);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qc = 8 * n + col + (e & 1);
        const int qpos = q0 + qc;
        s[n][e] = tc::ex2(fmaf(s[n][e], scale2,
                               bf16_bits(sb[n][e]) * tc::kLog2e) -
                          lse_t[qc] * tc::kLog2e);
        if (edge && (qpos >= t || kpos[r] >= t ||
                     (causal && qpos < kpos[r])))
          s[n][e] = 0.f;
      }
    // ds^T into dp, then p^T dropped and scaled (for dv) into s
    bw_scores<S>(dp, v_s, dc_t, rg);  // dp^T = v dctx^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + col + (e & 1);
        const float p = s[n][e];
        float pv = p, dpv = dp[n][e];
        if (DROP) {
          const bool kept = hash_rng::keep_attn(
              hseed, (uint32_t)(q0 + qc) * t + kpos[e >> 1], drop.threshold);
          pv = kept ? p * drop.inv_keep : 0.f;
          dpv = kept ? dpv * drop.inv_keep : 0.f;
        }
        dp[n][e] = p * (dpv - delta_t[qc]) * scale;
        s[n][e] = pv;
      }
    bw_accumulate<S>(dv, s, dc_t, c0);  // dv += p^T dctx
    bw_accumulate<S>(dk, dp, q_t, c0);  // dk += ds^T q
  }
  const PlanesOf<bf16, D> dk_p{dqkv.hi + hd, dqkv.lo, dqkv.ld};
  const PlanesOf<bf16, D> dv_p{dqkv.hi + 2 * hd, dqkv.lo, dqkv.ld};
  bw_store<S>(dk_p, dk, bi, k0, t, head, rg, c0);
  bw_store<S>(dv_p, dv, bi, k0, t, head, rg, c0);
}

template <int D, bool DROP>
cudaError_t launch_bwd_tc(int walk, Planes<D> qkv, Planes<D> dctx,
                          BiasOf<bf16> bias, const float* lse,
                          const float* delta, PlanesOf<bf16, D> dqkv, int b,
                          int t, int h, float scale, int causal,
                          Dropout drop, cudaStream_t stream) {
  using S = Bw<true, D>;
  static bool configured[2] = {false, false};
  const dim3 grid((t + BW_ROWS - 1) / BW_ROWS, h, b);
  cudaError_t err;
  if (walk == 0) {
    err = allow_smem(bwd_dq_tc_kernel<D, DROP>, S::kDqSmem, configured[0]);
    if (err != cudaSuccess) return err;
    bwd_dq_tc_kernel<D, DROP><<<grid, S::kNt, S::kDqSmem, stream>>>(
        qkv, dctx, bias, lse, delta, dqkv, t, h, scale, causal, drop);
  } else {
    err = allow_smem(bwd_dkv_tc_kernel<D, DROP>, S::kDkvSmem,
                     configured[1]);
    if (err != cudaSuccess) return err;
    bwd_dkv_tc_kernel<D, DROP><<<grid, S::kNt, S::kDkvSmem, stream>>>(
        qkv, dctx, bias, lse, delta, dqkv, t, h, scale, causal, drop);
  }
  return cudaGetLastError();
}

// The dq walk (walk 0) or the dkv walk (walk 1) over a grid of (64-row
// tiles, heads, batch rows) at head width D: the hashing instantiation
// only when drop.on.
template <int D>
cudaError_t bwd_tc(int walk, Planes<D> qkv, Planes<D> dctx,
                   BiasOf<bf16> bias, const float* lse, const float* delta,
                   PlanesOf<bf16, D> dqkv, int b, int t, int h, float scale,
                   int causal, Dropout drop, cudaStream_t stream) {
  return drop.on
      ? launch_bwd_tc<D, true>(walk, qkv, dctx, bias, lse, delta, dqkv, b,
                               t, h, scale, causal, drop, stream)
      : launch_bwd_tc<D, false>(walk, qkv, dctx, bias, lse, delta, dqkv, b,
                                t, h, scale, causal, drop, stream);
}

// ---------------------------------------------------------------------------
// #6's and #7's walks, and #8's and #9's (one bf16 plane, layout L)
// ---------------------------------------------------------------------------

// #6 (Bthd), #8 (Bhtd): dq of one (64-row q tile, head, batch row) over
// bf16 rows.
template <class L, bool DROP>
__global__ void __launch_bounds__(Bw<false, L::kWidth>::kNt,
                                  Bw<false, L::kWidth>::kDqBlocks)
flash_dq_tc_kernel(const FlashBw<L> a) {
  using W = Bw<false, L::kWidth>;
  constexpr int S = W::kStages;
  constexpr int BW_TILE = W::kTile;
  extern __shared__ float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // q
  bf16* dc_s = q_s + BW_TILE;                 // dO
  bf16* kv_s = dc_s + BW_TILE;  // stage s: k, then v, at tiles 2s
  bf16* bs_s = kv_s + 2 * S * BW_TILE;  // stage s: the bias

  const int q0 = blockIdx.x * BW_ROWS;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  // the warp's 16 own rows and its head columns
  const int rg = W::kGroups == 1 ? warp : warp % 4;
  const int c0 = W::kGroups == 1 ? 0 : warp / 4 * W::kCols;
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);
  const int tq = a.tq, tk = a.tk;
  const int offset = tk - tq;
  const BiasOf<bf16>& bias = a.bias;
  const uint32_t hseed = block_head_seed<DROP>(a.drop, bi, a.h, head);
  // 64-key tiles: all, or under the causal mask those with a key at or
  // before the tile's last query + offset
  int n_kv = (tk + BW_ROWS - 1) / BW_ROWS;
  if (a.causal) {
    const int last = min(q0 + BW_ROWS, tq) - 1 + offset;
    n_kv = last < 0 ? 0 : min(n_kv, last / BW_ROWS + 1);
  }
  const float scale2 = a.scale * tc::kLog2e;
  const Rows<L, bf16> q{a.q, a.l}, k{a.k, a.l}, v{a.v, a.l};
  const Rows<L, bf16> dout{a.dout, a.l};

  int qpos[2];
  float lse2[2], dlt[2];
  const bf16* bias_h =
      bias.p ? bias.p + bi * bias.sb + head * bias.sh : nullptr;
  const int bld = bias.sq ? BW_BLD : 0;  // a staged tile's row stride
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + rg * 16 + (lane >> 2) + 8 * r;
    const size_t at = ((size_t)bi * a.h + head) * tq + qpos[r];
    lse2[r] = qpos[r] < tq ? __ldg(a.lse + at) * tc::kLog2e : INFINITY;
    dlt[r] = qpos[r] < tq ? __ldg(a.delta + at) : 0.f;
  }

  float acc[W::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < W::kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // tile j in ring slot j % S, the own rows with tile 0; a group is
  // committed every step, so that wait<S - 2> always means "tile kt has
  // landed"
  if (n_kv > 0) {
    bw_stage<W>(q_s, q, bi, q0, tq, head);
    bw_stage<W>(dc_s, dout, bi, q0, tq, head);
  }
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_kv) {
      bw_stage<W>(kv_s + 2 * j * BW_TILE, k, bi, j * BW_ROWS, tk, head);
      bw_stage<W>(kv_s + (2 * j + 1) * BW_TILE, v, bi, j * BW_ROWS, tk,
                  head);
      if (bias.p)
        bw_stage_bias<W::kNt>(bs_s + j * W::kBiasTile, bias_h, bias.sq,
                              bias.sk, q0, tq, j * BW_ROWS, tk);
    }
    tc::commit();
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BW_ROWS;
    const bf16* k_s = kv_s + kt % S * 2 * BW_TILE;
    const bf16* v_s = k_s + BW_TILE;
    const bf16* b_s = bs_s + kt % S * W::kBiasTile;
    tc::wait<S - 2>();
    __syncthreads();  // this step's k and v (and q, dO) have landed; the
                      // slot the next load takes was consumed last step
    const int next = kt + S - 1;
    if (next < n_kv) {
      bf16* st = kv_s + next % S * 2 * BW_TILE;
      bw_stage<W>(st, k, bi, next * BW_ROWS, tk, head);
      bw_stage<W>(st + BW_TILE, v, bi, next * BW_ROWS, tk, head);
      if (bias.p)
        bw_stage_bias<W::kNt>(bs_s + next % S * W::kBiasTile, bias_h,
                              bias.sq, bias.sk, q0, tq, next * BW_ROWS, tk);
    }
    tc::commit();
    // p = exp(s * scale + bias - lse) into s, this lane's bias pairs (keys
    // 8n + col, + 1) read from the staged tile
    uint32_t sb[8][2];
    float s[8][4], dp[8][4];
    bw_scores<W>(s, q_s, k_s, rg);
    const bool edge =
        k0 + BW_ROWS > tk || (a.causal && k0 + BW_ROWS - 1 > q0 + offset);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * n + col + (e & 1);
        if ((e & 1) == 0)
          sb[n][r] = bias.p ? *reinterpret_cast<const uint32_t*>(
                                  b_s + (rg * 16 + (lane >> 2) + 8 * r) *
                                            bld + 8 * n + col)
                            : 0u;
        s[n][e] = tc::ex2(fmaf(s[n][e], scale2,
                               bf16_bits(sb[n][r] >> (16 * (e & 1))) *
                                   tc::kLog2e) -
                          lse2[r]);
        if (edge && (kpos >= tk || (a.causal && qpos[r] + offset < kpos)))
          s[n][e] = 0.f;
      }
    // ds = p (dp - delta) * scale, into s
    bw_scores<W>(dp, dc_s, v_s, rg);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float dpv = dp[n][e];
        if (DROP)
          dpv = hash_rng::keep_attn(
                    hseed, (uint32_t)qpos[r] * tk + k0 + 8 * n + col + (e & 1),
                    a.drop.threshold)
                    ? dpv * a.drop.inv_keep
                    : 0.f;
        s[n][e] = s[n][e] * (dpv - dlt[r]) * a.scale;
      }
    bw_accumulate<W>(acc, s, k_s, c0);  // dq += ds k
  }
  bw_store<W>(OutRows<L>{a.dq, a.l}, acc, bi, q0, tq, head, rg, c0);
}

// #7 (Bthd), #9 (Bhtd): dk and dv of one (64-row k tile, head, batch
// row) over bf16 rows.
template <class L, bool DROP>
__global__ void __launch_bounds__(Bw<false, L::kWidth>::kNt,
                                  Bw<false, L::kWidth>::kDkvBlocks)
flash_dkv_tc_kernel(const FlashBw<L> a) {
  using W = Bw<false, L::kWidth>;
  constexpr int S = W::kStages;
  constexpr int BW_TILE = W::kTile;
  extern __shared__ float smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // k
  bf16* v_s = k_s + BW_TILE;                  // v
  bf16* qd_s = v_s + BW_TILE;  // stage s: q, then dO, at tiles 2s
  float* st_s = reinterpret_cast<float*>(qd_s + 2 * S * BW_TILE);
                                   // stage s: lse, delta at 2s rows
  bf16* bs_s = reinterpret_cast<bf16*>(st_s + S * 2 * BW_ROWS);
                                   // stage s: the bias

  const int k0 = blockIdx.x * BW_ROWS;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  // the warp's 16 own rows and its head columns
  const int rg = W::kGroups == 1 ? warp : warp % 4;
  const int c0 = W::kGroups == 1 ? 0 : warp / 4 * W::kCols;
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);
  const int tq = a.tq, tk = a.tk;
  const int offset = tk - tq;
  const BiasOf<bf16>& bias = a.bias;
  const uint32_t hseed = block_head_seed<DROP>(a.drop, bi, a.h, head);
  const float scale2 = a.scale * tc::kLog2e;
  const Rows<L, bf16> q{a.q, a.l}, k{a.k, a.l}, v{a.v, a.l};
  const Rows<L, bf16> dout{a.dout, a.l};
  const float* lse_h = a.lse + ((size_t)bi * a.h + head) * tq;
  const float* delta_h = a.delta + ((size_t)bi * a.h + head) * tq;
  // under the causal mask, q tiles wholly before this tile's first key
  // (shifted by the offset) see none of its keys
  const int first = a.causal ? max(k0 - offset, 0) / BW_ROWS : 0;
  const int n_q = (tq + BW_ROWS - 1) / BW_ROWS;

  const bf16* bias_h =
      bias.p ? bias.p + bi * bias.sb + head * bias.sh : nullptr;
  const int bld = bias.sq ? BW_BLD : 0;  // a staged tile's row stride
  int kpos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kpos[r] = k0 + rg * 16 + (lane >> 2) + 8 * r;
  // stage of q tile j: q, dO, its rows' lse and delta and its bias
  auto stage = [&](int j) {
    const int q0 = j * BW_ROWS;
    bf16* st = qd_s + (j - first) % S * 2 * BW_TILE;
    bw_stage<W>(st, q, bi, q0, tq, head);
    bw_stage<W>(st + BW_TILE, dout, bi, q0, tq, head);
    float* stats = st_s + (j - first) % S * 2 * BW_ROWS;
    const int r = threadIdx.x % BW_ROWS;
    const bool in = q0 + r < tq;
    if (W::kNt == 2 * BW_ROWS || threadIdx.x < 2 * BW_ROWS)
      async_copy4(stats + threadIdx.x,
                  (threadIdx.x < BW_ROWS ? lse_h : delta_h) +
                      (in ? q0 + r : 0),
                  in ? 4 : 0);
    if (bias.p)
      bw_stage_bias<W::kNt>(bs_s + (j - first) % S * W::kBiasTile, bias_h,
                            bias.sq, bias.sk, q0, tq, k0, tk);
  };

  float dk[W::kCols / 8][4], dv[W::kCols / 8][4];
#pragma unroll
  for (int n = 0; n < W::kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  if (first < n_q) {
    bw_stage<W>(k_s, k, bi, k0, tk, head);
    bw_stage<W>(v_s, v, bi, k0, tk, head);
  }
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (first + j < n_q) stage(first + j);
    tc::commit();
  }

  for (int qt = first; qt < n_q; ++qt) {
    const int q0 = qt * BW_ROWS;
    const bf16* q_t = qd_s + (qt - first) % S * 2 * BW_TILE;
    const bf16* dc_t = q_t + BW_TILE;
    const float* lse_t = st_s + (qt - first) % S * 2 * BW_ROWS;
    const float* delta_t = lse_t + BW_ROWS;
    const uint16_t* b_s = reinterpret_cast<const uint16_t*>(
        bs_s + (qt - first) % S * W::kBiasTile);
    tc::wait<S - 2>();
    __syncthreads();  // this step's tile (and k, v) has landed; the slot
                      // the next load takes was consumed last step
    if (qt + S - 1 < n_q) stage(qt + S - 1);
    tc::commit();
    // p^T = exp(s^T * scale + bias - lse) into s, this lane's bias
    // elements (key kpos[e >> 1], query q0 + 8n + col + (e & 1)) read from
    // the staged tile
    float s[8][4], dp[8][4];
    bw_scores<W>(s, k_s, q_t, rg);  // s^T = k q^T
    const bool edge = q0 + BW_ROWS > tq || k0 + BW_ROWS > tk ||
                      (a.causal && q0 + offset < k0 + BW_ROWS - 1);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qc = 8 * n + col + (e & 1);
        const int qpos = q0 + qc;
        const uint32_t bb =
            bias.p ? b_s[qc * bld + rg * 16 + (lane >> 2) + 8 * r] : 0u;
        s[n][e] = tc::ex2(fmaf(s[n][e], scale2,
                               bf16_bits(bb) * tc::kLog2e) -
                          lse_t[qc] * tc::kLog2e);
        if (edge && (qpos >= tq || kpos[r] >= tk ||
                     (a.causal && qpos + offset < kpos[r])))
          s[n][e] = 0.f;
      }
    // ds^T into dp, then p^T dropped and scaled (for dv) into s
    bw_scores<W>(dp, v_s, dc_t, rg);  // dp^T = v dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * n + col + (e & 1);
        const float p = s[n][e];
        float pv = p, dpv = dp[n][e];
        if (DROP) {
          const bool kept = hash_rng::keep_attn(
              hseed, (uint32_t)(q0 + qc) * tk + kpos[e >> 1],
              a.drop.threshold);
          pv = kept ? p * a.drop.inv_keep : 0.f;
          dpv = kept ? dpv * a.drop.inv_keep : 0.f;
        }
        dp[n][e] = p * (dpv - delta_t[qc]) * a.scale;
        s[n][e] = pv;
      }
    bw_accumulate<W>(dv, s, dc_t, c0);  // dv += p^T dO
    bw_accumulate<W>(dk, dp, q_t, c0);  // dk += ds^T q
  }
  bw_store<W>(OutRows<L>{a.dk, a.l}, dk, bi, k0, tk, head, rg, c0);
  bw_store<W>(OutRows<L>{a.dv, a.l}, dv, bi, k0, tk, head, rg, c0);
}

template <class L, bool DROP>
cudaError_t launch_flash_bwd_tc(int walk, const FlashBw<L>& a, int b,
                                cudaStream_t stream) {
  using W = Bw<false, L::kWidth>;
  static bool configured[2] = {false, false};
  const dim3 grid(((walk ? a.tk : a.tq) + BW_ROWS - 1) / BW_ROWS, a.h, b);
  cudaError_t err;
  if (walk == 0) {
    err = allow_smem(flash_dq_tc_kernel<L, DROP>, W::kDqSmem, configured[0]);
    if (err != cudaSuccess) return err;
    flash_dq_tc_kernel<L, DROP><<<grid, W::kNt, W::kDqSmem, stream>>>(a);
  } else {
    err = allow_smem(flash_dkv_tc_kernel<L, DROP>, W::kDkvSmem,
                     configured[1]);
    if (err != cudaSuccess) return err;
    flash_dkv_tc_kernel<L, DROP><<<grid, W::kNt, W::kDkvSmem, stream>>>(a);
  }
  return cudaGetLastError();
}

// The dq walk (walk 0: #6, #8) or the dkv walk (walk 1: #7, #9) over a
// grid of (64-row tiles, heads, batch rows): the hashing instantiation
// only when a.drop.on.
template <class L>
cudaError_t flash_bwd_tc(int walk, const FlashBw<L>& a, int b,
                         cudaStream_t stream) {
  return a.drop.on ? launch_flash_bwd_tc<L, true>(walk, a, b, stream)
                   : launch_flash_bwd_tc<L, false>(walk, a, b, stream);
}

}  // namespace
