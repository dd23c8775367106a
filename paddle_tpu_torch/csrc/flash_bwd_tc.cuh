// The fused-projection backward's walks in bf16 (amp) on tensor cores, for
// sm_90a: #2's dq walk and #3's dk, dv walk over the pair's projected
// rows.  Replaces paddle_tpu/kernels/attention.py _qkv_bwd_dq_kernel (#2)
// and _qkv_bwd_dkv_kernel (#3) for bf16 operands, with the GEMM stages of
// qkv_attention_bwd.cu around them (ptt_qkv_bwd_bf16).
//
//   dq walk   s = q k^T, dp = dctx v^T, p = exp(s * scale + bias - lse),
//             ds = p (dp - delta) * scale,  dq = sum over keys of ds k
//   dkv walk  s^T = k q^T, dp^T = v dctx^T, p^T and ds^T likewise,
//             dv = sum over queries of p^T dctx,  dk = sum of ds^T q
//
// Numerics.  The reference holds q, k, v, dctx, p, ds and dq | dk | dv in
// f32.  Here each comes as two bf16 planes, v = hi + lo (mma.cuh's split:
// v to 2^-16 of itself): q, k, v and dctx from the projections' epilogue
// (gemm.cuh gemm_tc_planes), p and ds split in registers, dq, dk and dv
// stored split for the dx and dW products.  Every t x t product of two
// split operands is three MMAs, hi hi + hi lo + lo hi (the dropped lo lo
// is under 2^-16 of the product), summed in f32; p, ds, lse and delta are
// f32.
//
// Why two walks and no shared p or ds.  The dq walk owns 64 query rows and
// computes s and dp as accumulator fragments; p and ds are built in
// registers and ds, split, is at once the A operand of dq += ds k.  The
// dkv walk owns 64 key rows and computes the transposed scores s^T = k q^T
// and dp^T = v dctx^T, so that p^T and ds^T are A fragments of dv += p^T
// dctx and dk += ds^T q: no transposed product needs p or ds in shared
// memory.  One walk of all five products would have to transpose p and ds
// through shared memory, or sum dq across blocks (atomics, or a fixed
// order at the cost of a second pass).  The two walks recompute s and dp
// each: 21 MMA passes of b h t^2 64 FLOPs x 2 (the dq walk 9, the dkv walk
// 12) for the function's 7.
//
// Block: 4 warps, 16 own rows each (64 rows of one head and batch row),
// walking 64-row tiles of the other side; grid (ceil(t / 64), h, b).  The
// own rows' hi and lo planes stay in shared memory; the walked tiles (k, v
// or q, dctx, each hi and lo, and for the dkv walk the tile's lse and
// delta) come in by 16-byte (4-byte) cp.async into a ring of BW_STAGES = 2
// stages, the next tile in flight while this one computes.  Tiles are rows
// of 64 bf16 padded to 72 (144 bytes), so that the 8 rows ldmatrix reads at
// once fall in distinct bank groups; the same tile is read by ldmatrix
// for s (k as B) and by ldmatrix.trans for dq (k as B along the keys).
// 108 KB (dq) and 109 KB (dkv) of shared memory hold two blocks an SM;
// registers and spills in the build log.
//
// Masking, bias, dropout: as flash_walk.cuh's bwd_dq and bwd_dkv.  Causal
// keys (q < k) and keys past t give p = 0; a row whose lse is +inf (masked
// in the forward) gets p = 0, so zero gradients; rows past t load as
// zeros and are not stored.  The bias (BiasOf strides) is read from
// device memory before the products: in the dq walk as bf16 pairs where
// the base is 4-byte aligned and the strides even (a view may start at an
// odd element), else element by element; in the dkv walk element by
// element (a fragment's pair runs along q), one register each (packed
// into pairs as they landed, they stalled the walk: 13% slower on an
// H100 at the amp step's decoder self-attention).  Under dropout p is kept where
// hash_rng::keep_attn(head seed, q * t + k) says so: dv takes p * inv_keep
// where kept, ds the undropped p times the dropped dp.  Each of dq, dk,
// dv is summed in one fixed order by one block, no atomics: two calls give
// the same bits.  The softmax runs in base 2 (ex2.approx on the scores
// and lse times log2 e).

#pragma once

#include "flash_walk.cuh"
#include "mma.cuh"

namespace {

constexpr int BW_ROWS = 64;          // own rows of a block, a tile's rows
constexpr int BW_NT = 2 * BW_ROWS;   // a warp for each 16 own rows
constexpr int BW_STAGES = 2;         // walked tiles in the ring
constexpr int BW_LD = DH + 8;        // row stride of the bf16 tiles
constexpr int BW_TILE = BW_ROWS * BW_LD;  // elements of one plane's tile
//: the dq walk: q and dctx (hi, lo), then the ring's k and v (hi, lo)
constexpr size_t kBwdDqTcSmem = (4 + 4 * BW_STAGES) * BW_TILE * sizeof(bf16);
//: the dkv walk: k and v (hi, lo), the ring's q and dctx (hi, lo), then
//: the ring's lse and delta
constexpr size_t kBwdDkvTcSmem =
    kBwdDqTcSmem + BW_STAGES * 2 * BW_ROWS * sizeof(float);

// An f32 [b * t, ld] matrix held as bf16 planes: head `head` of row r of
// batch row bi at hi + (bi * t + r) * ld + head * 64, its lo part lo
// elements further.
template <class T>
struct PlanesOf {
  T* hi;
  int64_t lo;
  int ld;
  __device__ __forceinline__ T* at(int bi, int t, int r, int head) const {
    return hi + ((size_t)bi * t + r) * ld + head * DH;
  }
};
using Planes = PlanesOf<const bf16>;

// Start the copy of the 64 rows r0.. (both planes) of head `head` into
// dst (hi) and dst + BW_TILE (lo); rows at or past t come in as zeros.
__device__ __forceinline__ void bw_stage(bf16* dst, const Planes& src,
                                         int bi, int r0, int t, int head) {
#pragma unroll
  for (int u = 0; u < 2 * BW_ROWS * (DH / 8) / BW_NT; ++u) {
    const int idx = threadIdx.x + u * BW_NT;
    const int plane = idx / (BW_ROWS * (DH / 8));
    const int row = idx / (DH / 8) % BW_ROWS;
    const int c8 = idx % (DH / 8) * 8;
    const bool in = r0 + row < t;
    tc::copy16(dst + plane * BW_TILE + row * BW_LD + c8,
               src.at(bi, t, in ? r0 + row : r0, head) + plane * src.lo + c8,
               in ? 16 : 0);
  }
}

// acc[2g], acc[2g + 1] (+)= A B over one 16-deep chunk, A split (ah, al),
// B the n tiles of f (hi) and fl (lo) as ldsm4 gives them: hi hi + hi lo
// + lo hi.
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

// c (16 rows x 64 columns of the warp) = A B^T over the 64-deep rows: A
// the warp's 16 rows of tile `a` (hi, lo at + BW_TILE), B the 64 rows of
// tile `b` (n tiles of 8 of its rows), both split.
__device__ __forceinline__ void bw_scores(float (&c)[8][4], const bf16* a,
                                          const bf16* b, int warp) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    uint32_t ah[4], al[4];
    const int ao = tc::frag_offset(BW_LD, warp * 16, kc * 16);
    tc::ldsm4(ah, a + ao);
    tc::ldsm4(al, a + BW_TILE + ao);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t bh[4], bl[4];
      const int bo = tc::frag_offset_nk(BW_LD, g * 16, kc * 16);
      tc::ldsm4(bh, b + bo);
      tc::ldsm4(bl, b + BW_TILE + bo);
      mma3(c[2 * g], c[2 * g + 1], ah, al, bh, bl);
    }
  }
}

// acc (16 rows x 64 head columns) += P B: P the warp's 16 x 64 f32
// fragments p (split here), B the 64 rows of tile `b` (hi, lo) read along
// its rows (ldmatrix.trans).
__device__ __forceinline__ void bw_accumulate(float (&acc)[8][4],
                                              const float (&p)[8][4],
                                              const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < BW_ROWS / 16; ++kk) {
    uint32_t ph[4], pl[4];
    tc::split_a(p[2 * kk], p[2 * kk + 1], ph, pl);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t bh[4], bl[4];
      const int bo = tc::frag_offset(BW_LD, kk * 16, g * 16);
      tc::ldsm4_t(bh, b + bo);
      tc::ldsm4_t(bl, b + BW_TILE + bo);
      mma3(acc[2 * g], acc[2 * g + 1], ph, pl, bh, bl);
    }
  }
}

// Store the warp's 16 rows (acc: row g and g + 8 of the lane, head columns
// 8n + 2c..) at rows r0 + warp * 16.. below t of head `head` of dst, split
// into its hi and lo planes.
__device__ __forceinline__ void bw_store(const PlanesOf<bf16>& dst,
                                         const float (&acc)[8][4], int bi,
                                         int r0, int t, int head) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * r;
    if (row >= t) continue;
    bf16* p = dst.at(bi, t, row, head) + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t hi, lo;
      tc::split(acc[n][2 * r], acc[n][2 * r + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(p + 8 * n) = hi;
      *reinterpret_cast<uint32_t*>(p + dst.lo + 8 * n) = lo;
    }
  }
}

__device__ __forceinline__ float bf16_bits(uint32_t b) {
  const uint32_t w = b << 16;
  return *reinterpret_cast<const float*>(&w);
}

// dq of one (64-row q tile, head, batch row): the q | k | v planes [b t,
// 3 h 64] (q at head columns of the first third, k the second, v the
// third), dctx [b t, h 64], lse and delta [b, h, t]; dq into the first
// third of the dq | dk | dv planes.
template <bool DROP>
__global__ void __launch_bounds__(BW_NT, 2)
bwd_dq_tc_kernel(Planes qkv, Planes dctx, BiasOf<bf16> bias,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, PlanesOf<bf16> dqkv,
                 int t, int h, float scale, int causal, Dropout drop) {
  extern __shared__ float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // hi, lo
  bf16* dc_s = q_s + 2 * BW_TILE;             // hi, lo
  bf16* kv_s = dc_s + 2 * BW_TILE;  // stage s: k hi, lo, v hi, lo at 4s

  const int q0 = blockIdx.x * BW_ROWS;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);
  const int hd = h * DH;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);
  int n_kv = (t + BW_ROWS - 1) / BW_ROWS;
  if (causal) n_kv = min(n_kv, (min(q0 + BW_ROWS, t) - 1) / BW_ROWS + 1);
  const float scale2 = scale * tc::kLog2e;
  const Planes q{qkv.hi, qkv.lo, qkv.ld};
  const Planes k{qkv.hi + hd, qkv.lo, qkv.ld};
  const Planes v{qkv.hi + 2 * hd, qkv.lo, qkv.ld};

  int qpos[2];
  float lse2[2], dlt[2];
  const bf16* brow[2] = {nullptr, nullptr};
  const bool bias_pairs =
      reinterpret_cast<uintptr_t>(bias.p) % 4 == 0 && bias.sk == 1 &&
      t % 2 == 0 && bias.sb % 2 == 0 && bias.sh % 2 == 0 &&
      bias.sq % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qpos[r] = q0 + warp * 16 + (lane >> 2) + 8 * r;
    const size_t at = ((size_t)bi * h + head) * t + qpos[r];
    lse2[r] = qpos[r] < t ? lse[at] * tc::kLog2e : INFINITY;
    dlt[r] = qpos[r] < t ? delta[at] : 0.f;
    if (bias.p)
      brow[r] = bias.p + bi * bias.sb + head * bias.sh +
                min(qpos[r], t - 1) * bias.sq;
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // tile j in ring slot j % BW_STAGES, the own rows with tile 0; a group
  // is committed every step, so that wait<BW_STAGES - 2> always means
  // "tile kt has landed"
  if (n_kv > 0) {
    bw_stage(q_s, q, bi, q0, t, head);
    bw_stage(dc_s, dctx, bi, q0, t, head);
  }
#pragma unroll
  for (int j = 0; j < BW_STAGES - 1; ++j) {
    if (j < n_kv) {
      bw_stage(kv_s + 4 * j * BW_TILE, k, bi, j * BW_ROWS, t, head);
      bw_stage(kv_s + (4 * j + 2) * BW_TILE, v, bi, j * BW_ROWS, t, head);
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
      bw_stage(st, k, bi, next * BW_ROWS, t, head);
      bw_stage(st + 2 * BW_TILE, v, bi, next * BW_ROWS, t, head);
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
    bw_scores(s, q_s, k_s, warp);
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
    bw_scores(dp, dc_s, v_s, warp);
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
    bw_accumulate(acc, s, k_s);  // dq += ds k
  }
  const PlanesOf<bf16> dq{dqkv.hi, dqkv.lo, dqkv.ld};
  bw_store(dq, acc, bi, q0, t, head);
}

// dk and dv of one (64-row k tile, head, batch row): the operands of
// bwd_dq_tc_kernel; dk and dv into the second and third thirds of the dq
// | dk | dv planes.
template <bool DROP>
__global__ void __launch_bounds__(BW_NT, 2)
bwd_dkv_tc_kernel(Planes qkv, Planes dctx, BiasOf<bf16> bias,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, PlanesOf<bf16> dqkv,
                  int t, int h, float scale, int causal, Dropout drop) {
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
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);
  const int hd = h * DH;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);
  const float scale2 = scale * tc::kLog2e;
  const Planes q{qkv.hi, qkv.lo, qkv.ld};
  const Planes k{qkv.hi + hd, qkv.lo, qkv.ld};
  const Planes v{qkv.hi + 2 * hd, qkv.lo, qkv.ld};
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
    kpos[r] = k0 + warp * 16 + (lane >> 2) + 8 * r;
    if (bias.p)
      bcol[r] = bias.p + bi * bias.sb + head * bias.sh +
                min(kpos[r], t - 1) * bias.sk;
  }
  // stage of q tile j: q, dctx (both planes) and its rows' lse, delta
  auto stage = [&](int j) {
    const int q0 = j * BW_ROWS;
    bf16* st = qd_s + (j - first) % BW_STAGES * 4 * BW_TILE;
    bw_stage(st, q, bi, q0, t, head);
    bw_stage(st + 2 * BW_TILE, dctx, bi, q0, t, head);
    float* stats = st_s + (j - first) % BW_STAGES * 2 * BW_ROWS;
    const int r = threadIdx.x % BW_ROWS;
    const bool in = q0 + r < t;
    async_copy4(stats + threadIdx.x,
                (threadIdx.x < BW_ROWS ? lse_h : delta_h) + (in ? q0 + r : 0),
                in ? 4 : 0);
  };

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  if (first < n_q) {
    bw_stage(k_s, k, bi, k0, t, head);
    bw_stage(v_s, v, bi, k0, t, head);
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
    bw_scores(s, k_s, q_t, warp);  // s^T = k q^T
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
    bw_scores(dp, v_s, dc_t, warp);  // dp^T = v dctx^T
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
    bw_accumulate(dv, s, dc_t);  // dv += p^T dctx
    bw_accumulate(dk, dp, q_t);  // dk += ds^T q
  }
  const PlanesOf<bf16> dk_p{dqkv.hi + hd, dqkv.lo, dqkv.ld};
  const PlanesOf<bf16> dv_p{dqkv.hi + 2 * hd, dqkv.lo, dqkv.ld};
  bw_store(dk_p, dk, bi, k0, t, head);
  bw_store(dv_p, dv, bi, k0, t, head);
}

template <bool DROP>
cudaError_t launch_bwd_tc(int walk, Planes qkv, Planes dctx,
                          BiasOf<bf16> bias, const float* lse,
                          const float* delta, PlanesOf<bf16> dqkv, int b,
                          int t, int h, float scale, int causal,
                          Dropout drop, cudaStream_t stream) {
  static bool configured[2] = {false, false};
  const dim3 grid((t + BW_ROWS - 1) / BW_ROWS, h, b);
  cudaError_t err;
  if (walk == 0) {
    err = allow_smem(bwd_dq_tc_kernel<DROP>, kBwdDqTcSmem, configured[0]);
    if (err != cudaSuccess) return err;
    bwd_dq_tc_kernel<DROP><<<grid, BW_NT, kBwdDqTcSmem, stream>>>(
        qkv, dctx, bias, lse, delta, dqkv, t, h, scale, causal, drop);
  } else {
    err = allow_smem(bwd_dkv_tc_kernel<DROP>, kBwdDkvTcSmem, configured[1]);
    if (err != cudaSuccess) return err;
    bwd_dkv_tc_kernel<DROP><<<grid, BW_NT, kBwdDkvTcSmem, stream>>>(
        qkv, dctx, bias, lse, delta, dqkv, t, h, scale, causal, drop);
  }
  return cudaGetLastError();
}

// The dq walk (walk 0) or the dkv walk (walk 1) over a grid of (64-row
// tiles, heads, batch rows): the hashing instantiation only when drop.on.
cudaError_t bwd_tc(int walk, Planes qkv, Planes dctx, BiasOf<bf16> bias,
                   const float* lse, const float* delta, PlanesOf<bf16> dqkv,
                   int b, int t, int h, float scale, int causal,
                   Dropout drop, cudaStream_t stream) {
  return drop.on
      ? launch_bwd_tc<true>(walk, qkv, dctx, bias, lse, delta, dqkv, b, t,
                            h, scale, causal, drop, stream)
      : launch_bwd_tc<false>(walk, qkv, dctx, bias, lse, delta, dqkv, b, t,
                             h, scale, causal, drop, stream);
}

}  // namespace
