// #4 and #5 in bf16 (amp) on tensor cores: the flash forward o =
// softmax(q k^T * scale + bias) v and lse over bf16 q, k, v rows of layout
// L (flash_walk.cuh BthdOf, [b, t, h, d]; BhtdOf, [b, h, t, d]; head
// width d = L::kWidth, 64 or 128), for sm_90a.  Replaces
// paddle_tpu/kernels/attention.py _fwd_kernel_bthd (#4) and _fwd_kernel
// (#5) for bf16 operands; flash_attention.cu's
// ptt_flash_fwd_bf16 and ptt_flash_fwd_bhtd_bf16 launch it.  The f32
// forward stays flash_walk.cuh's flash_fwd_kernel.
//
// Numerics (the reference widens q, k, v to f32 and computes s, p, l and
// p v in f32, rounding o once): s = q k^T is one bf16 mma.sync a k16
// chunk, exact products summed in f32, then scaled and biased in f32; the
// online softmax runs in f32 on the accumulator fragments (a row's
// maximum and sum by quad shuffles, l over the undropped p); p never goes
// to shared memory: its fragments, split as p = p_hi + p_lo (mma.cuh),
// are the A operand of two products with the bf16 v, so p v keeps p to
// about 16 significant bits (the reference: 24).  o is rounded to bf16
// once, as it is stored; lse is f32.
//
// Block: 4 warps own 64 query rows of one (head, batch row), 16 each, and
// walk the 64-key tiles; grid (ceil(tq / 64), h, b), 1024 blocks at the
// amp step's b 32, h 8, t 256.  q, k and v stay bf16 in shared memory,
// rows padded to 72 elements (144 bytes: the 8 rows ldmatrix reads at
// once fall in 8 distinct 16-byte bank groups); k and v come in by
// 16-byte cp.async into a ring of FT_STAGES = 2 stages, the next tile in
// flight while this one computes.  A warp's step: s by 32 mma.sync (16
// ldmatrix of k, 4 of q), then p v by 64 (16 ldmatrix.trans of v), the
// split doubling p v: MMA work 6 * tq * tk * 64 FLOPs a head against the
// function's 4 (6.4 GFLOP against 4.3 at the amp step's cross case).
// The bias is read from device memory as bf16 pairs before the
// products.  45 KB of shared memory (kFwdTcSmem) and 128
// registers (FT_MIN_BLOCKS = 4; 8-24 bytes of spills) hold 4 blocks an
// SM, 16 warps.  Measured on an H100 at the amp step's cross-attention
// (chip_tc_phases.py, PERF.md): 128-row blocks, a third ring stage, or 3
// blocks an SM at 170 registers were slower; timing copies without p_lo's
// MMAs ran 10% faster, without s's MMAs or the exponentials 0-3%: the
// walk is held by its loads and latencies (a fifth of a block's clock
// waits on the ring), more than by the tensor cores.
//
// At head width 128 the tiles' rows are 136 elements (85 KB a block), s
// sums over 8 k16 chunks and o is 16 tiles of 8 columns a warp (64 f32 a
// lane): 202-214 registers and no spills at FtShape<128>::kMinBlocks = 2,
// the blocks an SM its shared memory allows (at 4, its 128 registers
// would spill o).
//
// Masking, bias strides (BiasOf), dropout and the ragged tails follow
// flash_fwd_kernel: causal (offset tk - tq) and out-of-range keys score
// -1e30; the bias is read from device memory at each element a thread
// holds (a bf16 pair a load where the strides allow); under dropout p is
// kept where hash_rng::keep_attn(head seed, q * tk + k) says so and o is
// scaled by 1 / (1 - rate); a row whose max is <= -1e29, or that sees no
// key, gets a zero o and lse = +inf.  Rows and keys past t load as zeros.
//
// Bound at the amp step's cross-attention: bytes (q, k, v, o and the
// bias, 0.0101 ms) over the MMA time (4.3 GFLOP at 989 TFLOP/s: 0.0043
// ms).  The softmax runs in base 2 (scores times log2 e, ex2.approx),
// one SFU instruction an element.

#pragma once

#include "flash_walk.cuh"
#include "mma.cuh"

namespace {

constexpr int FT_ROWS = 64;           // query rows of a block
constexpr int FT_NT = 2 * FT_ROWS;    // a warp for each 16 rows
constexpr int FT_STAGES = 2;          // k / v tiles in the ring

// The forward's shape at head width D (64 or 128): bf16 tiles of rows
// padded to D + 8 elements; q, then the ring's stages of k and v, in
// kSmem bytes (45 KB at 64, 85 KB at 128); kMinBlocks blocks an SM
// (__launch_bounds__): 4 at 64 (128 registers), 2 at 128, where o's
// accumulators double (64 f32 a lane) and shared memory holds two blocks.
template <int D>
struct FtShape {
  static constexpr int kLd = D + 8;
  static constexpr int kTile = BT * kLd;  // a 64-row k or v tile
  static constexpr size_t kSmem =
      (FT_ROWS * kLd + 2 * FT_STAGES * kTile) * sizeof(bf16);
  static constexpr int kMinBlocks = D == 64 ? 4 : 2;
};
constexpr size_t kFwdTcSmem = FtShape<DH>::kSmem;

// Start the copy of ROWS rows r0.. of head `head` of src into dst (row
// stride D + 8); rows at or past t come in as zeros.
template <int ROWS, class L>
__device__ __forceinline__ void ft_stage(bf16* dst, Rows<L, bf16> src,
                                         int bi, int r0, int t, int head) {
  constexpr int D = L::kWidth;
#pragma unroll
  for (int u = 0; u < ROWS * (D / 8) / FT_NT; ++u) {
    const int idx = threadIdx.x + u * FT_NT;
    const int row = idx / (D / 8);
    const int c8 = idx % (D / 8);
    const bool in = r0 + row < t;
    tc::copy16(dst + row * FtShape<D>::kLd + c8 * 8,
               src.at(bi, t, in ? r0 + row : r0, head) + c8 * 8,
               in ? 16 : 0);
  }
}

template <class L, bool DROP>
__global__ void __launch_bounds__(FT_NT, FtShape<L::kWidth>::kMinBlocks)
flash_fwd_tc_kernel(Rows<L, bf16> q, Rows<L, bf16> k, Rows<L, bf16> v,
                    BiasOf<bf16> bias, bf16* o, L o_l,
                    float* __restrict__ lse, int tq, int tk, int h,
                    float scale, int causal, Dropout drop) {
  constexpr int D = L::kWidth;
  constexpr int FT_LD = FtShape<D>::kLd;
  constexpr int FT_TILE = FtShape<D>::kTile;
  extern __shared__ float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + FT_ROWS * FT_LD;  // stage s: k at 2s tiles, v after

  const int q0 = blockIdx.x * FT_ROWS;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col = 2 * (lane & 3);  // this lane's first column of a tile
  const int offset = tk - tq;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);
  // 64-key tiles the block walks: all, or under the causal mask those with
  // a key at or before its last query + offset (kv_tiles' count for
  // FT_ROWS rows, written out: kv_tiles keeps the one row count its f32
  // callers pass, so that their code is what it was)
  int n_kv = (tk + BT - 1) / BT;
  if (causal) {
    const int last = min(q0 + FT_ROWS, tq) - 1 + offset;
    n_kv = last < 0 ? 0 : min(n_kv, last / BT + 1);
  }
  const float scale2 = scale * tc::kLog2e;  // the scores in base 2
  // this lane's two rows: r = 0 the warp's row g, r = 1 row g + 8
  int qpos[2];
  qpos[0] = q0 + warp * 16 + (lane >> 2);
  qpos[1] = qpos[0] + 8;
  const bf16* brow[2] = {nullptr, nullptr};
  // a bias pair (keys k, k + 1) is one 4-byte load where the base is
  // 4-byte aligned, every offset of it is even and its rows are
  // contiguous in k (a view may start at an odd element)
  const bool bias_pairs =
      reinterpret_cast<uintptr_t>(bias.p) % 4 == 0 && bias.sk == 1 &&
      tk % 2 == 0 && bias.sb % 2 == 0 && bias.sh % 2 == 0 &&
      bias.sq % 2 == 0;
  if (bias.p) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bias.p + bi * bias.sb + head * bias.sh +
                min(qpos[r], tq - 1) * bias.sq;
  }

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];  // o of the warp's 16 rows, tiles of 8 head columns
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // tile j in ring slot j % FT_STAGES, q with tile 0; a group is
  // committed every step (empty past the last tile), so that
  // wait<FT_STAGES - 2> always means "tile kt has landed"
  if (n_kv > 0) ft_stage<FT_ROWS>(q_s, q, bi, q0, tq, head);
#pragma unroll
  for (int j = 0; j < FT_STAGES - 1; ++j) {
    if (j < n_kv) {
      ft_stage<BT>(kv_s + 2 * j * FT_TILE, k, bi, j * BT, tk, head);
      ft_stage<BT>(kv_s + (2 * j + 1) * FT_TILE, v, bi, j * BT, tk, head);
    }
    tc::commit();
  }

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BT;
    const bf16* k_s = kv_s + kt % FT_STAGES * 2 * FT_TILE;
    const bf16* v_s = k_s + FT_TILE;
    tc::wait<FT_STAGES - 2>();
    __syncthreads();  // this step's k and v (and q) have landed; the
                      // slot the next load takes was consumed last step
    const int next = kt + FT_STAGES - 1;
    if (next < n_kv) {
      bf16* st = kv_s + next % FT_STAGES * 2 * FT_TILE;
      ft_stage<BT>(st, k, bi, next * BT, tk, head);
      ft_stage<BT>(st + FT_TILE, v, bi, next * BT, tk, head);
    }
    tc::commit();
    // this lane's bias pairs of the tile (keys 8n + col, + 1, as bf16
    // pairs), loaded before the products
    uint32_t sb[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = k0 + 8 * n + col;
        sb[n][r] = 0u;
        if (bias.p && qpos[r] < tq) {
          if (bias_pairs) {
            if (kpos < tk)
              sb[n][r] = *reinterpret_cast<const uint32_t*>(brow[r] + kpos);
          } else {
            const uint16_t* b16 = reinterpret_cast<const uint16_t*>(brow[r]);
            const uint32_t lo = kpos < tk ? b16[(int64_t)kpos * bias.sk] : 0u;
            const uint32_t hi =
                kpos + 1 < tk ? b16[(int64_t)(kpos + 1) * bias.sk] : 0u;
            sb[n][r] = lo | hi << 16;
          }
        }
      }
    // s = q k^T: tiles n of 8 keys, d[2r + e] at row r, key 8n + col + e;
    // q's fragments are read again each step (registers for two more
    // blocks an SM)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qf[4];
      tc::ldsm4(qf, q_s + tc::frag_offset(FT_LD, warp * 16, kc * 16));
#pragma unroll
      for (int kg = 0; kg < 4; ++kg) {
        uint32_t kf[4];
        tc::ldsm4(kf, k_s + tc::frag_offset_nk(FT_LD, kg * 16, kc * 16));
        tc::mma(s[2 * kg], qf, kf[0], kf[1]);
        tc::mma(s[2 * kg + 1], qf, kf[2], kf[3]);
      }
    }
    // scale and bias, in base 2 (s * scale * log2 e + bias * log2 e);
    // the masks where the tile holds an out-of-range or a causally hidden
    // key; the rows' maxima over the quad
    const bool edge = k0 + BT > tk || (causal && k0 + BT - 1 > q0 + offset);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + 8 * n + col + (e & 1);
        const uint32_t b = sb[n][r] >> (16 * (e & 1)) << 16;  // as f32
        float sv = fmaf(s[n][e], scale2,
                        *reinterpret_cast<const float*>(&b) * tc::kLog2e);
        if (edge && (kpos >= tk || (causal && qpos[r] + offset < kpos)))
          sv = kMaskValue;
        s[n][e] = sv;
        mx[r] = fmaxf(mx[r], sv);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = tc::ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        s[n][e] = tc::ex2(s[n][e] - m[r]);
        rs[r] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
    if (DROP) {  // p v takes the dropped p; l summed the undropped
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t plane = (uint32_t)qpos[e >> 1] * tk + k0 + 8 * n +
                                 col + (e & 1);
          if (!hash_rng::keep_attn(hseed, plane, drop.threshold))
            s[n][e] = 0.f;
        }
    }
    // acc += p_hi v + p_lo v, k16 chunk kk = keys 16kk.. of the tile
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dg = 0; dg < D / 16; ++dg) {
        uint32_t vf[4];
        tc::ldsm4_t(vf, v_s + tc::frag_offset(FT_LD, kk * 16, dg * 16));
        tc::mma(acc[2 * dg], ph, vf[0], vf[1]);
        tc::mma(acc[2 * dg], pl, vf[0], vf[1]);
        tc::mma(acc[2 * dg + 1], ph, vf[2], vf[3]);
        tc::mma(acc[2 * dg + 1], pl, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // m is base 2: m * ln 2 the row's maximum score
    const bool masked = (l[r] == 0.f) || (m[r] * tc::kLn2 <= -1e29f);
    const float inv = masked ? 0.f : DROP ? drop.inv_keep / l[r] : 1.f / l[r];
    if (qpos[r] >= tq) continue;
    bf16* dst = o + o_l.at(bi, tq, qpos[r], head) + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          tc::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    if ((lane & 3) == 0)
      lse[((size_t)bi * h + head) * tq + qpos[r]] =
          masked ? INFINITY : m[r] * tc::kLn2 + logf(l[r]);
  }
}

template <class L, bool DROP>
cudaError_t launch_fwd_tc(Rows<L, bf16> q, Rows<L, bf16> k, Rows<L, bf16> v,
                          BiasOf<bf16> bias, bf16* o, L o_l, float* lse,
                          int b, int tq, int tk, int h, float scale,
                          int causal, Dropout drop, cudaStream_t stream) {
  constexpr size_t kSmem = FtShape<L::kWidth>::kSmem;
  static bool configured = false;
  cudaError_t err = allow_smem(flash_fwd_tc_kernel<L, DROP>, kSmem,
                               configured);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + FT_ROWS - 1) / FT_ROWS, h, b);
  flash_fwd_tc_kernel<L, DROP><<<grid, FT_NT, kSmem, stream>>>(
      q, k, v, bias, o, o_l, lse, tq, tk, h, scale, causal, drop);
  return cudaGetLastError();
}

// The tensor-core forward over a grid of (64-row q tiles, heads, batch
// rows): the hashing instantiation only when drop.on.
template <class L>
cudaError_t fwd_tc(Rows<L, bf16> q, Rows<L, bf16> k, Rows<L, bf16> v,
                   BiasOf<bf16> bias, bf16* o, L o_l, float* lse, int b,
                   int tq, int tk, int h, float scale, int causal,
                   Dropout drop, cudaStream_t stream) {
  return drop.on
      ? launch_fwd_tc<L, true>(q, k, v, bias, o, o_l, lse, b, tq, tk, h,
                               scale, causal, drop, stream)
      : launch_fwd_tc<L, false>(q, k, v, bias, o, o_l, lse, b, tq, tk, h,
                                scale, causal, drop, stream);
}

}  // namespace
