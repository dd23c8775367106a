// Fused-projection flash attention, forward only, f32 and bf16, for sm_90a.
//
// Replaces paddle_tpu/kernels/attention.py _qkv_fwd_kernel (the Pallas
// kernel behind flash_qkv_attention).  Computes, for one sequence,
//
//   y = sum_h softmax((x Wq_h)(x Wk_h)^T * scale + bias) (x Wv_h) Wout_h
//
// without q, k or v ever reaching device memory, writes each head's
// context ctx and lse, then runs one GEMM of gemm.cuh for y = ctx W_out.
// The heads run in parallel blocks and the GEMM sums over them in a fixed
// order, so y is the same bits on every run.  (Atomic adds of each head's
// share into y would vary in the last bits; 12 layers deep, that moves
// the training step's gradients by up to 2x their distance to float64.)
//
// Bound: f32 FMA work on the CUDA cores (the run is f32 with TF32 off; no
// tensor cores, whose TF32 or 3xTF32 would change the numerics).  The
// projections are 3/4 of the function's work at t = 256, the attention
// 1/4.  The TPU kernel keeps a whole sequence in VMEM (512-row tiles) and
// so projects every row of q, k and v once; a block here holds at most
// 227 KB of shared memory.  Two routes, chosen by the caller
// (kernels/attention.py qkv_fwd_plan) from the shape before the launch:
//
// * cluster (t <= 512): qkv_cluster_fwd_kernel<R>.  One thread-block
//   cluster of C = ceil(t / R) blocks per (sequence, head), R = 32 or 64
//   rows a block, 128 threads each owning R / 8 rows.  Block r projects
//   rows [rR, rR + R) of q (scaled), k^T and v into its own shared
//   memory, once: the head's three W slabs stream through three cp.async
//   buffers in chunks of 16 rows and x beside them through registers
//   (stored transposed); at R = 64 each thread holds 8 rows x 12 columns
//   (4 each of q, k and v), 96 FMAs per 5 shared float4 loads.  After
//   cluster.sync() the block runs the online softmax of its q rows over
//   the cluster's key tiles in rank order, reading each peer's k^T and v
//   through distributed shared memory (map_shared_rank): the next tile's
//   loads are issued into registers before this tile computes and stored
//   into a local buffer after it, so the products read local shared
//   memory only (reading the peers' tiles inside the product loops was
//   slower at every shape timed on the H100; PERF.md).  Under causal,
//   block r walks ranks 0..r.  A last cluster.sync() keeps every block
//   resident until no peer reads its tiles.  102 KB of shared memory a
//   block at R = 64 lets two blocks share an SM, so one block's barriers
//   and waits overlap the other's arithmetic.  R = 32 where the 64-row
//   grid would leave SMs idle (b = 1: 64 blocks at t = 256, not 32).
// * tiles (t > 512): qkv_tiles_fwd_kernel, 64-row query tiles, grid
//   (ceil(t / 64), n_head, b), each block projecting its q tile and, for
//   every key tile it walks, that tile's k and v again (t / 64 times in
//   all), with a 4x4 patch per thread and no copy pipeline.
//
// Both routes are instantiated for head widths 64 and 128, in f32 (the
// serving path's) and in bf16 (amp training's).  At 128 the
// cluster block doubles its threads (256, a row group a warp) instead of
// each thread's columns, so the projection's accumulators stay 96 a
// thread at R = 64; its layout takes 187 KB (R = 64) or 135 KB (R = 32),
// one block an SM.  The tiles block keeps its 256 threads and each owns
// 8 columns of a 128-wide tile (159 KB).
//
// Weights dropout, as in the bthd forward (flash_attention.cu): l sums
// the undropped p, the p tile multiplying v is dropped by
// hash_rng::keep_attn at (seed, b * n_head + head, q * t + k), the same
// bits #4 draws for that element, and ctx is scaled by 1 / (1 - rate).
// At rate 0 the entry point launches the instantiations that never hash.
//
// Masking follows the TPU kernel: causal and out-of-range keys score
// -1e30; a query row with l == 0 or max <= -1e29 gets a zero context.
// Both routes sum every projection in increasing k and walk keys in
// increasing order, so two calls give the same bits.
//
// bf16 (amp, ptt_qkv_attention_fwd_bf16): x, w_qkv, w_out and the bias
// are bf16, y and ctx bf16, lse f32.  The reference projects in f32 from
// the bf16 x and W (so q, k and v are f32 values), computes p v in f32,
// rounds each head's context to bf16 before its output product and y
// once.  The cluster route runs on tensor cores (qkv_cluster_tc_kernel,
// mma.sync m16n8k16 with ldmatrix fragments): x and the head's W slabs
// are staged as bf16 by a three-stage cp.async ring and projected with
// exact bf16 products summed in f32; q, k and v (and p) are then split
// into hi/lo bf16 pairs (mma.cuh), so s = q k^T and p v each take three
// products (hi hi + hi lo + lo hi) and keep their f32 operands to about
// 16 significant bits.  y = ctx W_out, ctx bf16 as the reference rounds
// it, is gemm.cuh's tensor-core tile (gemm_tc), summed over the heads in
// a fixed order as the f32 GEMM sums it.  MMA work at the amp step's b
// 32, t 256, d_model 512, 8 heads: the projections' 12.9 GFLOP once, s
// and p v 3x their 4.3 (the split), y 4.3: 30 GFLOP of MMAs for the
// function's 21.5.  The tiles route (t > 512) stays f32 arithmetic on
// bf16 operands converted as they load.  At head width 128 the
// tensor-core block gives each row group two warps, one for each 64
// columns of q, k, v and o (both compute the group's s): 256 threads at R
// = 64, 190.5 KB (one block an SM, 242 registers), 132 KB at R = 32;
// the bf16 tiles block takes the f32 tiles' layout (159 KB).
//
// The context ctx [b, t, h, d_head] and lse [b, h, t] (+inf on a masked row)
// are the residuals the backward kernels (#2, #3 in qkv_attention_bwd.cu)
// read, as the TPU kernel always returns them; serving passes scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "gemm.cuh"
#include "hash_rng.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using hash_rng::Dropout;

// ---------------------------------------------------------------------------
// tiles route (t > 512)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per walk step
constexpr int DH = 64;       // head width of the bf16 routes
constexpr int KC = 32;       // reduction chunk of the projections
constexpr int NT = 256;      // threads per block
constexpr int AS = KC + 1;   // row stride of the activation tile
constexpr float kMaskValue = -1e30f;

// Shared-memory layout of qkv_tiles_fwd_kernel at head width D (64 or
// 128), in floats.  Thread (ty, tx) = (tid / 16, tid % 16) owns rows
// 4ty..4ty+3 of every tile, keys 4tx..4tx+3 of the score patch and CW = D
// / 16 columns from CW tx of a D-wide tile.  At D = 64 it takes 91 KB, at
// 128 159 KB.
template <int D>
struct Tiles {
  static constexpr int CW = D / 16;  // columns of a D-wide tile a thread owns
  static constexpr int QS = D + 1;   // row stride of q
  static constexpr int KS = BK + 4;  // row stride of k^T (float4 rows)
  static constexpr int VS = D + 4;   // row stride of v (float4 rows)
  static constexpr int PS = BK + 1;  // row stride of p
  static constexpr int kA = 0;                  // x tile      [BQ][AS]
  static constexpr int kB = kA + BQ * AS;       // two w tiles [2][KC][D]
  static constexpr int kQ = kB + 2 * KC * D;    // q           [BQ][QS]
  static constexpr int kK = kQ + BQ * QS;       // k^T         [D][KS]
  static constexpr int kV = kK + D * KS;        // v           [BK][VS]
  static constexpr int kP = kV + BK * VS;       // p           [BQ][PS]
  static constexpr int kFloats = kP + BQ * PS;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// Load the activation tile x[rows r0.., cols k0..k0+KC) (zero past t).
template <class T>
__device__ __forceinline__ void load_x_tile(float* a_s, const T* xb,
                                            int r0, int t, int dm,
                                            int k0) {
  for (int idx = threadIdx.x; idx < BQ * (KC / 4); idx += NT) {
    int row = idx / (KC / 4);
    int c4 = idx % (KC / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < t)
      v = load4(xb + (size_t)(r0 + row) * dm + k0 + c4 * 4);
    float* dst = a_s + row * AS + c4 * 4;
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
}

// Load the weight tile w[k0..k0+KC, col0..col0+D) with row stride ldw.
template <int D, class T>
__device__ __forceinline__ void load_w_tile(float* b_s, const T* w,
                                            int ldw, int k0, int col0) {
  for (int idx = threadIdx.x; idx < KC * (D / 4); idx += NT) {
    int row = idx / (D / 4);
    int c4 = idx % (D / 4);
    *reinterpret_cast<float4*>(b_s + row * D + c4 * 4) =
        load4(w + (size_t)(k0 + row) * ldw + col0 + c4 * 4);
  }
}

// acc[i][4c..4c+3] += a[i] * b for the four rows i of a thread's patch.
template <int N>
__device__ __forceinline__ void fma_rows4(float (&acc)[4][N], int c,
                                          const float (&a)[4], float4 b) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][4 * c] += a[i] * b.x; acc[i][4 * c + 1] += a[i] * b.y;
    acc[i][4 * c + 2] += a[i] * b.z; acc[i][4 * c + 3] += a[i] * b.w;
  }
}

template <bool DROP, class T = float, int D = DH>
__global__ void __launch_bounds__(NT)
qkv_tiles_fwd_kernel(const T* __restrict__ x,
                         const T* __restrict__ w_qkv,
                         const T* __restrict__ bias,
                         int64_t bs_b, int64_t bs_h, int64_t bs_q,
                         int64_t bs_k, T* ctx, float* lse,
                         int t, int dm, int n_head, float scale,
                         int causal, Dropout drop) {
  using L = Tiles<D>;
  constexpr int CW = L::CW;
  extern __shared__ float smem[];
  float* a_s = smem + L::kA;
  float* b_s = smem + L::kB;
  float* q_s = smem + L::kQ;
  float* kt_s = smem + L::kK;
  float* v_s = smem + L::kV;
  float* p_s = smem + L::kP;

  const int qt = blockIdx.x;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3 of every tile
  const int tx = tid % 16;  // keys tx*4.., columns tx*CW.. of a D tile
  const int hd = n_head * D;
  const int ldw = 3 * hd;
  const int q0 = qt * BQ;
  const T* xb = x + (size_t)bi * t * dm;
  const uint32_t hseed =
      DROP ? hash_rng::attn_head_seed(drop.seed, (uint32_t)(bi * n_head + head))
           : 0u;

  // ---- q tile: (x[q0:q0+BQ] @ Wq_h) * scale ---------------------------
  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < dm; k0 += KC) {
    load_x_tile(a_s, xb, q0, t, dm, k0);
    load_w_tile<D>(b_s, w_qkv, ldw, k0, head * D);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[(ty * 4 + i) * AS + kk];
#pragma unroll
      for (int c = 0; c < CW / 4; ++c)
        fma_rows4(acc, c, av, *reinterpret_cast<const float4*>(
                                  b_s + kk * D + tx * CW + 4 * c));
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j)
      q_s[(ty * 4 + i) * L::QS + tx * CW + j] = acc[i][j] * scale;

  // ---- online-softmax walk over key tiles -----------------------------
  float m[4], l[4], o[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CW; ++j) o[i][j] = 0.f;
  }
  int n_kv = (t + BK - 1) / BK;
  if (causal) {
    int last = min(q0 + BQ, t) - 1;
    n_kv = min(n_kv, last / BK + 1);
  }
  const T* bias_row = bias ? bias + bi * bs_b + head * bs_h : nullptr;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0r = kt * BK;
    // project this key tile's k and v into shared memory
    float ka[4][CW], va[4][CW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CW; ++j) { ka[i][j] = 0.f; va[i][j] = 0.f; }
    for (int k0 = 0; k0 < dm; k0 += KC) {
      load_x_tile(a_s, xb, k0r, t, dm, k0);
      load_w_tile<D>(b_s, w_qkv, ldw, k0, hd + head * D);
      load_w_tile<D>(b_s + KC * D, w_qkv, ldw, k0, 2 * hd + head * D);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        float av[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[(ty * 4 + i) * AS + kk];
#pragma unroll
        for (int c = 0; c < CW / 4; ++c) {
          const float* w = b_s + kk * D + tx * CW + 4 * c;
          fma_rows4(ka, c, av, *reinterpret_cast<const float4*>(w));
          fma_rows4(va, c, av,
                    *reinterpret_cast<const float4*>(w + KC * D));
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < CW; ++j)
        kt_s[(tx * CW + j) * L::KS + ty * 4 + i] = ka[i][j];
#pragma unroll
      for (int c = 0; c < CW / 4; ++c)
        *reinterpret_cast<float4*>(v_s + (ty * 4 + i) * L::VS + tx * CW +
                                   4 * c) =
            make_float4(va[i][4 * c], va[i][4 * c + 1], va[i][4 * c + 2],
                        va[i][4 * c + 3]);
    }
    __syncthreads();

    // scores s = q k^T (+ bias, masks) for this thread's 4x4 patch
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float4 kv = *reinterpret_cast<const float4*>(kt_s + d * L::KS + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float qv = q_s[(ty * 4 + i) * L::QS + d];
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
          s[i][j] += to_f32(bias_row[min(qpos, t - 1) * bs_q + kpos * bs_k]);
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
      for (int j = 0; j < CW; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pv = s[i][j];
        if (DROP && !hash_rng::keep_attn(
                hseed, (uint32_t)qpos * t + k0r + tx * 4 + j,
                drop.threshold))
          pv = 0.f;
        p_s[(ty * 4 + i) * L::PS + tx * 4 + j] = pv;
      }
    }
    __syncthreads();
    // o += p @ v
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * L::PS + kk];
#pragma unroll
      for (int c = 0; c < CW / 4; ++c)
        fma_rows4(o, c, pv, *reinterpret_cast<const float4*>(
                                v_s + kk * L::VS + tx * CW + 4 * c));
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
#pragma unroll
    for (int c = 0; c < CW / 4; ++c)
      store4(ctx + ((size_t)bi * t + qpos) * hd + head * D + tx * CW + 4 * c,
             make_float4(o[i][4 * c] * inv, o[i][4 * c + 1] * inv,
                         o[i][4 * c + 2] * inv, o[i][4 * c + 3] * inv));
    if (tx == 0)
      lse[((size_t)bi * n_head + head) * t + qpos] =
          masked ? INFINITY : m[i] + logf(l[i]);
  }
}


// ---------------------------------------------------------------------------
// cluster route (t <= 512)
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;  // the portable cluster size

// Shared-memory layout of qkv_cluster_fwd_kernel<R, D>, in floats, at
// head width D (64 or 128).  Each of the NT = 2D threads owns TR = R / 8
// consecutive rows (ty * TR.., ty = tid / TX) of its block's R rows and
// columns 4tx..4tx+3 (tx = tid % TX, TX = D / 4) of a D-wide tile.  At D
// = 128 the block has twice the threads (256) rather than each thread
// twice the columns: the projection's accumulators stay 3 x TR x 4 a
// thread (96 at R = 64), and a row group is one warp.  Row-minor tiles
// (q^T, k^T, p^T, x^T) put a thread's rows in TR / 4 float4s.  At D = 64
// and R = 64 the layout takes 102 KB, so two blocks share an SM and one
// block's barriers and waits overlap the other's arithmetic; at D = 128
// it takes 187 KB (R = 64) or 135 KB (R = 32), one block an SM.
template <int R, int D = DH>
struct Cluster {
  static constexpr int TX = D / 4;         // threads across a D-wide tile
  static constexpr int TR = R / 8;         // rows a thread owns
  static constexpr int NT = 8 * TX;        // threads per block
  static constexpr int CK = 16;            // reduction chunk of the projection
  static constexpr int KW = R / TX;        // key columns of a thread's s
  static constexpr int RS = R + 4;         // row stride of row-minor tiles
  static constexpr int VS = D + 4;         // row stride of v
  static constexpr int WS = 3 * D + 4;     // row stride of a W tile (q|k|v)
  // kept from the projection to the end: this block's k^T and v, which
  // its peers read, and its q^T
  static constexpr int kK = 0;                       // k^T [D][RS]
  static constexpr int kV = kK + D * RS;             // v   [R][VS]
  static constexpr int kQ = kV + R * VS;             // q^T [D][RS]
  static constexpr int kStage = kQ + D * RS;
  // the staging area: three projection chunks (x^T [CK][RS], W
  // [CK][WS]); then, once projected, a peer's tiles (k^T and v as laid
  // out above) and the walk's probability tile p^T [R][RS]
  static constexpr int kChunk = CK * RS + CK * WS;
  static constexpr int kPeer = D * RS + R * VS;
  static constexpr int kP = kPeer;
  static constexpr int kStageFloats =
      3 * kChunk > kPeer + R * RS ? 3 * kChunk : kPeer + R * RS;
  static constexpr size_t kBytes = (kStage + kStageFloats) * sizeof(float);
  // float4s of one chunk of x, and how many a thread loads (the last
  // round partial at D = 128, R = 32)
  static constexpr int kXFloat4s = R * CK / 4;
  static constexpr int kXLoads = (kXFloat4s + NT - 1) / NT;
  // float4s of one peer tile a thread copies: its k^T, then its v
  static constexpr int kCopyK = D * R / 4 / NT;
  static constexpr int kCopy = 2 * kCopyK;
  // blocks an SM holds at once
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
};

// cp_async16 and cp_async_commit are gemm.cuh's.

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Load this thread's float4s of x[r0.., k0..k0 + CK) (zeros past t) into
// registers: consecutive threads read consecutive float4s of a row.
template <int R, int D>
__device__ __forceinline__ void load_x(float4 (&xr)[Cluster<R, D>::kXLoads],
                                       const float* xb, int r0, int t,
                                       int dm, int k0) {
  using L = Cluster<R, D>;
#pragma unroll
  for (int u = 0; u < L::kXLoads; ++u) {
    const int idx = threadIdx.x + u * L::NT;
    if (L::kXLoads * L::NT != L::kXFloat4s && idx >= L::kXFloat4s) break;
    const int row = idx / (L::CK / 4);
    const int c4 = idx % (L::CK / 4);
    xr[u] = r0 + row < t ? load4(xb + (size_t)(r0 + row) * dm + k0 + c4 * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Store them transposed into a chunk's x^T [CK][RS].
template <int R, int D>
__device__ __forceinline__ void store_x(
    float* xt, const float4 (&xr)[Cluster<R, D>::kXLoads]) {
  using L = Cluster<R, D>;
#pragma unroll
  for (int u = 0; u < L::kXLoads; ++u) {
    const int idx = threadIdx.x + u * L::NT;
    if (L::kXLoads * L::NT != L::kXFloat4s && idx >= L::kXFloat4s) break;
    float* dst = xt + (idx % (L::CK / 4)) * 4 * L::RS + idx / (L::CK / 4);
    dst[0] = xr[u].x;
    dst[L::RS] = xr[u].y;
    dst[2 * L::RS] = xr[u].z;
    dst[3 * L::RS] = xr[u].w;
  }
}

// Start copying rows [k0, k0 + CK) of the head's three W slabs into a
// chunk's W [CK][WS] by cp.async.
template <int R, int D>
__device__ __forceinline__ void stage_w(float* ws, const float* w_qkv,
                                        int ldw, int hd, int head, int k0) {
  using L = Cluster<R, D>;
  for (int idx = threadIdx.x; idx < L::CK * 3 * (D / 4); idx += L::NT) {
    const int kk = idx / (3 * (D / 4));
    const int c4 = idx % (3 * (D / 4));
    const int slab = c4 / (D / 4);
    const int col = (c4 % (D / 4)) * 4;
    cp_async16(ws + kk * L::WS + slab * D + col,
               w_qkv + (size_t)(k0 + kk) * ldw + slab * hd + head * D + col);
  }
}

// a[0..N) = the N floats at src (16-byte aligned), as float4 loads.
template <int N>
__device__ __forceinline__ void load_row(float (&a)[N], const float* src) {
#pragma unroll
  for (int u = 0; u < N / 4; ++u) {
    const float4 v = *reinterpret_cast<const float4*>(src + 4 * u);
    a[4 * u] = v.x; a[4 * u + 1] = v.y; a[4 * u + 2] = v.z;
    a[4 * u + 3] = v.w;
  }
}

// acc[i][j] += a[i] * b[j]
template <int N>
__device__ __forceinline__ void fma_outer(float (&acc)[N][4],
                                          const float (&a)[N], float4 b) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i][0] += a[i] * b.x; acc[i][1] += a[i] * b.y;
    acc[i][2] += a[i] * b.z; acc[i][3] += a[i] * b.w;
  }
}

// Store column j of a thread's rows, acc[0..N)[j] * mul, at dst (16-byte
// aligned) as float4s.
template <int N, int M>
__device__ __forceinline__ void store_col(float* dst, const float (&acc)[N][M],
                                          int j, float mul) {
#pragma unroll
  for (int u = 0; u < N / 4; ++u)
    *reinterpret_cast<float4*>(dst + 4 * u) =
        make_float4(acc[4 * u][j] * mul, acc[4 * u + 1][j] * mul,
                    acc[4 * u + 2][j] * mul, acc[4 * u + 3][j] * mul);
}

// Issue this thread's loads of peer `rank`'s k^T and v tiles.
template <int R, int D>
__device__ __forceinline__ void load_peer(float4 (&reg)[Cluster<R, D>::kCopy],
                                          cg::cluster_group& cluster,
                                          float* smem, int rank) {
  using L = Cluster<R, D>;
  const float* kt = cluster.map_shared_rank(smem + L::kK, rank);
  const float* v = cluster.map_shared_rank(smem + L::kV, rank);
#pragma unroll
  for (int c = 0; c < L::kCopyK; ++c) {
    const int idx = threadIdx.x + c * L::NT;
    reg[c] = *reinterpret_cast<const float4*>(
        kt + (idx / (R / 4)) * L::RS + (idx % (R / 4)) * 4);
    reg[L::kCopyK + c] = *reinterpret_cast<const float4*>(
        v + (idx / (D / 4)) * L::VS + (idx % (D / 4)) * 4);
  }
}

// Store loaded peer tiles into `buf` in the same layout.
template <int R, int D>
__device__ __forceinline__ void store_peer(
    float* buf, const float4 (&reg)[Cluster<R, D>::kCopy]) {
  using L = Cluster<R, D>;
#pragma unroll
  for (int c = 0; c < L::kCopyK; ++c) {
    const int idx = threadIdx.x + c * L::NT;
    *reinterpret_cast<float4*>(buf + (idx / (R / 4)) * L::RS +
                               (idx % (R / 4)) * 4) = reg[c];
    *reinterpret_cast<float4*>(buf + D * L::RS + (idx / (D / 4)) * L::VS +
                               (idx % (D / 4)) * 4) = reg[L::kCopyK + c];
  }
}

// Grid (C, n_head, b), cluster (C, 1, 1), C = ceil(t / R) <= 8; f32, head
// width D.
template <int R, bool DROP, int D = DH>
__global__ void __launch_bounds__(Cluster<R, D>::NT, Cluster<R, D>::kMinBlocks)
qkv_cluster_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w_qkv,
                       const float* __restrict__ bias, int64_t bs_b,
                       int64_t bs_h, int64_t bs_q, int64_t bs_k, float* ctx,
                       float* lse, int t, int dm, int n_head, float scale,
                       int causal, Dropout drop) {
  using L = Cluster<R, D>;
  constexpr int TR = L::TR;
  constexpr int KW = L::KW;
  constexpr int TX = L::TX;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  float* kt_s = smem + L::kK;
  float* v_s = smem + L::kV;
  float* qt_s = smem + L::kQ;
  float* stage = smem + L::kStage;
  float* pt_s = stage + L::kP;

  const int rank = (int)cluster.block_rank();
  const int n_rank = (int)gridDim.x;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / TX;
  const int tx = tid % TX;
  const int hd = n_head * D;
  const int r0 = rank * R;
  const int row0 = r0 + ty * TR;  // this thread's first row
  const float* xb = x + (size_t)bi * t * dm;

  // ---- project rows r0.. of q, k, v: each row of the sequence once ----
  float aq[TR][4], ak[TR][4], av[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) aq[i][j] = ak[i][j] = av[i][j] = 0.f;
  // three chunk buffers: W of chunk c + 2 and x of chunk c + 1 load while
  // chunk c multiplies (x through registers, to be stored transposed)
  const int n_chunk = dm / L::CK;
  const int ldw = 3 * hd;
  float4 xr[L::kXLoads];
  load_x<R, D>(xr, xb, r0, t, dm, 0);
  stage_w<R, D>(stage + L::CK * L::RS, w_qkv, ldw, hd, head, 0);
  cp_async_commit();
  store_x<R, D>(stage, xr);
  if (n_chunk > 1) {
    load_x<R, D>(xr, xb, r0, t, dm, L::CK);
    stage_w<R, D>(stage + L::kChunk + L::CK * L::RS, w_qkv, ldw, hd, head,
                  L::CK);
  }
  cp_async_commit();
  for (int c = 0; c < n_chunk; ++c) {
    cp_async_wait_all_but_last();  // W of chunk c has landed
    __syncthreads();  // ... for every thread, and chunk c - 1 is read
    if (c + 1 < n_chunk) store_x<R, D>(stage + (c + 1) % 3 * L::kChunk, xr);
    if (c + 2 < n_chunk) {
      float* next = stage + (c + 2) % 3 * L::kChunk;
      load_x<R, D>(xr, xb, r0, t, dm, (c + 2) * L::CK);
      stage_w<R, D>(next + L::CK * L::RS, w_qkv, ldw, hd, head,
                    (c + 2) * L::CK);
    }
    cp_async_commit();
    const float* xt = stage + c % 3 * L::kChunk;
    const float* ws = xt + L::CK * L::RS;
#pragma unroll 4
    for (int kk = 0; kk < L::CK; ++kk) {
      float a[TR];
      load_row(a, xt + kk * L::RS + ty * TR);
      const float* w = ws + kk * L::WS + tx * 4;
      fma_outer(aq, a, *reinterpret_cast<const float4*>(w));
      fma_outer(ak, a, *reinterpret_cast<const float4*>(w + D));
      fma_outer(av, a, *reinterpret_cast<const float4*>(w + 2 * D));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = tx * 4 + j;
    store_col(qt_s + d * L::RS + ty * TR, aq, j, scale);
    store_col(kt_s + d * L::RS + ty * TR, ak, j, 1.f);
  }
#pragma unroll
  for (int i = 0; i < TR; ++i)
    *reinterpret_cast<float4*>(v_s + (ty * TR + i) * L::VS + tx * 4) =
        make_float4(av[i][0], av[i][1], av[i][2], av[i][3]);
  cluster.sync();  // every block's k^T and v are ready

  // ---- online-softmax walk over the cluster's key tiles ---------------
  const uint32_t hseed =
      DROP ? hash_rng::attn_head_seed(drop.seed, (uint32_t)(bi * n_head + head))
           : 0u;
  const float* bias_row = bias ? bias + bi * bs_b + head * bs_h : nullptr;
  float m[TR], l[TR], o[TR][4];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }
  const int n_kv = causal ? rank + 1 : n_rank;
  float4 peer[L::kCopy];
  load_peer<R, D>(peer, cluster, smem, 0);
  store_peer<R, D>(stage, peer);
  __syncthreads();
  const float* kt_b = stage;
  const float* v_b = stage + D * L::RS;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0r = kt * R;
    if (kt + 1 < n_kv) load_peer<R, D>(peer, cluster, smem, kt + 1);
    // this patch's bias and masks, loaded before the products
    float sb[TR][KW];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = row0 + i;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const int kpos = k0r + tx * KW + j;
        const bool hidden = kpos >= t || (causal && kpos > qpos);
        sb[i][j] = hidden     ? kMaskValue
                   : bias_row ? bias_row[min(qpos, t - 1) * bs_q +
                                         kpos * bs_k]
                              : 0.f;
      }
    }

    // scores s = q k^T (+ bias, masks) for this thread's TR x KW patch
    float s[TR][KW];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < KW; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[TR];
      load_row(qv, qt_s + d * L::RS + ty * TR);
      float kv[KW];
      if constexpr (KW == 4) {
        load_row(kv, kt_b + d * L::RS + tx * 4);
      } else if constexpr (KW == 2) {
        const float2 k2 =
            *reinterpret_cast<const float2*>(kt_b + d * L::RS + tx * 2);
        kv[0] = k2.x; kv[1] = k2.y;
      } else {
        kv[0] = kt_b[d * L::RS + tx];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < KW; ++j) s[i][j] += qv[i] * kv[j];
    }
    // row max / sum across the TX threads that share a row group
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < KW; ++j)
        s[i][j] = sb[i][j] == kMaskValue ? kMaskValue : s[i][j] + sb[i][j];
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KW; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < KW; ++j)
        if (DROP && !hash_rng::keep_attn(
                hseed, (uint32_t)(row0 + i) * t + k0r + tx * KW + j,
                drop.threshold))
          s[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < KW; ++j)
      store_col(pt_s + (tx * KW + j) * L::RS + ty * TR, s, j, 1.f);
    __syncthreads();
    // o += p @ v
#pragma unroll 4
    for (int kk = 0; kk < R; ++kk) {
      float pa[TR];
      load_row(pa, pt_s + kk * L::RS + ty * TR);
      fma_outer(o, pa,
                *reinterpret_cast<const float4*>(v_b + kk * L::VS + tx * 4));
    }
    __syncthreads();  // this tile and p^T are read
    if (kt + 1 < n_kv) {
      store_peer<R, D>(stage, peer);
      __syncthreads();  // the next tile is ready
    }
  }

  // ---- context (masked rows give 0) and lse ---------------------------
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const bool masked = (l[i] == 0.f) || (m[i] <= -1e29f);
    const float inv = masked ? 0.f
                             : (DROP ? drop.inv_keep / l[i] : 1.f / l[i]);
    const int qpos = row0 + i;
    if (qpos >= t) continue;
    store4(ctx + ((size_t)bi * t + qpos) * hd + head * D + tx * 4,
           make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv,
                       o[i][3] * inv));
    if (tx == 0)
      lse[((size_t)bi * n_head + head) * t + qpos] =
          masked ? INFINITY : m[i] + logf(l[i]);
  }
  cluster.sync();  // no block leaves while a peer may still read its tiles
}

// ---------------------------------------------------------------------------
// cluster route in bf16 (amp), on tensor cores
// ---------------------------------------------------------------------------

// Shared-memory layout of qkv_cluster_tc_kernel<R, DROP, D>, in bf16
// elements, at head width D (64 or 128).  R / 16 row groups of 16 of the
// block's R rows, each taken by G = D / 64 warps, one for each 64 columns
// of the head (warp w: rows 16 (w % (R / 16)).., columns 64 (w / (R /
// 16))..), so that a lane's projection accumulators stay 96 f32 (16 rows
// x 64 columns of each of q, k and v) and its o 32 at either width.
// Kept from the projection to the end: the block's k and v as hi/lo bf16
// tiles (k_hi, k_lo, v_hi, v_lo, [R][LD] each, stacked), which its peers
// read, and its q as hi/lo tiles (the warps of a row group read their
// rows).  The staging area holds the projection's ring of three x / W
// chunks, then the copy of the key tile being walked (its four tiles, as
// laid out above).  Rows are padded to D + 8 (x: 40, W: 3 D + 8)
// elements, so the 8 rows an ldmatrix reads fall in distinct 16-byte bank
// groups.  At 64: 106.5 KB (R 64) and 55.5 KB (R 32), two blocks an SM;
// at 128: 190.5 KB and 132 KB, one.
template <int R, int D>
struct ClusterTc {
  static constexpr int G = D / 64;           // warps of a row group
  static constexpr int NW = R / 16 * G;      // warps
  static constexpr int NT = 32 * NW;         // threads per block
  static constexpr int LD = D + 8;           // row stride of a q, k, v tile
  static constexpr int CK = 32;              // depth of a projection chunk
  static constexpr int XLD = CK + 8;         // row stride of x [R][CK]
  static constexpr int WLD = 3 * D + 8;      // row stride of W [CK][q|k|v]
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
  static constexpr int kTile = R * LD;
  static constexpr int kKV = 4 * kTile;      // k_hi, k_lo, v_hi, v_lo
  static constexpr int kQ = kKV;             // then q_hi, q_lo
  static constexpr int kStage = kQ + 2 * kTile;
  static constexpr int kChunk = R * XLD + CK * WLD;
  static constexpr int kStages = 3;
  static constexpr int kStageElems =
      kStages * kChunk > kKV ? kStages * kChunk : kKV;
  static constexpr size_t kBytes =
      (size_t)(kStage + kStageElems) * sizeof(bf16);
  // 16-byte pieces of two of a key tile's four tiles a thread copies
  static constexpr int kCopy = 2 * R * (D / 8) / NT;
};

// Start the copy of projection chunk k0.. into st: x rows r0.. (zeros
// past t) [R][CK] and rows k0.. of the head's three W slabs [CK][3 D].
template <int R, int D>
__device__ __forceinline__ void stage_chunk_tc(bf16* st, const bf16* xb,
                                               const bf16* w_qkv, int r0,
                                               int t, int dm, int ldw,
                                               int hd, int head, int k0) {
  using L = ClusterTc<R, D>;
#pragma unroll
  for (int u = 0; u < R * (L::CK / 8) / L::NT; ++u) {
    const int idx = threadIdx.x + u * L::NT;
    const int row = idx / (L::CK / 8);
    const int c8 = idx % (L::CK / 8) * 8;
    const bool in = r0 + row < t;
    tc::copy16(st + row * L::XLD + c8,
               xb + (size_t)(in ? r0 + row : r0) * dm + k0 + c8,
               in ? 16 : 0);
  }
  bf16* ws = st + R * L::XLD;
#pragma unroll
  for (int u = 0; u < L::CK * 3 * (D / 8) / L::NT; ++u) {
    const int idx = threadIdx.x + u * L::NT;
    const int kk = idx / (3 * (D / 8));
    const int c = idx % (3 * (D / 8));
    const int slab = c / (D / 8);
    const int c8 = c % (D / 8) * 8;
    tc::copy16(ws + kk * L::WLD + slab * D + c8,
               w_qkv + (size_t)(k0 + kk) * ldw + slab * hd + head * D + c8,
               16);
  }
}

// Issue this thread's loads of half `half` (0: k_hi, k_lo; 1: v_hi, v_lo)
// of peer `rank`'s key tile.
template <int R, int D>
__device__ __forceinline__ void load_peer_tc(
    uint4 (&reg)[ClusterTc<R, D>::kCopy], cg::cluster_group& cluster,
    bf16* kv_s, int rank, int half) {
  using L = ClusterTc<R, D>;
  const bf16* peer =
      cluster.map_shared_rank(kv_s, rank) + half * 2 * L::kTile;
#pragma unroll
  for (int u = 0; u < L::kCopy; ++u) {
    const int idx = threadIdx.x + u * L::NT;
    reg[u] = *reinterpret_cast<const uint4*>(
        peer + (idx / (D / 8)) * L::LD + idx % (D / 8) * 8);
  }
}

// Store a loaded half into `buf`, laid out as the peer's tiles.
template <int R, int D>
__device__ __forceinline__ void store_peer_tc(
    bf16* buf, const uint4 (&reg)[ClusterTc<R, D>::kCopy], int half) {
  using L = ClusterTc<R, D>;
  buf += half * 2 * L::kTile;
#pragma unroll
  for (int u = 0; u < L::kCopy; ++u) {
    const int idx = threadIdx.x + u * L::NT;
    *reinterpret_cast<uint4*>(buf + (idx / (D / 8)) * L::LD +
                              idx % (D / 8) * 8) = reg[u];
  }
}

// Store an f32 D fragment pair (rows g, g + 8 of tile n) of a 16-row
// block at rows wr.. as hi/lo bf16 tiles hi_s, lo_s (row stride ld).
__device__ __forceinline__ void store_split(bf16* hi_s, bf16* lo_s, int ld,
                                            int wr, int n,
                                            const float (&d)[4], float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int at = (wr + (lane >> 2) + 8 * r) * ld + 8 * n + 2 * (lane & 3);
    uint32_t hi, lo;
    tc::split(d[2 * r] * mul, d[2 * r + 1] * mul, hi, lo);
    *reinterpret_cast<uint32_t*>(hi_s + at) = hi;
    *reinterpret_cast<uint32_t*>(lo_s + at) = lo;
  }
}

// #1's cluster route on bf16 tensors: grid (C, n_head, b), cluster (C, 1,
// 1), C = ceil(t / R) <= 8, R / 16 warps.  The projection x W of the
// block's rows, on tensor cores with exact bf16 products and f32 sums
// (the reference's f32 projection of bf16 operands), leaves q (scaled),
// k and v in f32 accumulator fragments; each is split into hi/lo bf16
// tiles in shared memory (mma.cuh).  The walk is the f32 route's (the
// cluster's key tiles in rank order, each copied from its block through
// distributed shared memory into the staging area, in two halves: a
// tile's v while its scores' k is still read, the next tile's k and v
// while this one's products run), with s = q_lo k_hi + q_hi k_lo + q_hi
// k_hi and p v = p_lo v_hi + p_hi v_lo + p_hi v_hi (p split on its
// fragments, never in shared memory), each summed in f32; the softmax in
// base 2 (scores times log2 e, ex2).
//
// Registers: q's fragments come from shared memory per step, and the
// peer copy holds half a tile (kCopy uint4s), so that the walk, with o,
// s and the bias pairs in registers, fits two blocks an SM without
// spills: 240 registers and 106.5 KB of shared memory at R = 64 (a whole
// tile's copy in registers and q's fragments kept spilled at 255).  MMA
// work a block at R = 64: the projection 48 mma.sync a 32-deep chunk a
// warp, the walk 96 + 96 a key tile a warp (3 each for s and p v).
// Per-phase clocks on an H100 (chip_tc_phases.py, PERF.md): the
// projection's MMAs take a third of a block, s a sixth, the peer copies
// and their barriers an eighth.
template <int R, bool DROP, int D>
__global__ void __launch_bounds__(ClusterTc<R, D>::NT,
                                  ClusterTc<R, D>::kMinBlocks)
qkv_cluster_tc_kernel(const bf16* __restrict__ x,
                      const bf16* __restrict__ w_qkv,
                      const bf16* __restrict__ bias, int64_t bs_b,
                      int64_t bs_h, int64_t bs_q, int64_t bs_k, bf16* ctx,
                      float* lse, int t, int dm, int n_head, float scale,
                      int causal, Dropout drop) {
  using L = ClusterTc<R, D>;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  bf16* kv_s = reinterpret_cast<bf16*>(smem);  // k_hi, k_lo, v_hi, v_lo
  bf16* q_s = kv_s + L::kQ;                    // q_hi, q_lo
  bf16* stage = kv_s + L::kStage;

  const int rank = (int)cluster.block_rank();
  const int n_rank = (int)gridDim.x;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the warp's first row and its first head column
  const int wr = (L::G == 1 ? warp : warp % (R / 16)) * 16;
  const int c0 = L::G == 1 ? 0 : warp / (R / 16) * 64;
  const int col = 2 * (lane & 3);       // the lane's first column
  const int hd = n_head * D;
  const int ldw = 3 * hd;
  const int r0 = rank * R;
  const bf16* xb = x + (size_t)bi * t * dm;

  // ---- project rows r0 + wr.. of q | k | v, columns c0.. of each: 24
  // tiles of 8 columns ------
  {
    float pa[24][4];
#pragma unroll
    for (int n = 0; n < 24; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[n][e] = 0.f;
    // chunk c in ring slot c % 3; a group is committed every chunk (empty
    // past the last), so that wait<1> always means "chunk c landed"
    const int n_chunk = dm / L::CK;
#pragma unroll
    for (int c = 0; c < L::kStages - 1; ++c) {
      if (c < n_chunk)
        stage_chunk_tc<R, D>(stage + c * L::kChunk, xb, w_qkv, r0, t, dm,
                             ldw, hd, head, c * L::CK);
      tc::commit();
    }
    for (int c = 0; c < n_chunk; ++c) {
      tc::wait<L::kStages - 2>();
      __syncthreads();  // chunk c has landed; slot (c + 2) % 3 is consumed
      if (c + L::kStages - 1 < n_chunk)
        stage_chunk_tc<R, D>(stage + (c + L::kStages - 1) % L::kStages *
                                         L::kChunk,
                             xb, w_qkv, r0, t, dm, ldw, hd, head,
                             (c + L::kStages - 1) * L::CK);
      tc::commit();
      const bf16* xs = stage + c % L::kStages * L::kChunk;
      const bf16* ws = xs + R * L::XLD;
#pragma unroll
      for (int ks = 0; ks < L::CK / 16; ++ks) {
        uint32_t af[4];
        tc::ldsm4(af, xs + tc::frag_offset(L::XLD, wr, 16 * ks));
#pragma unroll
        for (int jp = 0; jp < 12; ++jp) {  // slab jp / 4, 16 columns jp % 4
          uint32_t bf[4];
          tc::ldsm4_t(bf, ws + tc::frag_offset(L::WLD, 16 * ks,
                                               jp / 4 * D + c0 +
                                                   16 * (jp % 4)));
          tc::mma(pa[2 * jp], af, bf[0], bf[1]);
          tc::mma(pa[2 * jp + 1], af, bf[2], bf[3]);
        }
      }
    }
    // q (scaled, in base 2: the scores come out times log2 e), k and v as
    // hi/lo tiles
    const float q_mul = scale * tc::kLog2e;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int nc = c0 / 8 + n;  // the 8-column tile of the head
      store_split(q_s, q_s + L::kTile, L::LD, wr, nc, pa[n], q_mul);
      store_split(kv_s, kv_s + L::kTile, L::LD, wr, nc, pa[8 + n], 1.f);
      store_split(kv_s + 2 * L::kTile, kv_s + 3 * L::kTile, L::LD, wr, nc,
                  pa[16 + n], 1.f);
    }
  }
  cluster.sync();  // every block's k and v are ready; the ring is read

  // ---- online-softmax walk over the cluster's key tiles ---------------
  const uint32_t hseed =
      DROP ? hash_rng::attn_head_seed(drop.seed, (uint32_t)(bi * n_head + head))
           : 0u;
  int qpos[2];  // the lane's rows: the warp's row g and g + 8
  qpos[0] = r0 + wr + (lane >> 2);
  qpos[1] = qpos[0] + 8;
  const bf16* brow[2] = {nullptr, nullptr};
  if (bias) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bias + bi * bs_b + head * bs_h + min(qpos[r], t - 1) * bs_q;
  }
  // a bias pair (keys k, k + 1) is one 4-byte load where the base is
  // 4-byte aligned, every offset of it is even and its rows are
  // contiguous in k (a view may start at an odd element)
  const bool bias_pairs = reinterpret_cast<uintptr_t>(bias) % 4 == 0 &&
                          bs_k == 1 && t % 2 == 0 && bs_b % 2 == 0 &&
                          bs_h % 2 == 0 && bs_q % 2 == 0;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int n_kv = causal ? rank + 1 : n_rank;
  const bf16* kh_s = stage;  // the walked tile's copy
  const bf16* kl_s = stage + L::kTile;
  const bf16* vh_s = stage + 2 * L::kTile;
  const bf16* vl_s = stage + 3 * L::kTile;
  uint4 peer[L::kCopy];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    load_peer_tc<R, D>(peer, cluster, kv_s, 0, half);
    store_peer_tc<R, D>(stage, peer, half);
  }
  __syncthreads();
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0r = kt * R;
    const bool more = kt + 1 < n_kv;
    if (more) load_peer_tc<R, D>(peer, cluster, kv_s, kt + 1, 0);
    // this lane's bias pairs of the tile (keys 8n + col, + 1), loaded
    // before the products
    uint32_t sb[R / 8][2];
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = k0r + 8 * n + col;
        sb[n][r] = 0u;
        if (brow[r] && bias_pairs) {
          if (kpos < t)
            sb[n][r] = *reinterpret_cast<const uint32_t*>(brow[r] + kpos);
        } else if (brow[r]) {
          const uint16_t* b16 = reinterpret_cast<const uint16_t*>(brow[r]);
          const uint32_t lo = kpos < t ? b16[kpos * bs_k] : 0u;
          const uint32_t hi = kpos + 1 < t ? b16[(kpos + 1) * bs_k] : 0u;
          sb[n][r] = lo | hi << 16;
        }
      }
    // s = q k^T in base 2, over the head's D / 16 chunks of 16 columns
    float s[R / 8][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t qh[4], ql[4];
      const int qa = tc::frag_offset(L::LD, wr, 16 * kc);
      tc::ldsm4(qh, q_s + qa);
      tc::ldsm4(ql, q_s + L::kTile + qa);
#pragma unroll
      for (int kg = 0; kg < R / 16; ++kg) {
        uint32_t kh[4], kl[4];
        const int at = tc::frag_offset_nk(L::LD, 16 * kg, 16 * kc);
        tc::ldsm4(kh, kh_s + at);
        tc::ldsm4(kl, kl_s + at);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          tc::mma(s[2 * kg + h2], ql, kh[2 * h2], kh[2 * h2 + 1]);
          tc::mma(s[2 * kg + h2], qh, kl[2 * h2], kl[2 * h2 + 1]);
          tc::mma(s[2 * kg + h2], qh, kh[2 * h2], kh[2 * h2 + 1]);
        }
      }
    }
    // the bias (in base 2) and, where the tile holds an out-of-range or a
    // causally hidden key, the masks; the rows' maxima over the quad
    const bool edge = k0r + R > t || (causal && k0r + R - 1 > r0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0r + 8 * n + col + (e & 1);
        const uint32_t b = sb[n][r] >> (16 * (e & 1)) << 16;
        s[n][e] = fmaf(*reinterpret_cast<const float*>(&b), tc::kLog2e,
                       s[n][e]);
        if (edge && (kpos >= t || (causal && kpos > qpos[r])))
          s[n][e] = kMaskValue;
        mx[r] = fmaxf(mx[r], s[n][e]);
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
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = tc::ex2(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    if (DROP) {  // p v takes the dropped p; l summed the undropped
#pragma unroll
      for (int n = 0; n < R / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!hash_rng::keep_attn(
                  hseed,
                  (uint32_t)qpos[e >> 1] * t + k0r + 8 * n + col + (e & 1),
                  drop.threshold))
            s[n][e] = 0.f;
    }
    if (more) {  // the next tile's k replaces this one's, read by now
      __syncthreads();
      store_peer_tc<R, D>(stage, peer, 0);
      load_peer_tc<R, D>(peer, cluster, kv_s, kt + 1, 1);
    }
    // o += p v over the tile's k16 chunks, the warp's 64 head columns
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t ph[4], pl[4];
      tc::split_a(s[2 * kk], s[2 * kk + 1], ph, pl);
#pragma unroll
      for (int dg = 0; dg < 4; ++dg) {
        uint32_t vh[4], vl[4];
        const int at = tc::frag_offset(L::LD, 16 * kk, c0 + 16 * dg);
        tc::ldsm4_t(vh, vh_s + at);
        tc::ldsm4_t(vl, vl_s + at);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          tc::mma(o[2 * dg + h2], pl, vh[2 * h2], vh[2 * h2 + 1]);
          tc::mma(o[2 * dg + h2], ph, vl[2 * h2], vl[2 * h2 + 1]);
          tc::mma(o[2 * dg + h2], ph, vh[2 * h2], vh[2 * h2 + 1]);
        }
      }
    }
    if (more) {  // ... and its v this one's
      __syncthreads();
      store_peer_tc<R, D>(stage, peer, 1);
      __syncthreads();  // the next tile is whole
    }
  }

  // ---- context (masked rows give 0) and lse ---------------------------
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // m is base 2: m * ln 2 the row's maximum score
    const bool masked = (l[r] == 0.f) || (m[r] * tc::kLn2 <= -1e29f);
    const float inv = masked ? 0.f
                             : (DROP ? drop.inv_keep / l[r] : 1.f / l[r]);
    if (qpos[r] >= t) continue;
    bf16* dst =
        ctx + ((size_t)bi * t + qpos[r]) * hd + head * D + c0 + col;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          tc::pack(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if ((lane & 3) == 0 && c0 == 0)
      lse[((size_t)bi * n_head + head) * t + qpos[r]] =
          masked ? INFINITY : m[r] * tc::kLn2 + logf(l[r]);
  }
  cluster.sync();  // no block leaves while a peer may still read its tiles
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The arguments both attention kernels take, their tensors of T.
template <class T>
struct FwdArgs {
  const T* x;
  const T* w_qkv;
  const T* bias;
  int64_t bs_b, bs_h, bs_q, bs_k;
  T* ctx;
  float* lse;
  int b, t, dm, n_head;
  float scale;
  int causal;
  Dropout drop;
};

template <bool DROP, class T, int D>
cudaError_t launch_tiles(const FwdArgs<T>& a, cudaStream_t stream) {
  constexpr size_t kBytes = Tiles<D>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        qkv_tiles_fwd_kernel<DROP, T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.t + BQ - 1) / BQ, a.n_head, a.b);
  qkv_tiles_fwd_kernel<DROP, T, D><<<grid, NT, kBytes, stream>>>(
      a.x, a.w_qkv, a.bias, a.bs_b, a.bs_h, a.bs_q, a.bs_k, a.ctx, a.lse,
      a.t, a.dm, a.n_head, a.scale, a.causal, a.drop);
  return cudaGetLastError();
}

// Launch configuration of a cluster kernel of layout L (Cluster<R, D> or
// ClusterTc<R, D>): grid (C, n_head, b), one cluster of C blocks along x.
// `attr` must outlive the returned config.
template <class L>
cudaLaunchConfig_t cluster_config(int c, int n_head, int b,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, n_head, b);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int R, bool DROP, int D>
cudaError_t configure_cluster() {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        qkv_cluster_fwd_kernel<R, DROP, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cluster<R, D>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

// The cluster route in f32 (qkv_cluster_fwd_kernel) or, on bf16 tensors,
// on tensor cores (qkv_cluster_tc_kernel), at head width D.
template <int R, bool DROP, class T, int D>
cudaError_t launch_cluster(const FwdArgs<T>& a, int c, cudaStream_t stream) {
  cudaError_t err;
  cudaLaunchAttribute attr[1];
  if constexpr (std::is_same<T, bf16>::value) {
    static bool configured = false;
    err = allow_smem(qkv_cluster_tc_kernel<R, DROP, D>,
                     ClusterTc<R, D>::kBytes, configured);
    if (err != cudaSuccess) return err;
    const cudaLaunchConfig_t cfg =
        cluster_config<ClusterTc<R, D>>(c, a.n_head, a.b, attr, stream);
    err = cudaLaunchKernelEx(&cfg, qkv_cluster_tc_kernel<R, DROP, D>, a.x,
                             a.w_qkv, a.bias, a.bs_b, a.bs_h, a.bs_q,
                             a.bs_k, a.ctx, a.lse, a.t, a.dm, a.n_head,
                             a.scale, a.causal, a.drop);
  } else {
    err = configure_cluster<R, DROP, D>();
    if (err != cudaSuccess) return err;
    const cudaLaunchConfig_t cfg =
        cluster_config<Cluster<R, D>>(c, a.n_head, a.b, attr, stream);
    err = cudaLaunchKernelEx(&cfg, qkv_cluster_fwd_kernel<R, DROP, D>, a.x,
                             a.w_qkv, a.bias, a.bs_b, a.bs_h, a.bs_q,
                             a.bs_k, a.ctx, a.lse, a.t, a.dm, a.n_head,
                             a.scale, a.causal, a.drop);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool DROP, class T, int D>
cudaError_t launch_attention(const FwdArgs<T>& a, int c, int r,
                             cudaStream_t stream) {
  if (r == 0) return launch_tiles<DROP, T, D>(a, stream);
  return r == 32 ? launch_cluster<32, DROP, T, D>(a, c, stream)
                 : launch_cluster<64, DROP, T, D>(a, c, stream);
}

// The instantiation of a head width: f32 and bf16 at 64 and 128.
template <bool DROP, class T>
cudaError_t launch_width(const FwdArgs<T>& a, int c, int r, int d_head,
                         cudaStream_t stream) {
  if (d_head == 64) return launch_attention<DROP, T, 64>(a, c, r, stream);
  if (d_head == 128) return launch_attention<DROP, T, 128>(a, c, r, stream);
  return cudaErrorInvalidValue;
}

// #1 on tensors of T: ptt_qkv_attention_fwd's arguments.
template <class T>
int qkv_attention_fwd(const T* x, const T* w_qkv, const T* w_out,
                      const T* bias, int64_t bs_b, int64_t bs_h,
                      int64_t bs_q, int64_t bs_k, T* y, T* ctx, float* lse,
                      float* partials, int b, int t, int dm, int n_head,
                      int d_head, int cluster_rows, int sms, float scale,
                      int causal, double rate, unsigned seed,
                      unsigned threshold, void* stream) {
  const int cluster_size =
      cluster_rows > 0 ? (t + cluster_rows - 1) / cluster_rows : 0;
  if (cluster_rows != 0 &&
      !((cluster_rows == 32 || cluster_rows == 64) &&
        cluster_size <= kMaxCluster))
    return (int)cudaErrorInvalidValue;
  if (d_head != 64 && d_head != 128) return (int)cudaErrorInvalidValue;
  const FwdArgs<T> a{x, w_qkv, bias, bs_b, bs_h, bs_q, bs_k, ctx, lse, b, t,
                     dm, n_head, scale, causal,
                     hash_rng::make_dropout(rate, seed, threshold)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      a.drop.on
          ? launch_width<true>(a, cluster_size, cluster_rows, d_head, st)
          : launch_width<false>(a, cluster_size, cluster_rows, d_head, st);
  if (err != cudaSuccess) return (int)err;
  const int hd = n_head * d_head;  // y [b*t, dm] = ctx [b*t, hd] W_out [hd, dm]
  return (int)gemm<T, T, T>({ctx, hd, false}, {w_out, dm, true}, y, dm,
                            b * t, dm, hd, true, partials, sms, st);
}

}  // namespace

// Floats of the `partials` buffer ptt_qkv_attention_fwd needs at this
// shape on a card of `sms` SMs (0: pass null).
extern "C" int64_t ptt_qkv_fwd_scratch(int b, int t, int dm, int n_head,
                                       int d_head, int sms) {
  return gemm_partials(b * t, dm, n_head * d_head, sms);
}

// The f32 cluster kernel of R rows at head width dh and its layout.
template <class F>
cudaError_t with_cluster(int r, int dh, F&& f) {
  if (r == 32 && dh == 64)
    return f(qkv_cluster_fwd_kernel<32, false, 64>, Cluster<32, 64>(),
             configure_cluster<32, false, 64>());
  if (r == 64 && dh == 64)
    return f(qkv_cluster_fwd_kernel<64, false, 64>, Cluster<64, 64>(),
             configure_cluster<64, false, 64>());
  if (r == 32 && dh == 128)
    return f(qkv_cluster_fwd_kernel<32, false, 128>, Cluster<32, 128>(),
             configure_cluster<32, false, 128>());
  if (r == 64 && dh == 128)
    return f(qkv_cluster_fwd_kernel<64, false, 128>, Cluster<64, 128>(),
             configure_cluster<64, false, 128>());
  return cudaErrorInvalidValue;
}

// How many clusters of `c` blocks of the f32 cluster kernel of R rows at
// head width dh (64 or 128) the card holds at once
// (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int ptt_qkv_cluster_occupancy(int r, int c, int dh) {
  if (c < 1 || c > kMaxCluster) return -(int)cudaErrorInvalidValue;
  int clusters = 0;
  const cudaError_t err =
      with_cluster(r, dh, [&](auto kernel, auto layout, cudaError_t conf) {
        if (conf != cudaSuccess) return conf;
        cudaLaunchAttribute attr[1];
        const cudaLaunchConfig_t cfg =
            cluster_config<decltype(layout)>(c, 1, 1, attr, 0);
        return cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      });
  return err != cudaSuccess ? -(int)err : clusters;
}

// Dynamic shared memory of a cluster-route block in bytes: R rows (32 or
// 64), f32 (qkv_cluster_fwd_kernel) or bf16 (qkv_cluster_tc_kernel) at
// head width dh 64 or 128; 0 for another R or width.
extern "C" int64_t ptt_qkv_cluster_smem(int r, int bf16_tc, int dh) {
  if (r != 32 && r != 64) return 0;
  if (bf16_tc && dh == 64)
    return (int64_t)(r == 32 ? ClusterTc<32, 64>::kBytes
                             : ClusterTc<64, 64>::kBytes);
  if (bf16_tc && dh == 128)
    return (int64_t)(r == 32 ? ClusterTc<32, 128>::kBytes
                             : ClusterTc<64, 128>::kBytes);
  if (bf16_tc) return 0;
  if (dh == 64)
    return (int64_t)(r == 32 ? Cluster<32, 64>::kBytes
                             : Cluster<64, 64>::kBytes);
  if (dh == 128)
    return (int64_t)(r == 32 ? Cluster<32, 128>::kBytes
                             : Cluster<64, 128>::kBytes);
  return 0;
}

// bias may be null; otherwise its element (b, h, q, k) lies at
// b*bs_b + h*bs_h + q*bs_q + k*bs_k.  Writes ctx [b, t, h, d_head], lse
// [b, h, t] and y [b, t, dm]; partials holds ptt_qkv_fwd_scratch floats.
// The route is the caller's plan (`qkv_fwd_plan`): cluster_rows R (32 or
// 64) runs the cluster kernel in clusters of C = ceil(t / R) blocks,
// which must be <= 8; R == 0 runs the tiles kernel; anything else returns
// cudaErrorInvalidValue.  sms is the card's SM count (y's split-K).
// Requires d_head 64 or 128 and dm % 32 == 0 (checked by the caller).
// rate 0 runs without dropout; otherwise weights are kept where the hash
// of (seed, b*n_head + head, q*t + k) >= threshold (t*t <= 2^32, checked
// by the caller).
extern "C" int ptt_qkv_attention_fwd(const float* x, const float* w_qkv,
                                     const float* w_out, const float* bias,
                                     int64_t bs_b, int64_t bs_h,
                                     int64_t bs_q, int64_t bs_k, float* y,
                                     float* ctx, float* lse, float* partials,
                                     int b, int t, int dm, int n_head,
                                     int d_head, int cluster_rows, int sms,
                                     float scale, int causal, double rate,
                                     unsigned seed, unsigned threshold,
                                     void* stream) {
  return qkv_attention_fwd(x, w_qkv, w_out, bias, bs_b, bs_h, bs_q, bs_k, y,
                           ctx, lse, partials, b, t, dm, n_head, d_head,
                           cluster_rows, sms, scale, causal, rate, seed,
                           threshold, stream);
}

// #1 in bf16 (amp): as ptt_qkv_attention_fwd with x, the weights, the
// bias, y and ctx bf16; lse and partials f32; d_head 64 or 128.
extern "C" int ptt_qkv_attention_fwd_bf16(
    const bf16* x, const bf16* w_qkv, const bf16* w_out, const bf16* bias,
    int64_t bs_b, int64_t bs_h, int64_t bs_q, int64_t bs_k, bf16* y,
    bf16* ctx, float* lse, float* partials, int b, int t, int dm,
    int n_head, int d_head, int cluster_rows, int sms, float scale,
    int causal, double rate, unsigned seed, unsigned threshold,
    void* stream) {
  return qkv_attention_fwd(x, w_qkv, w_out, bias, bs_b, bs_h, bs_q, bs_k, y,
                           ctx, lse, partials, b, t, dm, n_head, d_head,
                           cluster_rows, sms, scale, causal, rate, seed,
                           threshold, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
