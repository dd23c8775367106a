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
// bf16 (amp, ptt_qkv_attention_fwd_bf16; both routes): x, w_qkv, w_out
// and the bias are bf16, converted to f32 as they are loaded; q, k, v, p
// and every accumulator are f32, as the reference's kernel computes them.
// ctx is rounded to bf16 when it is stored, and the y GEMM reads that
// bf16 ctx (the reference rounds each head's context to y's dtype before
// its output product); y and ctx are bf16, lse f32.
//
// The context ctx [b, t, h, 64] and lse [b, h, t] (+inf on a masked row)
// are the residuals the backward kernels (#2, #3 in qkv_attention_bwd.cu)
// read, as the TPU kernel always returns them; serving passes scratch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"
#include "gemm.cuh"
#include "hash_rng.cuh"

namespace {

namespace cg = cooperative_groups;
using hash_rng::Dropout;

// ---------------------------------------------------------------------------
// tiles route (t > 512)
// ---------------------------------------------------------------------------

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // key rows per walk step
constexpr int DH = 64;       // head width (both routes)
constexpr int KC = 32;       // reduction chunk of the projections
constexpr int NT = 256;      // threads per block
constexpr int AS = KC + 1;   // row stride of the activation tile
constexpr int QS = DH + 1;   // row stride of q / p tiles
constexpr int TS = DH + 4;   // row stride of k^T / v tiles (float4 rows)
constexpr float kMaskValue = -1e30f;

// shared-memory layout, in floats
constexpr int kAOff = 0;                       // x tile      [BQ][AS]
constexpr int kBOff = kAOff + BQ * AS;         // two w tiles [2][KC][DH]
constexpr int kQOff = kBOff + 2 * KC * DH;     // q           [BQ][QS]
constexpr int kKOff = kQOff + BQ * QS;         // k^T         [DH][TS]
constexpr int kVOff = kKOff + DH * TS;         // v           [BK][TS]
constexpr int kPOff = kVOff + BK * TS;         // p           [BQ][QS]
constexpr int kSmemFloats = kPOff + BQ * QS;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

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

// Load the weight tile w[k0..k0+KC, col0..col0+DH) with row stride ldw.
template <class T>
__device__ __forceinline__ void load_w_tile(float* b_s, const T* w,
                                            int ldw, int k0, int col0) {
  for (int idx = threadIdx.x; idx < KC * (DH / 4); idx += NT) {
    int row = idx / (DH / 4);
    int c4 = idx % (DH / 4);
    *reinterpret_cast<float4*>(b_s + row * DH + c4 * 4) =
        load4(w + (size_t)(k0 + row) * ldw + col0 + c4 * 4);
  }
}

template <bool DROP, class T = float>
__global__ void __launch_bounds__(NT)
qkv_tiles_fwd_kernel(const T* __restrict__ x,
                         const T* __restrict__ w_qkv,
                         const T* __restrict__ bias,
                         int64_t bs_b, int64_t bs_h, int64_t bs_q,
                         int64_t bs_k, T* ctx, float* lse,
                         int t, int dm, int n_head, float scale,
                         int causal, Dropout drop) {
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
  const T* xb = x + (size_t)bi * t * dm;
  const uint32_t hseed =
      DROP ? hash_rng::attn_head_seed(drop.seed, (uint32_t)(bi * n_head + head))
           : 0u;

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
  const T* bias_row = bias ? bias + bi * bs_b + head * bs_h : nullptr;

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
      for (int j = 0; j < 4; ++j) {
        o[i][j] *= alpha;
        float pv = s[i][j];
        if (DROP && !hash_rng::keep_attn(
                hseed, (uint32_t)qpos * t + k0r + tx * 4 + j,
                drop.threshold))
          pv = 0.f;
        p_s[(ty * 4 + i) * QS + tx * 4 + j] = pv;
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

  // ---- context (masked rows give 0) and lse ---------------------------
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool masked = (l[i] == 0.f) || (m[i] <= -1e29f);
    const float inv = masked ? 0.f
                             : (DROP ? drop.inv_keep / l[i] : 1.f / l[i]);
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= t) continue;
    store4(ctx + ((size_t)bi * t + qpos) * hd + head * DH + tx * 4,
           make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv,
                       o[i][3] * inv));
    if (tx == 0)
      lse[((size_t)bi * n_head + head) * t + qpos] =
          masked ? INFINITY : m[i] + logf(l[i]);
  }
}


// ---------------------------------------------------------------------------
// cluster route (t <= 512)
// ---------------------------------------------------------------------------

constexpr int kMaxCluster = 8;  // the portable cluster size

// Shared-memory layout of qkv_cluster_fwd_kernel<R>, in floats.  Each of
// the NT = 128 threads owns TR = R / 8 consecutive rows (ty * TR.., ty =
// tid / 16) of its block's R rows and columns 4tx..4tx+3 (tx = tid % 16)
// of a 64-wide tile.  Row-minor tiles (q^T, k^T, p^T, x^T) put a thread's
// rows in TR / 4 float4s.  At R = 64 the layout takes 102 KB, so two
// blocks share an SM and one block's barriers and waits overlap the
// other's arithmetic.
template <int R>
struct Cluster {
  static constexpr int TR = R / 8;         // rows a thread owns
  static constexpr int NT = 16 * (R / TR); // threads per block
  static constexpr int CK = 16;            // reduction chunk of the projection
  static constexpr int KW = R / 16;        // key columns of a thread's s
  static constexpr int RS = R + 4;         // row stride of row-minor tiles
  static constexpr int VS = DH + 4;        // row stride of v
  static constexpr int WS = 3 * DH + 4;    // row stride of a W tile (q|k|v)
  // kept from the projection to the end: this block's k^T and v, which
  // its peers read, and its q^T
  static constexpr int kK = 0;                       // k^T [DH][RS]
  static constexpr int kV = kK + DH * RS;            // v   [R][VS]
  static constexpr int kQ = kV + R * VS;             // q^T [DH][RS]
  static constexpr int kStage = kQ + DH * RS;
  // the staging area: three projection chunks (x^T [CK][RS], W
  // [CK][WS]); then, once projected, a peer's tiles (k^T and v as laid
  // out above) and the walk's probability tile p^T [R][RS]
  static constexpr int kChunk = CK * RS + CK * WS;
  static constexpr int kPeer = DH * RS + R * VS;
  static constexpr int kP = kPeer;
  static constexpr int kStageFloats =
      3 * kChunk > kPeer + R * RS ? 3 * kChunk : kPeer + R * RS;
  static constexpr size_t kBytes = (kStage + kStageFloats) * sizeof(float);
  // float4s of one chunk of x a thread loads
  static constexpr int kXLoads = R * CK / 4 / NT;
  // float4s of one peer tile a thread copies: its k^T, then its v
  static constexpr int kCopyK = DH * R / 4 / NT;
  static constexpr int kCopy = 2 * kCopyK;
};

// cp_async16 and cp_async_commit are gemm.cuh's.

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Load this thread's float4s of x[r0.., k0..k0 + CK) (zeros past t) into
// registers: consecutive threads read consecutive float4s of a row.
template <int R, class T>
__device__ __forceinline__ void load_x(float4 (&xr)[Cluster<R>::kXLoads],
                                       const T* xb, int r0, int t,
                                       int dm, int k0) {
  using L = Cluster<R>;
#pragma unroll
  for (int u = 0; u < L::kXLoads; ++u) {
    const int idx = threadIdx.x + u * L::NT;
    const int row = idx / (L::CK / 4);
    const int c4 = idx % (L::CK / 4);
    xr[u] = r0 + row < t ? load4(xb + (size_t)(r0 + row) * dm + k0 + c4 * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Store them transposed into a chunk's x^T [CK][RS].
template <int R>
__device__ __forceinline__ void store_x(
    float* xt, const float4 (&xr)[Cluster<R>::kXLoads]) {
  using L = Cluster<R>;
#pragma unroll
  for (int u = 0; u < L::kXLoads; ++u) {
    const int idx = threadIdx.x + u * L::NT;
    float* dst = xt + (idx % (L::CK / 4)) * 4 * L::RS + idx / (L::CK / 4);
    dst[0] = xr[u].x;
    dst[L::RS] = xr[u].y;
    dst[2 * L::RS] = xr[u].z;
    dst[3 * L::RS] = xr[u].w;
  }
}

// Start copying rows [k0, k0 + CK) of the head's three W slabs into a
// chunk's W [CK][WS]: f32 by cp.async; bf16 loaded and stored as f32 now
// (the chunk's barriers order both before the chunk is read).
template <int R, class T>
__device__ __forceinline__ void stage_w(float* ws, const T* w_qkv,
                                        int ldw, int hd, int head, int k0) {
  using L = Cluster<R>;
  for (int idx = threadIdx.x; idx < L::CK * 3 * (DH / 4); idx += L::NT) {
    const int kk = idx / (3 * (DH / 4));
    const int c4 = idx % (3 * (DH / 4));
    const int slab = c4 / (DH / 4);
    const int col = (c4 % (DH / 4)) * 4;
    const T* src =
        w_qkv + (size_t)(k0 + kk) * ldw + slab * hd + head * DH + col;
    if constexpr (sizeof(T) == 4)
      cp_async16(ws + kk * L::WS + slab * DH + col, src);
    else
      *reinterpret_cast<float4*>(ws + kk * L::WS + slab * DH + col) =
          load4(src);
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
template <int R>
__device__ __forceinline__ void load_peer(float4 (&reg)[Cluster<R>::kCopy],
                                          cg::cluster_group& cluster,
                                          float* smem, int rank) {
  using L = Cluster<R>;
  const float* kt = cluster.map_shared_rank(smem + L::kK, rank);
  const float* v = cluster.map_shared_rank(smem + L::kV, rank);
#pragma unroll
  for (int c = 0; c < L::kCopyK; ++c) {
    const int idx = threadIdx.x + c * L::NT;
    reg[c] = *reinterpret_cast<const float4*>(
        kt + (idx / (R / 4)) * L::RS + (idx % (R / 4)) * 4);
    reg[L::kCopyK + c] = *reinterpret_cast<const float4*>(
        v + (idx / (DH / 4)) * L::VS + (idx % (DH / 4)) * 4);
  }
}

// Store loaded peer tiles into `buf` in the same layout.
template <int R>
__device__ __forceinline__ void store_peer(
    float* buf, const float4 (&reg)[Cluster<R>::kCopy]) {
  using L = Cluster<R>;
#pragma unroll
  for (int c = 0; c < L::kCopyK; ++c) {
    const int idx = threadIdx.x + c * L::NT;
    *reinterpret_cast<float4*>(buf + (idx / (R / 4)) * L::RS +
                               (idx % (R / 4)) * 4) = reg[c];
    *reinterpret_cast<float4*>(buf + DH * L::RS + (idx / (DH / 4)) * L::VS +
                               (idx % (DH / 4)) * 4) = reg[L::kCopyK + c];
  }
}

// Grid (C, n_head, b), cluster (C, 1, 1), C = ceil(t / R) <= 8.
template <int R, bool DROP, class T = float>
__global__ void __launch_bounds__(Cluster<R>::NT, 2)
qkv_cluster_fwd_kernel(const T* __restrict__ x,
                       const T* __restrict__ w_qkv,
                       const T* __restrict__ bias, int64_t bs_b,
                       int64_t bs_h, int64_t bs_q, int64_t bs_k, T* ctx,
                       float* lse, int t, int dm, int n_head, float scale,
                       int causal, Dropout drop) {
  using L = Cluster<R>;
  constexpr int TR = L::TR;
  constexpr int KW = L::KW;
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
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int hd = n_head * DH;
  const int r0 = rank * R;
  const int row0 = r0 + ty * TR;  // this thread's first row
  const T* xb = x + (size_t)bi * t * dm;

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
  load_x<R, T>(xr, xb, r0, t, dm, 0);
  stage_w<R, T>(stage + L::CK * L::RS, w_qkv, ldw, hd, head, 0);
  cp_async_commit();
  store_x<R>(stage, xr);
  if (n_chunk > 1) {
    load_x<R, T>(xr, xb, r0, t, dm, L::CK);
    stage_w<R, T>(stage + L::kChunk + L::CK * L::RS, w_qkv, ldw, hd, head,
               L::CK);
  }
  cp_async_commit();
  for (int c = 0; c < n_chunk; ++c) {
    cp_async_wait_all_but_last();  // W of chunk c has landed
    __syncthreads();  // ... for every thread, and chunk c - 1 is read
    if (c + 1 < n_chunk) store_x<R>(stage + (c + 1) % 3 * L::kChunk, xr);
    if (c + 2 < n_chunk) {
      float* next = stage + (c + 2) % 3 * L::kChunk;
      load_x<R, T>(xr, xb, r0, t, dm, (c + 2) * L::CK);
      stage_w<R, T>(next + L::CK * L::RS, w_qkv, ldw, hd, head,
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
      fma_outer(ak, a, *reinterpret_cast<const float4*>(w + DH));
      fma_outer(av, a, *reinterpret_cast<const float4*>(w + 2 * DH));
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
  const T* bias_row = bias ? bias + bi * bs_b + head * bs_h : nullptr;
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
  load_peer<R>(peer, cluster, smem, 0);
  store_peer<R>(stage, peer);
  __syncthreads();
  const float* kt_b = stage;
  const float* v_b = stage + DH * L::RS;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0r = kt * R;
    if (kt + 1 < n_kv) load_peer<R>(peer, cluster, smem, kt + 1);
    // this patch's bias and masks, loaded before the products
    float sb[TR][KW];
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      const int qpos = row0 + i;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        const int kpos = k0r + tx * KW + j;
        const bool hidden = kpos >= t || (causal && kpos > qpos);
        sb[i][j] = hidden ? kMaskValue
                   : bias_row ? to_f32(bias_row[min(qpos, t - 1) * bs_q +
                                                kpos * bs_k])
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
    for (int d = 0; d < DH; ++d) {
      float qv[TR];
      load_row(qv, qt_s + d * L::RS + ty * TR);
      float kv[KW];
      if constexpr (KW == 4) {
        load_row(kv, kt_b + d * L::RS + tx * 4);
      } else {
        const float2 k2 =
            *reinterpret_cast<const float2*>(kt_b + d * L::RS + tx * 2);
        kv[0] = k2.x; kv[1] = k2.y;
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < KW; ++j) s[i][j] += qv[i] * kv[j];
    }
    // row max / sum across the 16 threads that share a row group
#pragma unroll
    for (int i = 0; i < TR; ++i) {
#pragma unroll
      for (int j = 0; j < KW; ++j)
        s[i][j] = sb[i][j] == kMaskValue ? kMaskValue : s[i][j] + sb[i][j];
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < KW; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
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
      for (int off = 8; off > 0; off >>= 1)
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
      store_peer<R>(stage, peer);
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
    store4(ctx + ((size_t)bi * t + qpos) * hd + head * DH + tx * 4,
           make_float4(o[i][0] * inv, o[i][1] * inv, o[i][2] * inv,
                       o[i][3] * inv));
    if (tx == 0)
      lse[((size_t)bi * n_head + head) * t + qpos] =
          masked ? INFINITY : m[i] + logf(l[i]);
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

template <bool DROP, class T>
cudaError_t launch_tiles(const FwdArgs<T>& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        qkv_tiles_fwd_kernel<DROP, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.t + BQ - 1) / BQ, a.n_head, a.b);
  qkv_tiles_fwd_kernel<DROP, T><<<grid, NT, kSmemBytes, stream>>>(
      a.x, a.w_qkv, a.bias, a.bs_b, a.bs_h, a.bs_q, a.bs_k, a.ctx, a.lse,
      a.t, a.dm, a.n_head, a.scale, a.causal, a.drop);
  return cudaGetLastError();
}

// Launch configuration of the cluster kernel: grid (C, n_head, b), one
// cluster of C blocks along x.  `attr` must outlive the returned config.
template <int R>
cudaLaunchConfig_t cluster_config(int c, int n_head, int b,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, n_head, b);
  cfg.blockDim = dim3(Cluster<R>::NT);
  cfg.dynamicSmemBytes = Cluster<R>::kBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int R, bool DROP, class T = float>
cudaError_t configure_cluster() {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        qkv_cluster_fwd_kernel<R, DROP, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cluster<R>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  return cudaSuccess;
}

template <int R, bool DROP, class T>
cudaError_t launch_cluster(const FwdArgs<T>& a, int c, cudaStream_t stream) {
  cudaError_t err = configure_cluster<R, DROP, T>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config<R>(c, a.n_head, a.b, attr, stream);
  err = cudaLaunchKernelEx(&cfg, qkv_cluster_fwd_kernel<R, DROP, T>, a.x,
                           a.w_qkv, a.bias, a.bs_b, a.bs_h, a.bs_q, a.bs_k,
                           a.ctx, a.lse, a.t, a.dm, a.n_head, a.scale,
                           a.causal, a.drop);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool DROP, class T>
cudaError_t launch_attention(const FwdArgs<T>& a, int c, int r,
                             cudaStream_t stream) {
  if (r == 0) return launch_tiles<DROP>(a, stream);
  return r == 32 ? launch_cluster<32, DROP>(a, c, stream)
                 : launch_cluster<64, DROP>(a, c, stream);
}

// #1 on tensors of T: ptt_qkv_attention_fwd's arguments.
template <class T>
int qkv_attention_fwd(const T* x, const T* w_qkv, const T* w_out,
                      const T* bias, int64_t bs_b, int64_t bs_h,
                      int64_t bs_q, int64_t bs_k, T* y, T* ctx, float* lse,
                      float* partials, int b, int t, int dm, int n_head,
                      int cluster_rows, int sms, float scale, int causal,
                      double rate, unsigned seed, unsigned threshold,
                      void* stream) {
  const int cluster_size =
      cluster_rows > 0 ? (t + cluster_rows - 1) / cluster_rows : 0;
  if (cluster_rows != 0 &&
      !((cluster_rows == 32 || cluster_rows == 64) &&
        cluster_size <= kMaxCluster))
    return (int)cudaErrorInvalidValue;
  const FwdArgs<T> a{x, w_qkv, bias, bs_b, bs_h, bs_q, bs_k, ctx, lse, b, t,
                     dm, n_head, scale, causal,
                     hash_rng::make_dropout(rate, seed, threshold)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      a.drop.on ? launch_attention<true>(a, cluster_size, cluster_rows, st)
                : launch_attention<false>(a, cluster_size, cluster_rows, st);
  if (err != cudaSuccess) return (int)err;
  const int hd = n_head * DH;  // y [b*t, dm] = ctx [b*t, hd] W_out [hd, dm]
  return (int)gemm<T, T, T>({ctx, hd, false}, {w_out, dm, true}, y, dm,
                            b * t, dm, hd, true, partials, sms, st);
}

}  // namespace

// Floats of the `partials` buffer ptt_qkv_attention_fwd needs at this
// shape on a card of `sms` SMs (0: pass null).
extern "C" int64_t ptt_qkv_fwd_scratch(int b, int t, int dm, int n_head,
                                       int sms) {
  return gemm_partials(b * t, dm, n_head * DH, sms);
}

// How many clusters of `c` blocks of the R-row cluster kernel the card
// holds at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error.
extern "C" int ptt_qkv_cluster_occupancy(int r, int c) {
  if ((r != 32 && r != 64) || c < 1 || c > kMaxCluster)
    return -(int)cudaErrorInvalidValue;
  cudaError_t err = r == 32 ? configure_cluster<32, false>()
                            : configure_cluster<64, false>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr[1];
  int clusters = 0;
  if (r == 32) {
    const cudaLaunchConfig_t cfg = cluster_config<32>(c, 1, 1, attr, 0);
    err = cudaOccupancyMaxActiveClusters(
        &clusters, qkv_cluster_fwd_kernel<32, false>, &cfg);
  } else {
    const cudaLaunchConfig_t cfg = cluster_config<64>(c, 1, 1, attr, 0);
    err = cudaOccupancyMaxActiveClusters(
        &clusters, qkv_cluster_fwd_kernel<64, false>, &cfg);
  }
  return err != cudaSuccess ? -(int)err : clusters;
}

// bias may be null; otherwise its element (b, h, q, k) lies at
// b*bs_b + h*bs_h + q*bs_q + k*bs_k.  Writes ctx [b, t, h, 64], lse
// [b, h, t] and y [b, t, dm]; partials holds ptt_qkv_fwd_scratch floats.
// The route is the caller's plan (`qkv_fwd_plan`): cluster_rows R (32 or
// 64) runs the cluster kernel in clusters of C = ceil(t / R) blocks,
// which must be <= 8; R == 0 runs the tiles kernel; anything else returns
// cudaErrorInvalidValue.  sms is the card's SM count (y's split-K).
// Requires d_head == 64 and dm % 32 == 0 (checked by the caller).  rate 0
// runs without dropout; otherwise weights are kept where the hash of
// (seed, b*n_head + head, q*t + k) >= threshold (t*t <= 2^32, checked by
// the caller).
extern "C" int ptt_qkv_attention_fwd(const float* x, const float* w_qkv,
                                     const float* w_out, const float* bias,
                                     int64_t bs_b, int64_t bs_h,
                                     int64_t bs_q, int64_t bs_k, float* y,
                                     float* ctx, float* lse, float* partials,
                                     int b, int t, int dm, int n_head,
                                     int cluster_rows, int sms,
                                     float scale, int causal, double rate,
                                     unsigned seed, unsigned threshold,
                                     void* stream) {
  return qkv_attention_fwd(x, w_qkv, w_out, bias, bs_b, bs_h, bs_q, bs_k, y,
                           ctx, lse, partials, b, t, dm, n_head,
                           cluster_rows, sms, scale, causal, rate, seed,
                           threshold, stream);
}

// #1 in bf16 (amp): as ptt_qkv_attention_fwd with x, the weights, the
// bias, y and ctx bf16; lse and partials f32.
extern "C" int ptt_qkv_attention_fwd_bf16(
    const bf16* x, const bf16* w_qkv, const bf16* w_out, const bf16* bias,
    int64_t bs_b, int64_t bs_h, int64_t bs_q, int64_t bs_k, bf16* y,
    bf16* ctx, float* lse, float* partials, int b, int t, int dm,
    int n_head, int cluster_rows, int sms, float scale, int causal,
    double rate, unsigned seed, unsigned threshold, void* stream) {
  return qkv_attention_fwd(x, w_qkv, w_out, bias, bs_b, bs_h, bs_q, bs_k, y,
                           ctx, lse, partials, b, t, dm, n_head,
                           cluster_rows, sms, scale, causal, rate, seed,
                           threshold, stream);
}

extern "C" const char* ptt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
