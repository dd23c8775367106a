// Flash-attention tiles and the two backward walks, f32, for sm_90a.
//
// Shared by the bthd kernels (flash_attention.cu: the forward #4 and the
// backward #6, #7) and the fused-projection backward (qkv_attention_bwd.cu:
// #2 and #3 walk the rows their projection GEMM wrote).  Rows are
// addressed through a row stride, so one walk reads q, k, v from [b, t, h,
// 64] tensors (stride h * 64) or from the q|k|v columns of a [b * t, 3hd]
// projection (stride 3hd):
//
//   dq    dq = sum_k p (dp - delta) * scale * k,  p = exp(s - lse)
//         recomputed from lse, dp = dO v^T, delta = rowsum(dO * o)
//   dkv   dv = sum_q p^T dO,  dk = sum_q (p (dp - delta) * scale)^T q
//
// Weights dropout (the DROP instantiations): with keep the forward's mask
// (hash_rng::keep_attn of the block's head seed at q * tk + k), dp becomes
// keep ? dp * inv_keep : 0 in both walks, and dv sums (keep ? p * inv_keep
// : 0)^T dO, while ds keeps the undropped p; delta is then rowsum(dO * o)
// of the dropped output.  At rate 0 the callers launch the instantiation
// without the hash.
//
// Grid: dq takes one block per (64-row q tile, head, batch row) and walks
// the k tiles; dkv one block per (64-row k tile, head, batch row) and walks
// the q tiles.  Every output element belongs to one block, which sums in a
// fixed order: no atomics, and the results are the same from run to run.
//
// 256 threads; in every 64x64x64 tile product each thread owns a 4x4 patch
// (rows 4*ty.., cols 4*tx..), reads its A rows from a tile of row stride
// 65 (one address per half warp) and its B columns as float4 from a tile
// of row stride 68.
//
// Bound: f32 FMA work on the CUDA cores (TF32 off): 6 and 8 * b*h*tq*tk*64
// FLOPs for dq and dkv against 67 TFLOP/s.  Each step stages its tiles in
// shared memory once per block and does 16 FMAs per pair of operands a
// thread loads.  No tensor cores, no load pipelining: later work.
//
// Masking: causal keys (bottom-right aligned, offset tk - tq) and keys past
// tk give p = 0; a row masked in the forward has lse = +inf, so p = 0 and
// its gradients are zero.  Rows past t in a ragged tile load as zeros.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hash_rng.cuh"

namespace {

using hash_rng::Dropout;

constexpr int BT = 64;      // rows of a q or k tile
constexpr int DH = 64;      // head width
constexpr int NT = 256;     // threads per block
constexpr int AS = BT + 1;  // row stride of A-operand tiles
constexpr int BS = BT + 4;  // row stride of B-operand tiles (float4 rows)

constexpr int kATile = BT * AS;  // floats
constexpr int kBTile = BT * BS;
constexpr size_t kDqSmem = (3 * kATile + 3 * kBTile) * sizeof(float);
constexpr size_t kDkvSmem = (4 * kATile + 4 * kBTile + 2 * BT) *
                            sizeof(float);

// Additive bias broadcast to [b, h, tq, tk] through its four strides (a
// broadcast dim has stride 0); p == nullptr means no bias.
struct Bias {
  const float* p;
  int64_t sb, sh, sq, sk;
  __device__ __forceinline__ float at(int bi, int h, int q, int k) const {
    return p[bi * sb + h * sh + q * sq + k * sk];
  }
};

// Rows of a [b * t, ld] matrix: head `head` of row r of batch row bi
// starts at p + (bi * t + r) * ld + head * 64.
struct Rows {
  const float* p;
  int ld;
  __device__ __forceinline__ const float* at(int bi, int t, int r,
                                             int head) const {
    return p + ((size_t)bi * t + r) * ld + head * DH;
  }
};

// dst[row * lds + col] = mul * row r0 + row of head `head` (0 past t).
__device__ __forceinline__ void load_rows(float* dst, int lds, Rows src,
                                          int bi, int r0, int t, int head,
                                          float mul = 1.f) {
  for (int idx = threadIdx.x; idx < BT * (DH / 4); idx += NT) {
    const int row = idx / (DH / 4);
    const int c4 = idx % (DH / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < t)
      v = *reinterpret_cast<const float4*>(src.at(bi, t, r0 + row, head) +
                                           c4 * 4);
    float* d = dst + row * lds + c4 * 4;
    d[0] = v.x * mul; d[1] = v.y * mul; d[2] = v.z * mul; d[3] = v.w * mul;
  }
}

// The same rows transposed: dst[col * BS + row].  Consecutive threads take
// consecutive rows, so the shared-memory writes do not conflict.
__device__ __forceinline__ void load_rows_t(float* dst, Rows src, int bi,
                                            int r0, int t, int head) {
  for (int idx = threadIdx.x; idx < BT * (DH / 4); idx += NT) {
    const int row = idx % BT;
    const int c4 = idx / BT;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < t)
      v = *reinterpret_cast<const float4*>(src.at(bi, t, r0 + row, head) +
                                           c4 * 4);
    float* d = dst + c4 * 4 * BS + row;
    d[0] = v.x; d[BS] = v.y; d[2 * BS] = v.z; d[3 * BS] = v.w;
  }
}

__device__ __forceinline__ void zero(float c[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
}

// c[i][j] += sum_kk A[(4ty + i) * AS + kk] * B[kk * BS + 4tx + j].
__device__ __forceinline__ void tile_mma(const float* A, const float* B,
                                         float c[4][4]) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll 8
  for (int kk = 0; kk < BT; ++kk) {
    const float4 bv = *reinterpret_cast<const float4*>(B + kk * BS + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av = A[(ty * 4 + i) * AS + kk];
      c[i][0] += av * bv.x; c[i][1] += av * bv.y;
      c[i][2] += av * bv.z; c[i][3] += av * bv.w;
    }
  }
}

// Store a thread's 4x4 patch of a [BT, DH] tile into rows r0 + 4ty + i
// (below t) of head `head` of a [b * t, ld] matrix.
__device__ __forceinline__ void store_rows(float* dst, int ld,
                                           const float c[4][4], int bi,
                                           int r0, int t, int head) {
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r < t)
      *reinterpret_cast<float4*>(dst + ((size_t)bi * t + r) * ld +
                                 head * DH + tx * 4) =
          make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
  }
}

// k tiles a q tile starting at q0 walks: all, or under the causal mask
// only those with a key at or before the tile's last query + offset.
__device__ __forceinline__ int kv_tiles(int q0, int tq, int tk, int causal) {
  int n = (tk + BT - 1) / BT;
  if (causal) {
    const int hi = min(q0 + BT, tq) - 1 + (tk - tq);
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

// dq of one (64-row q tile, head, batch row); lse and delta [b, h, tq].
template <bool DROP>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(Rows q, Rows k, Rows v, Bias bias, Rows dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* dq, int ld_dq,
                    int tq, int tk, int h, float scale, int causal,
                    Dropout drop) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [BT][AS] q
  float* do_s = q_s + kATile;     // [BT][AS] dO
  float* ds_s = do_s + kATile;    // [BT][AS] ds of one k tile
  float* kt_s = ds_s + kATile;    // [DH][BS] k^T
  float* vt_s = kt_s + kBTile;    // [DH][BS] v^T
  float* k_s = vt_s + kBTile;     // [BT][BS] k

  const int q0 = blockIdx.x * BT;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const int offset = tk - tq;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);

  load_rows(q_s, AS, q, bi, q0, tq, head);
  load_rows(do_s, AS, dout, bi, q0, tq, head);
  float lse_r[4], delta_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    const size_t at = ((size_t)bi * h + head) * tq + qpos;
    lse_r[i] = qpos < tq ? lse[at] : INFINITY;
    delta_r[i] = qpos < tq ? delta[at] : 0.f;
  }
  float acc[4][4];
  zero(acc);

  const int n_kv = kv_tiles(q0, tq, tk, causal);
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the last tile's operands and ds_s are consumed
    load_rows_t(kt_s, k, bi, k0, tk, head);
    load_rows_t(vt_s, v, bi, k0, tk, head);
    load_rows(k_s, BS, k, bi, k0, tk, head);
    __syncthreads();
    float s[4][4], dp[4][4];
    zero(s);
    zero(dp);
    tile_mma(q_s, kt_s, s);
    tile_mma(do_s, vt_s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        float p = 0.f;
        if (qpos < tq && kpos < tk && !(causal && qpos + offset < kpos)) {
          float sv = s[i][j] * scale;
          if (bias.p) sv += bias.at(bi, head, qpos, kpos);
          p = expf(sv - lse_r[i]);
        }
        float dpv = dp[i][j];
        if (DROP)
          dpv = hash_rng::keep_attn(hseed, (uint32_t)qpos * tk + kpos,
                                    drop.threshold)
                    ? dpv * drop.inv_keep : 0.f;
        ds_s[(ty * 4 + i) * AS + tx * 4 + j] =
            p * (dpv - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    tile_mma(ds_s, k_s, acc);
  }
  store_rows(dq, ld_dq, acc, bi, q0, tq, head);
}

// dk and dv of one (64-row k tile, head, batch row), each a [b * tk, ld]
// matrix.
template <bool DROP>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(Rows q, Rows k, Rows v, Bias bias, Rows dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* dk, float* dv,
                     int ld_dkv, int tq, int tk, int h, float scale,
                     int causal, Dropout drop) {
  extern __shared__ float smem[];
  float* k_s = smem;               // [BT][AS] k
  float* v_s = k_s + kATile;       // [BT][AS] v
  float* pt_s = v_s + kATile;      // [BT][AS] p^T of one q tile
  float* dst_s = pt_s + kATile;    // [BT][AS] ds^T of one q tile
  float* qt_s = dst_s + kATile;    // [DH][BS] q^T
  float* dot_s = qt_s + kBTile;    // [DH][BS] dO^T
  float* q_s = dot_s + kBTile;     // [BT][BS] q
  float* do_s = q_s + kBTile;      // [BT][BS] dO
  float* lse_s = do_s + kBTile;    // [BT]
  float* delta_s = lse_s + BT;     // [BT]

  const int k0 = blockIdx.x * BT;
  const int head = blockIdx.y;
  const int bi = blockIdx.z;
  const int ty = threadIdx.x / 16;  // key rows 4ty..
  const int tx = threadIdx.x % 16;  // query (or d) columns 4tx..
  const int offset = tk - tq;
  const uint32_t hseed = block_head_seed<DROP>(drop, bi, h, head);

  load_rows(k_s, AS, k, bi, k0, tk, head);
  load_rows(v_s, AS, v, bi, k0, tk, head);
  float dk_acc[4][4], dv_acc[4][4];
  zero(dk_acc);
  zero(dv_acc);

  const int n_q = (tq + BT - 1) / BT;
  // under the causal mask, q tiles wholly before this tile's first key
  // (shifted by the offset) see none of its keys
  const int lo = causal ? max(k0 - offset, 0) / BT : 0;
  for (int qt = lo; qt < n_q; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();  // the last tile's operands are consumed
    load_rows_t(qt_s, q, bi, q0, tq, head);
    load_rows_t(dot_s, dout, bi, q0, tq, head);
    load_rows(q_s, BS, q, bi, q0, tq, head);
    load_rows(do_s, BS, dout, bi, q0, tq, head);
    if (threadIdx.x < BT) {
      const int qpos = q0 + threadIdx.x;
      const size_t at = ((size_t)bi * h + head) * tq + qpos;
      lse_s[threadIdx.x] = qpos < tq ? lse[at] : INFINITY;
      delta_s[threadIdx.x] = qpos < tq ? delta[at] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    zero(st);
    zero(dpt);
    tile_mma(k_s, qt_s, st);
    tile_mma(v_s, dot_s, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx * 4 + j;
        const int qpos = q0 + qc;
        float p = 0.f;
        if (qpos < tq && kpos < tk && !(causal && qpos + offset < kpos)) {
          float sv = st[i][j] * scale;
          if (bias.p) sv += bias.at(bi, head, qpos, kpos);
          p = expf(sv - lse_s[qc]);
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
        pt_s[(ty * 4 + i) * AS + qc] = pv;
        dst_s[(ty * 4 + i) * AS + qc] = p * (dpv - delta_s[qc]) * scale;
      }
    }
    __syncthreads();
    tile_mma(pt_s, do_s, dv_acc);
    tile_mma(dst_s, q_s, dk_acc);
  }
  store_rows(dk, ld_dkv, dk_acc, bi, k0, tk, head);
  store_rows(dv, ld_dkv, dv_acc, bi, k0, tk, head);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <bool DROP>
cudaError_t launch_bwd_dq(Rows q, Rows k, Rows v, Bias bias, Rows dout,
                          const float* lse, const float* delta, float* dq,
                          int ld_dq, int b, int tq, int tk, int h,
                          float scale, int causal, Dropout drop,
                          cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<DROP>, kDqSmem,
                               configured);
  if (err != cudaSuccess) return err;
  dim3 grid((tq + BT - 1) / BT, h, b);
  flash_bwd_dq_kernel<DROP><<<grid, NT, kDqSmem, stream>>>(
      q, k, v, bias, dout, lse, delta, dq, ld_dq, tq, tk, h, scale, causal,
      drop);
  return cudaGetLastError();
}

// The dq walk over a grid of (q tiles, heads, batch rows): the hashing
// instantiation only when drop.on.
inline cudaError_t bwd_dq(Rows q, Rows k, Rows v, Bias bias, Rows dout,
                          const float* lse, const float* delta, float* dq,
                          int ld_dq, int b, int tq, int tk, int h,
                          float scale, int causal, Dropout drop,
                          cudaStream_t stream) {
  return drop.on
      ? launch_bwd_dq<true>(q, k, v, bias, dout, lse, delta, dq, ld_dq, b,
                            tq, tk, h, scale, causal, drop, stream)
      : launch_bwd_dq<false>(q, k, v, bias, dout, lse, delta, dq, ld_dq, b,
                             tq, tk, h, scale, causal, drop, stream);
}

template <bool DROP>
cudaError_t launch_bwd_dkv(Rows q, Rows k, Rows v, Bias bias, Rows dout,
                           const float* lse, const float* delta, float* dk,
                           float* dv, int ld_dkv, int b, int tq, int tk,
                           int h, float scale, int causal, Dropout drop,
                           cudaStream_t stream) {
  static bool configured = false;
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<DROP>, kDkvSmem,
                               configured);
  if (err != cudaSuccess) return err;
  dim3 grid((tk + BT - 1) / BT, h, b);
  flash_bwd_dkv_kernel<DROP><<<grid, NT, kDkvSmem, stream>>>(
      q, k, v, bias, dout, lse, delta, dk, dv, ld_dkv, tq, tk, h, scale,
      causal, drop);
  return cudaGetLastError();
}

// The dkv walk over a grid of (k tiles, heads, batch rows).
inline cudaError_t bwd_dkv(Rows q, Rows k, Rows v, Bias bias, Rows dout,
                           const float* lse, const float* delta, float* dk,
                           float* dv, int ld_dkv, int b, int tq, int tk,
                           int h, float scale, int causal, Dropout drop,
                           cudaStream_t stream) {
  return drop.on
      ? launch_bwd_dkv<true>(q, k, v, bias, dout, lse, delta, dk, dv, ld_dkv,
                             b, tq, tk, h, scale, causal, drop, stream)
      : launch_bwd_dkv<false>(q, k, v, bias, dout, lse, delta, dk, dv,
                              ld_dkv, b, tq, tk, h, scale, causal, drop,
                              stream);
}

}  // namespace
