// Batch-norm kernels of the fused conv + BN route, f32 and bf16 (amp), for
// sm_90a.
//
// Replaces the Pallas kernels of paddle_tpu/kernels/conv_bn.py, which
// ops/nn_ops.py conv2d_bn and the fused batch_norm compose:
//
//   #18  _channel_stats_kernel  s1[c] = sum_r y[r, c], s2[c] = sum_r y^2
//   #19  _dot_stats_kernel      y = x2 w2^T ([M, K] by [N, K]), and s1/s2
//                               of y's columns in the GEMM's epilogue
//   #20  _ssa_fwd_kernel        out = [relu](x * wv + bv [+ res])
//   #21  _ssa_bwd_kernel        g' = relu ? g * (out > 0) : g;
//                               dx = g' * wv, dres = g', and per channel
//                               sg = sum g', sgx = sum g' * x
//
// Every tensor is a contiguous NHWC activation viewed as [rows, C]
// (channels fastest), of one element type T: f32, or bf16 under amp.  The
// per-channel vectors wv and bv and every sum are f32.
//
// The walk (#18, #21, and #20 in bf16): a block of NT threads is TY
// thread rows by TX groups of L channels, L = 16 / sizeof(T) (4 f32, 8
// bf16), so a thread's channels are one 16-byte vector of a row; the
// block covers a chunk of rows and a tile of channel groups, and each
// thread walks the chunk's rows in rounds of U, every load of a round
// issued before its arithmetic.  Where C % L == 0 and the tensors are
// 16-byte aligned a group moves as one vector; at any other C (the stem's
// 3, a classifier's 1 or 2, ...) each lane is its own load, the lanes
// past C masked, with the vector form's order of summation.  The TPU
// kernel's lane fold for C < 128 is layout plumbing for the TPU's
// 128-lane tiles and has no counterpart here.  One text serves both types
// (Lanes<T>, Arith<T>).
//
// Reductions across blocks use no atomics.  Each block of #18 and #21
// sums its chunk per channel in a fixed order (per thread in increasing
// row, then over the block's thread rows in order) and writes one partial
// per (chunk, channel); each block of #19 writes one per (128-row tile,
// column).  reduce_partials then adds the partials of each channel in a
// fixed order.  A repeated call gives the same bits.
//
// f32: the walk takes 8 blocks of 256 threads an SM's worth of chunks on
// 132 SMs whatever the card, so the sums keep their bits from card to
// card; #20 keeps its flat float4 loop (on the walk it read 1.5-4% slower
// at ResNet-50's sites, 21% at C 6; PERF.md); x * wv and the adds round
// one at a time (__fmul_rn, __fadd_rn), as the plain PyTorch twin does.
// #19 runs csrc/gemm.cuh's 128x128 f32 tile (no tensor cores: TF32 is
// off, as in the reference's f32 step) and folds the column statistics
// into that tile's epilogue, so y is never read back for them; it is bound
// by its f32 FMAs at ResNet-50's 1x1 shapes (at K 64, 2MNK FLOPs take 0.40
// ms against 0.25 ms for the 4MN bytes of y at stage 1), and reaches 43
// TFLOP/s at K 512, 31 at K 64, where a block is 4 stages deep and its
// exposed first load and its epilogue hold it (persistent blocks and
// float4 stores of y cost the tile registers it does not have; PERF.md).
//
// bf16 (amp), the reference's arithmetic in x's dtype: wv and bv rounded
// to bf16 once a thread (round to nearest even), then x * wv, + bv, + r as
// packed mul.rn.bf16x2 / add.rn.bf16x2 (each the exact result rounded
// once, as PyTorch's bf16 ops and the reference's interpret mode round
// each op; no fma, which would round x * wv + bv once) and ReLU as
// max.NaN.bf16x2; #21's g' is g with the halves whose out is not > 0
// masked to +0, dx = g' * wv by mul.rn.bf16x2, dres = g', and the sums in
// f32 over the bf16 values widened.  The grid is one wave: 4 blocks an SM
// (__launch_bounds__ holds the registers to it) on the card's SMs, and the
// streamed bytes go by ld.global.cs / st.global.cs.  #19 runs gemm.cuh's
// tensor-core tile (gemm_tc_col_stats): exact bf16 products summed in f32,
// K unsplit, y rounded to bf16 and its column statistics taken from the
// rounded y, as the reference takes them from the stored y.
//
// Bounds: #18, #20 and #21 move each byte once and are bound by device
// memory (#21 reads g, x and out and writes dx and dres); #19 in bf16 by
// its bytes at ResNet-50's 1x1 sites (stage-1 conv3: 514 MB, 0.153 ms,
// against 0.105 ms of MMAs at the dense bf16 rate).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

#include "device.cuh"
#include "gemm.cuh"

namespace {

constexpr int NT = 256;
// f32: blocks a statistics pass aims for, 8 of 256 threads on each of 132
// SMs (fixed, so that the sums' order is the card's own on any card)
constexpr int kTargetBlocks = 132 * 8;
// bf16: blocks an SM of the one-wave grid
constexpr int kWaveBlocks = 4;

// The element types of the walks: L lanes a 16-byte vector, held as four
// 32-bit words of one (f32) or two (bf16, the lower lane in the low half)
// lanes; the least blocks an SM the kernels' registers must allow; and
// whether the streamed bytes bypass the caches' normal policy.
template <class T>
struct Lanes;
template <>
struct Lanes<float> {
  static constexpr int kN = 4;
  static constexpr int kMinBlocks = 1;
  static constexpr bool kStream = false;
};
template <>
struct Lanes<bf16> {
  static constexpr int kN = 8;
  static constexpr int kMinBlocks = kWaveBlocks;
  static constexpr bool kStream = true;
};

// A thread's 16-byte vector of one row: four words.
struct Vec {
  uint32_t w[4];
};

// Lane j of v as f32 (a bf16 lane widened exactly).
template <class T>
__device__ __forceinline__ float lane(const Vec& v, int j);
template <>
__device__ __forceinline__ float lane<float>(const Vec& v, int j) {
  return __uint_as_float(v.w[j]);
}
template <>
__device__ __forceinline__ float lane<bf16>(const Vec& v, int j) {
  const uint32_t w = v.w[j >> 1];
  return __uint_as_float(j & 1 ? w & 0xFFFF0000u : w << 16);
}

__device__ __forceinline__ uint32_t bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits_of(bf16 v) {
  return __bfloat16_as_ushort(v);
}
template <class T>
__device__ __forceinline__ T of_bits(uint32_t w);
template <>
__device__ __forceinline__ float of_bits<float>(uint32_t w) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ bf16 of_bits<bf16>(uint32_t w) {
  return __ushort_as_bfloat16(static_cast<unsigned short>(w));
}

// The word arithmetic of #21 (and of #20 in bf16), one rounding a step.
template <class T>
struct Arith;
template <>
struct Arith<float> {
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    return __float_as_uint(__fmul_rn(__uint_as_float(a), __uint_as_float(b)));
  }
  // g where out > 0, else +0
  static __device__ __forceinline__ uint32_t where_pos(uint32_t g,
                                                      uint32_t out) {
    return __uint_as_float(out) > 0.f ? g : 0u;
  }
};
template <>
struct Arith<bf16> {
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
    uint32_t c;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(c) : "r"(a), "r"(b));
    return c;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
    uint32_t c;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(c) : "r"(a), "r"(b));
    return c;
  }
  // max(a, +0) a half at a time, a NaN kept (torch.clamp_min's)
  static __device__ __forceinline__ uint32_t relu(uint32_t a) {
    uint32_t c;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(c) : "r"(a), "r"(0u));
    return c;
  }
  static __device__ __forceinline__ uint32_t where_pos(uint32_t g,
                                                      uint32_t out) {
    const float lo = __uint_as_float(out << 16);
    const float hi = __uint_as_float(out & 0xFFFF0000u);
    return g & ((lo > 0.f ? 0x0000FFFFu : 0u) |
                (hi > 0.f ? 0xFFFF0000u : 0u));
  }
};

// The walk over [rows, C]: a block of NT threads is ty_n thread rows by
// tx_n groups of L channels; it covers groups [blockIdx.x * tx_n, ..) and
// rows [blockIdx.y * chunk_rows, ..).
struct Walk {
  int tx_n, ty_n, col_tiles, chunks, chunk_rows;
};

// The walk of [rows, C] in groups of `lanes` channels over about `target`
// blocks.
Walk make_walk(int64_t rows, int c, int lanes = 4,
               int target = kTargetBlocks) {
  Walk w;
  const int groups = (c + lanes - 1) / lanes;
  w.tx_n = std::min(groups, 32);
  w.ty_n = NT / w.tx_n;
  w.col_tiles = (groups + w.tx_n - 1) / w.tx_n;
  const int64_t max_chunks = std::max<int64_t>(1, (rows + w.ty_n - 1) /
                                                      w.ty_n);
  const int64_t want = (target + w.col_tiles - 1) / w.col_tiles;
  w.chunks = (int)std::min<int64_t>(want, max_chunks);
  w.chunk_rows = (int)((rows + w.chunks - 1) / w.chunks);
  w.chunks = (int)((rows + w.chunk_rows - 1) / w.chunk_rows);
  return w;
}

// The bf16 walk: one wave of kWaveBlocks blocks an SM.
Walk make_walk_bf16(int64_t rows, int c) {
  return make_walk(rows, c, Lanes<bf16>::kN, sm_count() * kWaveBlocks);
}

// Sums of this thread's L channels (s1[0..L), s2[0..L)) over the block's
// thread rows, in order, into part[chunk * C + c] and part[(chunks +
// chunk) * C + c].  red holds 2 * NT * L floats.
template <int L>
__device__ __forceinline__ void block_partials(const float (&s1)[L],
                                               const float (&s2)[L],
                                               float* red, const Walk& w,
                                               int c, float* part) {
  const int tx = threadIdx.x % w.tx_n;
  const int ty = threadIdx.x / w.tx_n;
  const int width = L * w.tx_n;
  if (ty < w.ty_n) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      red[ty * width + L * tx + j] = s1[j];
      red[NT * L + ty * width + L * tx + j] = s2[j];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * width; t += NT) {
    const int stat = t / width;
    const int col = t % width;
    const int ch = blockIdx.x * width + col;
    if (ch >= c) continue;
    const float* r = red + stat * NT * L + col;
    float s = 0.f;
    for (int y = 0; y < w.ty_n; ++y) s += r[y * width];
    part[((size_t)stat * gridDim.y + blockIdx.y) * c + ch] = s;
  }
}

// Channels grp * L .. grp * L + L - 1 of row r of a [rows, C] tensor: one
// 16-byte vector under VEC (C % L == 0, 16-byte aligned), else one load a
// lane with the lanes past C read as 0.
template <class T, bool VEC>
__device__ __forceinline__ Vec load_vec(const T* __restrict__ a, int64_t r,
                                        int c, int grp) {
  constexpr int L = Lanes<T>::kN;
  constexpr int P = L / 4;  // lanes a word
  Vec v;
  if (VEC) {
    const uint4* p = reinterpret_cast<const uint4*>(a) + r * (c / L) + grp;
    const uint4 u = Lanes<T>::kStream ? __ldcs(p) : *p;
    v.w[0] = u.x;
    v.w[1] = u.y;
    v.w[2] = u.z;
    v.w[3] = u.w;
    return v;
  }
  const T* p = a + r * c + (int64_t)grp * L;
  const int n = c - grp * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int h = 0; h < P; ++h)
      if (i * P + h < n) word |= bits_of(p[i * P + h]) << (16 * h);
    v.w[i] = word;
  }
  return v;
}

// Stores channels grp * L .. of row r, as load_vec reads them.
template <class T, bool VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ a, int64_t r,
                                          int c, int grp, const Vec& v) {
  constexpr int L = Lanes<T>::kN;
  constexpr int P = L / 4;
  if (VEC) {
    uint4* p = reinterpret_cast<uint4*>(a) + r * (c / L) + grp;
    const uint4 u = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
    if (Lanes<T>::kStream)
      __stcs(p, u);
    else
      *p = u;
    return;
  }
  T* p = a + r * c + (int64_t)grp * L;
  const int n = c - grp * L;
#pragma unroll
  for (int j = 0; j < L; ++j)
    if (j < n) p[j] = of_bits<T>(v.w[j / P] >> (16 * (j % P)));
}

// This thread's channels of the f32 [C] vector v as T (0 past C; a bf16
// lane rounded to nearest even).
template <class T>
__device__ __forceinline__ Vec channel_vec(const float* __restrict__ v,
                                           int c, int grp);
template <>
__device__ __forceinline__ Vec channel_vec<float>(const float* __restrict__ v,
                                                  int c, int grp) {
  Vec out;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out.w[j] = __float_as_uint(4 * grp + j < c ? v[4 * grp + j] : 0.f);
  return out;
}
template <>
__device__ __forceinline__ Vec channel_vec<bf16>(const float* __restrict__ v,
                                                 int c, int grp) {
  Vec out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ch = 8 * grp + 2 * i;
    const __nv_bfloat162 h = __floats2bfloat162_rn(
        ch < c ? v[ch] : 0.f, ch + 1 < c ? v[ch + 1] : 0.f);
    out.w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return out;
}

// #18.  One read of y [rows, C].
template <class T, bool VEC>
__global__ void __launch_bounds__(NT, Lanes<T>::kMinBlocks)
channel_stats_kernel(const T* __restrict__ y, int64_t rows, int c, Walk w,
                     float* __restrict__ part) {
  constexpr int L = Lanes<T>::kN;
  constexpr int U = 4;  // rows a round
  __shared__ float red[2 * NT * L];
  const int tx = threadIdx.x % w.tx_n;
  const int ty = threadIdx.x / w.tx_n;
  const int grp = blockIdx.x * w.tx_n + tx;
  float s1[L], s2[L];
#pragma unroll
  for (int j = 0; j < L; ++j) s1[j] = s2[j] = 0.f;
  if (ty < w.ty_n && grp * L < c) {
    const int64_t r0 = (int64_t)blockIdx.y * w.chunk_rows;
    const int64_t r1 = r0 + w.chunk_rows < rows ? r0 + w.chunk_rows : rows;
    for (int64_t r = r0 + ty; r < r1; r += U * w.ty_n) {
      Vec v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * w.ty_n < r1)
          v[u] = load_vec<T, VEC>(y, r + u * w.ty_n, c, grp);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * w.ty_n < r1)
#pragma unroll
          for (int j = 0; j < L; ++j) {
            const float f = lane<T>(v[u], j);
            s1[j] += f;
            s2[j] += f * f;
          }
    }
  }
  block_partials<L>(s1, s2, red, w, c, part);
}

// #21.  One read of g, x (and out under RELU); dx (and dres under RES)
// written as they are formed.
template <class T, bool RELU, bool RES, bool VEC>
__global__ void __launch_bounds__(NT, Lanes<T>::kMinBlocks)
ssa_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
               const T* __restrict__ out, const float* __restrict__ wv,
               T* __restrict__ dx, T* __restrict__ dres, int64_t rows, int c,
               Walk w, float* __restrict__ part) {
  constexpr int L = Lanes<T>::kN;
  constexpr int U = 2;  // rows a round
  __shared__ float red[2 * NT * L];
  const int tx = threadIdx.x % w.tx_n;
  const int ty = threadIdx.x / w.tx_n;
  const int grp = blockIdx.x * w.tx_n + tx;
  float sg[L], sgx[L];
#pragma unroll
  for (int j = 0; j < L; ++j) sg[j] = sgx[j] = 0.f;
  if (ty < w.ty_n && grp * L < c) {
    const int64_t r0 = (int64_t)blockIdx.y * w.chunk_rows;
    const int64_t r1 = r0 + w.chunk_rows < rows ? r0 + w.chunk_rows : rows;
    const Vec wq = channel_vec<T>(wv, c, grp);
    for (int64_t r = r0 + ty; r < r1; r += U * w.ty_n) {
      Vec gv[U], xv[U], ov[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r + u * w.ty_n < r1) {
          gv[u] = load_vec<T, VEC>(g, r + u * w.ty_n, c, grp);
          xv[u] = load_vec<T, VEC>(x, r + u * w.ty_n, c, grp);
          if (RELU) ov[u] = load_vec<T, VEC>(out, r + u * w.ty_n, c, grp);
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * w.ty_n >= r1) continue;
        Vec gp, d;  // g' and dx
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gp.w[i] = RELU ? Arith<T>::where_pos(gv[u].w[i], ov[u].w[i])
                         : gv[u].w[i];
          d.w[i] = Arith<T>::mul(gp.w[i], wq.w[i]);
        }
        store_vec<T, VEC>(dx, r + u * w.ty_n, c, grp, d);
        if (RES) store_vec<T, VEC>(dres, r + u * w.ty_n, c, grp, gp);
#pragma unroll
        for (int j = 0; j < L; ++j) {
          const float gf = lane<T>(gp, j);
          sg[j] += gf;
          sgx[j] += gf * lane<T>(xv[u], j);
        }
      }
    }
  }
  block_partials<L>(sg, sgx, red, w, c, part);
}

// #20 on the walk.  One read of x (and res under RES), out written as it
// is formed.  Only bf16 runs it (ssa_fwd_launch): T keeps the walk's
// helpers and types in the form #18 and #21 share.
template <class T, bool RELU, bool RES, bool VEC>
__global__ void __launch_bounds__(NT, Lanes<T>::kMinBlocks)
ssa_fwd_walk_kernel(const T* __restrict__ x, const float* __restrict__ wv,
                    const float* __restrict__ bv, const T* __restrict__ res,
                    T* __restrict__ out, int64_t rows, int c, Walk w) {
  constexpr int U = 2;  // rows a round
  const int tx = threadIdx.x % w.tx_n;
  const int ty = threadIdx.x / w.tx_n;
  const int grp = blockIdx.x * w.tx_n + tx;
  if (ty >= w.ty_n || grp * Lanes<T>::kN >= c) return;
  const int64_t r0 = (int64_t)blockIdx.y * w.chunk_rows;
  const int64_t r1 = r0 + w.chunk_rows < rows ? r0 + w.chunk_rows : rows;
  const Vec wq = channel_vec<T>(wv, c, grp);
  const Vec bq = channel_vec<T>(bv, c, grp);
  for (int64_t r = r0 + ty; r < r1; r += U * w.ty_n) {
    Vec xv[U], rv[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (r + u * w.ty_n < r1) {
        xv[u] = load_vec<T, VEC>(x, r + u * w.ty_n, c, grp);
        if (RES) rv[u] = load_vec<T, VEC>(res, r + u * w.ty_n, c, grp);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * w.ty_n >= r1) continue;
      Vec o;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v = Arith<T>::add(Arith<T>::mul(xv[u].w[i], wq.w[i]),
                                   bq.w[i]);
        if (RES) v = Arith<T>::add(v, rv[u].w[i]);
        o.w[i] = RELU ? Arith<T>::relu(v) : v;
      }
      store_vec<T, VEC>(out, r + u * w.ty_n, c, grp, o);
    }
  }
}

// s1[c] = sum_p part[p * C + c] and s2[c] = sum_p part[(parts + p) * C +
// c] for p < parts.  A block takes 32 of the 2C (stat, channel) columns
// with 8 lanes each: lane l sums p = l, l + 8, ... in increasing p, then
// lanes 0..7 are added in order.
__global__ void __launch_bounds__(NT)
reduce_partials(const float* __restrict__ part, int parts, int c,
                float* __restrict__ s1, float* __restrict__ s2) {
  __shared__ float lanes[8][33];
  const int col = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
  const int t = blockIdx.x * 32 + col;
  float s = 0.f;
  if (t < 2 * c) {
    const float* p = part + (size_t)(t / c) * parts * c + t % c;
    for (int i = lane; i < parts; i += 8) s += p[(size_t)i * c];
  }
  lanes[lane][col] = s;
  __syncthreads();
  if (lane == 0 && t < 2 * c) {
    float total = 0.f;
    for (int l = 0; l < 8; ++l) total += lanes[l][col];
    (t < c ? s1 : s2)[t % c] = total;
  }
}

cudaError_t reduce(const float* part, int parts, int c, float* s1, float* s2,
                   cudaStream_t stream) {
  reduce_partials<<<(2 * c + 31) / 32, NT, 0, stream>>>(part, parts, c, s1,
                                                        s2);
  return cudaGetLastError();
}

// #19 in f32.  y [M, N] = x2 [M, K] w2^T (w2 [N, K]) on gemm.cuh's 128x128
// tiles, unsplit; the block's column sums of the stored y go to
// part[(stat * m_tiles + blockIdx.y) * N + n].
__global__ void __launch_bounds__(GNT, 2)
dot_stats_kernel(const float* __restrict__ x2, const float* __restrict__ w2,
                 float* __restrict__ y, float* __restrict__ part, int M,
                 int N, int K) {
  static_assert(GEMM_SMEM >= 2 * 16 * GT, "the epilogue's two sums");
  __shared__ __align__(16) float smem[GEMM_SMEM];
  float* a_s = smem;
  float* b_s = smem + 16 * GT;
  const int n0 = blockIdx.x * GT;
  const int m0 = blockIdx.y * GT;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  float acc[8][8];
  gemm_tile<false, false>(x2, K, w2, K, M, N, m0, n0, 0, K, smem, acc);

  float c1[8], c2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) c1[j] = c2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + gemm_tile_row(i, ty);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + gemm_tile_row(j, tx);
      const float v = acc[i][j];
      if (n < N) y[(size_t)m * N + n] = v;
      c1[j] += v;
      c2[j] += v * v;
    }
  }
  // a_s holds the 16 thread rows' s1 of the tile's 128 columns, b_s their
  // s2
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a_s[ty * GT + gemm_tile_row(j, tx)] = c1[j];
    b_s[ty * GT + gemm_tile_row(j, tx)] = c2[j];
  }
  __syncthreads();
  const int col = threadIdx.x % GT;
  const int stat = threadIdx.x / GT;
  const int n = n0 + col;
  if (n < N) {
    const float* r = (stat ? b_s : a_s) + col;
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += r[t * GT];
    part[((size_t)stat * gridDim.y + blockIdx.y) * N + n] = s;
  }
}

// #20 in f32.  Elementwise over [rows, C] as float4.
template <bool RELU, bool RES>
__global__ void __launch_bounds__(NT)
ssa_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wv,
               const float* __restrict__ bv, const float* __restrict__ res,
               float* __restrict__ out, int64_t quads, int qn) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* w4 = reinterpret_cast<const float4*>(wv);
  const float4* b4 = reinterpret_cast<const float4*>(bv);
  const float4* r4 = reinterpret_cast<const float4*>(res);
  float4* o4 = reinterpret_cast<float4*>(out);
  const int64_t stride = (int64_t)gridDim.x * NT;
  const int q_step = (int)(stride % qn);
  int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x;
  // q = i % qn, carried from step to step without a 64-bit division
  for (int q = (int)(i % qn); i < quads; i += stride) {
    const float4 v = x4[i];
    const float4 w = w4[q];
    const float4 b = b4[q];
    float4 o = make_float4(__fadd_rn(__fmul_rn(v.x, w.x), b.x),
                           __fadd_rn(__fmul_rn(v.y, w.y), b.y),
                           __fadd_rn(__fmul_rn(v.z, w.z), b.z),
                           __fadd_rn(__fmul_rn(v.w, w.w), b.w));
    if (RES) {
      const float4 r = r4[i];
      o.x = __fadd_rn(o.x, r.x); o.y = __fadd_rn(o.y, r.y);
      o.z = __fadd_rn(o.z, r.z); o.w = __fadd_rn(o.w, r.w);
    }
    if (RELU) {
      o.x = fmaxf(o.x, 0.f); o.y = fmaxf(o.y, 0.f);
      o.z = fmaxf(o.z, 0.f); o.w = fmaxf(o.w, 0.f);
    }
    o4[i] = o;
    q += q_step;
    if (q >= qn) q -= qn;
  }
}

// #20 in f32 at any C: elementwise over [rows, C], one channel a step,
// with the float4 form's roundings.
template <bool RELU, bool RES>
__global__ void __launch_bounds__(NT)
ssa_fwd_scalar_kernel(const float* __restrict__ x,
                      const float* __restrict__ wv,
                      const float* __restrict__ bv,
                      const float* __restrict__ res, float* __restrict__ out,
                      int64_t n, int c) {
  const int64_t stride = (int64_t)gridDim.x * NT;
  const int ch_step = (int)(stride % c);
  int64_t i = blockIdx.x * (int64_t)NT + threadIdx.x;
  // ch = i % c, carried from step to step without a 64-bit division
  for (int ch = (int)(i % c); i < n; i += stride) {
    float o = __fadd_rn(__fmul_rn(x[i], wv[ch]), bv[ch]);
    if (RES) o = __fadd_rn(o, res[i]);
    if (RELU) o = fmaxf(o, 0.f);
    out[i] = o;
    ch += ch_step;
    if (ch >= c) ch -= c;
  }
}

bool bad_shape(int64_t rows, int c) { return rows <= 0 || c <= 0; }

// The vector forms take C % lanes == 0 and 16-byte aligned tensors (nulls
// aside).
bool vec_ok(int c, int lanes, std::initializer_list<const void*> tensors) {
  if (c % lanes != 0) return false;
  for (const void* t : tensors)
    if (reinterpret_cast<uintptr_t>(t) % 16 != 0) return false;
  return true;
}

// The walk of #18 and #21: f32's fixed one, bf16's one wave.
template <class T>
Walk walk_of(int64_t rows, int c) {
  return sizeof(T) == 2 ? make_walk_bf16(rows, c) : make_walk(rows, c);
}

template <class T>
int channel_stats(const T* y, float* part, float* s1, float* s2,
                  int64_t rows, int c, void* stream) {
  if (bad_shape(rows, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Walk w = walk_of<T>(rows, c);
  const dim3 grid(w.col_tiles, w.chunks);
  if (vec_ok(c, Lanes<T>::kN, {y}))
    channel_stats_kernel<T, true><<<grid, NT, 0, s>>>(y, rows, c, w, part);
  else
    channel_stats_kernel<T, false><<<grid, NT, 0, s>>>(y, rows, c, w, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(part, w.chunks, c, s1, s2, s);
}

template <class T, bool RELU, bool RES>
void ssa_bwd_launch(bool vec, const T* g, const T* x, const T* out,
                    const float* wv, T* dx, T* dres, int64_t rows, int c,
                    const Walk& w, float* part, cudaStream_t s) {
  const dim3 grid(w.col_tiles, w.chunks);
  if (vec)
    ssa_bwd_kernel<T, RELU, RES, true><<<grid, NT, 0, s>>>(
        g, x, out, wv, dx, dres, rows, c, w, part);
  else
    ssa_bwd_kernel<T, RELU, RES, false><<<grid, NT, 0, s>>>(
        g, x, out, wv, dx, dres, rows, c, w, part);
}

template <class T>
int ssa_bwd(const T* g, const T* x, const T* out, const float* wv, T* dx,
            T* dres, float* part, float* sg, float* sgx, int64_t rows, int c,
            int relu, void* stream) {
  if (bad_shape(rows, c) || (relu && !out)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Walk w = walk_of<T>(rows, c);
  // f32 keeps its test with wv aligned too, which chooses nothing but
  // the path: the lanes' values and order are the same on both
  const bool vec = sizeof(T) == 2 ? vec_ok(c, Lanes<T>::kN,
                                           {g, x, out, dx, dres})
                                  : vec_ok(c, 4, {g, x, out, wv, dx, dres});
  if (relu && dres)
    ssa_bwd_launch<T, true, true>(vec, g, x, out, wv, dx, dres, rows, c, w,
                                  part, s);
  else if (relu)
    ssa_bwd_launch<T, true, false>(vec, g, x, out, wv, dx, nullptr, rows, c,
                                   w, part, s);
  else if (dres)
    ssa_bwd_launch<T, false, true>(vec, g, x, nullptr, wv, dx, dres, rows, c,
                                   w, part, s);
  else
    ssa_bwd_launch<T, false, false>(vec, g, x, nullptr, wv, dx, nullptr,
                                    rows, c, w, part, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(part, w.chunks, c, sg, sgx, s);
}

// #20 at one RELU / RES: f32 on its flat loops (on the walk it reads
// 1.5-4% slower), bf16 on the walk.
template <class T, bool RELU, bool RES>
void ssa_fwd_launch(bool vec, const T* x, const float* wv, const float* bv,
                    const T* res, T* out, int64_t rows, int c,
                    cudaStream_t s) {
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      const int64_t quads = rows * (c / 4);
      const int blocks = (int)std::min<int64_t>((quads + NT - 1) / NT,
                                                4 * kTargetBlocks);
      ssa_fwd_kernel<RELU, RES><<<blocks, NT, 0, s>>>(x, wv, bv, res, out,
                                                      quads, c / 4);
    } else {
      const int64_t n = rows * c;
      const int blocks = (int)std::min<int64_t>((n + NT - 1) / NT,
                                                4 * kTargetBlocks);
      ssa_fwd_scalar_kernel<RELU, RES><<<blocks, NT, 0, s>>>(
          x, wv, bv, res, out, n, c);
    }
  } else {
    const Walk w = make_walk_bf16(rows, c);
    const dim3 grid(w.col_tiles, w.chunks);
    if (vec)
      ssa_fwd_walk_kernel<T, RELU, RES, true><<<grid, NT, 0, s>>>(
          x, wv, bv, res, out, rows, c, w);
    else
      ssa_fwd_walk_kernel<T, RELU, RES, false><<<grid, NT, 0, s>>>(
          x, wv, bv, res, out, rows, c, w);
  }
}

template <class T>
int ssa_fwd(const T* x, const float* wv, const float* bv, const T* res,
            T* out, int64_t rows, int c, int relu, void* stream) {
  if (bad_shape(rows, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // f32's flat loop reads wv and bv by float4 too; the walk by channel
  const bool vec = sizeof(T) == 2 ? vec_ok(c, Lanes<T>::kN, {x, res, out})
                                  : vec_ok(c, 4, {x, wv, bv, res, out});
  if (relu && res)
    ssa_fwd_launch<T, true, true>(vec, x, wv, bv, res, out, rows, c, s);
  else if (relu)
    ssa_fwd_launch<T, true, false>(vec, x, wv, bv, nullptr, out, rows, c, s);
  else if (res)
    ssa_fwd_launch<T, false, true>(vec, x, wv, bv, res, out, rows, c, s);
  else
    ssa_fwd_launch<T, false, false>(vec, x, wv, bv, nullptr, out, rows, c,
                                    s);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of partial sums #18 or #21 needs for y [rows, C]: 2 * chunks * C
// (f32; _bf16: the bf16 walk's chunks on the current device).
extern "C" int64_t ptt_stats_partials(int64_t rows, int c) {
  if (bad_shape(rows, c)) return 0;
  return 2 * (int64_t)walk_of<float>(rows, c).chunks * c;
}

extern "C" int64_t ptt_stats_partials_bf16(int64_t rows, int c) {
  if (bad_shape(rows, c)) return 0;
  return 2 * (int64_t)walk_of<bf16>(rows, c).chunks * c;
}

// Shared memory of a #19 block in bytes (f32).
extern "C" int64_t ptt_dot_stats_smem() {
  return (int64_t)(GEMM_SMEM * sizeof(float));
}

// Floats of partial sums #19 needs for y [M, N]: 2 * ceil(M / 128) * N
// (both types).
extern "C" int64_t ptt_dot_stats_partials(int m, int n) {
  return 2 * (int64_t)((m + GT - 1) / GT) * n;
}

// #18.  y [rows, C]; s1, s2 [C]; part: ptt_stats_partials floats.
extern "C" int ptt_channel_stats(const float* y, float* part, float* s1,
                                 float* s2, int64_t rows, int c,
                                 void* stream) {
  return channel_stats(y, part, s1, s2, rows, c, stream);
}

// #18 in bf16: y bf16; the sums f32; part: ptt_stats_partials_bf16 floats.
extern "C" int ptt_channel_stats_bf16(const bf16* y, float* part, float* s1,
                                      float* s2, int64_t rows, int c,
                                      void* stream) {
  return channel_stats(y, part, s1, s2, rows, c, stream);
}

// #19.  x2 [M, K], w2 [N, K], y [M, N]; s1, s2 [N]; part:
// ptt_dot_stats_partials floats.
extern "C" int ptt_dot_col_stats(const float* x2, const float* w2, float* y,
                                 float* part, float* s1, float* s2, int m,
                                 int n, int k, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + GT - 1) / GT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m_tiles = (m + GT - 1) / GT;
  dot_stats_kernel<<<dim3((n + GT - 1) / GT, m_tiles), GNT, 0, s>>>(
      x2, w2, y, part, m, n, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(part, m_tiles, n, s1, s2, s);
}

// #19 in bf16 on tensor cores: x2, w2 and y bf16, K % 8 == 0, N even, x2
// and w2 16-byte aligned (else cudaErrorInvalidValue, before any launch);
// the sums f32; part: ptt_dot_stats_partials floats.
extern "C" int ptt_dot_col_stats_bf16(const bf16* x2, const bf16* w2,
                                      bf16* y, float* part, float* s1,
                                      float* s2, int m, int n, int k,
                                      void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + GT - 1) / GT > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = gemm_tc_col_stats(x2, w2, y, part, m, n, k, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(part, (m + GT - 1) / GT, n, s1, s2, s);
}

// #20.  x, out [rows, C]; wv, bv [C]; res [rows, C] or null.
extern "C" int ptt_ssa_fwd(const float* x, const float* wv, const float* bv,
                           const float* res, float* out, int64_t rows, int c,
                           int relu, void* stream) {
  return ssa_fwd(x, wv, bv, res, out, rows, c, relu, stream);
}

// #20 in bf16: x, res and out bf16; wv, bv f32 (rounded to bf16 in the
// kernel).
extern "C" int ptt_ssa_fwd_bf16(const bf16* x, const float* wv,
                                const float* bv, const bf16* res, bf16* out,
                                int64_t rows, int c, int relu,
                                void* stream) {
  return ssa_fwd(x, wv, bv, res, out, rows, c, relu, stream);
}

// #21.  g, x, dx [rows, C]; out [rows, C] under relu, else null; dres
// [rows, C] with a residual, else null; wv, sg, sgx [C]; part:
// ptt_stats_partials floats.
extern "C" int ptt_ssa_bwd(const float* g, const float* x, const float* out,
                           const float* wv, float* dx, float* dres,
                           float* part, float* sg, float* sgx, int64_t rows,
                           int c, int relu, void* stream) {
  return ssa_bwd(g, x, out, wv, dx, dres, part, sg, sgx, rows, c, relu,
                 stream);
}

// #21 in bf16: g, x, out, dx and dres bf16; wv, sg and sgx f32; part:
// ptt_stats_partials_bf16 floats.
extern "C" int ptt_ssa_bwd_bf16(const bf16* g, const bf16* x,
                                const bf16* out, const float* wv, bf16* dx,
                                bf16* dres, float* part, float* sg,
                                float* sgx, int64_t rows, int c, int relu,
                                void* stream) {
  return ssa_bwd(g, x, out, wv, dx, dres, part, sg, sgx, rows, c, relu,
                 stream);
}
