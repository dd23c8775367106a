// Batch-norm kernels of the fused conv + BN route, f32, for sm_90a.
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
// (channels fastest) and 16-byte aligned, with C % 4 == 0, so a thread
// moves four channels as one float4.  The TPU kernel's lane fold for
// C < 128 is layout plumbing for the TPU's 128-lane tiles and has no
// counterpart here.
//
// Reductions across blocks use no atomics.  Each block of #18 and #21
// owns a chunk of rows and a tile of channels, sums its chunk per channel
// in a fixed order (per thread in increasing row, then over the block's
// thread rows in order) and writes one partial per (chunk, channel); each
// block of #19 writes one per (128-row tile, column).  reduce_partials
// then adds the partials of each channel in a fixed order.  A repeated
// call gives the same bits.  #20 and #21 round x * wv and the adds one at
// a time (__fmul_rn, __fadd_rn), as the plain PyTorch twin does.
//
// Bounds: #18, #20 and #21 move each byte once and are bound by device
// memory (#21 reads g, x and out and writes dx and dres).  #19 is bound by
// its f32 FMAs at ResNet-50's 1x1 shapes (at K 64, 2MNK FLOPs take 0.40 ms
// against 0.25 ms for the 4MN bytes of y at stage 1); it runs
// csrc/gemm.cuh's 128x128 f32 tile (no tensor cores: TF32 is off, as in
// the reference's f32 step) and folds the column statistics into that
// tile's epilogue, so y is never read back for them.  At K 512 the tile
// reaches 43 TFLOP/s; at K 64 a block is 4 stages deep, so its exposed
// first load and its epilogue (64 scalar stores a thread, two barriers)
// hold it to 31.  Persistent blocks and float4 stores of y, which would
// hide or shorten them, cost the tile registers it does not have (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "gemm.cuh"

namespace {

constexpr int NT = 256;
// blocks a statistics pass aims for: 8 of 256 threads on each of 132 SMs
constexpr int kTargetBlocks = 132 * 8;

// The [rows, C] walk of #18 and #21: a block of NT threads is TY thread
// rows by TX quads of channels; it covers quads [blockIdx.x * TX, ..) and
// rows [blockIdx.y * chunk_rows, ..).
struct Walk {
  int tx_n, ty_n, col_tiles, chunks, chunk_rows;
};

Walk make_walk(int64_t rows, int c) {
  Walk w;
  const int quads = c / 4;
  w.tx_n = std::min(quads, 32);
  w.ty_n = NT / w.tx_n;
  w.col_tiles = (quads + w.tx_n - 1) / w.tx_n;
  const int64_t max_chunks = std::max<int64_t>(1, (rows + w.ty_n - 1) /
                                                      w.ty_n);
  const int64_t want = (kTargetBlocks + w.col_tiles - 1) / w.col_tiles;
  w.chunks = (int)std::min<int64_t>(want, max_chunks);
  w.chunk_rows = (int)((rows + w.chunks - 1) / w.chunks);
  w.chunks = (int)((rows + w.chunk_rows - 1) / w.chunk_rows);
  return w;
}

// Sums of this thread's four channels (s1[0..3], s2[0..3]) over the block's
// thread rows, in order, into part[chunk * C + c] and
// part[(chunks + chunk) * C + c].  red holds 2 * NT * 4 floats.
__device__ __forceinline__ void block_partials(const float (&s1)[4],
                                               const float (&s2)[4],
                                               float* red, const Walk& w,
                                               int c, float* part) {
  const int tx = threadIdx.x % w.tx_n;
  const int ty = threadIdx.x / w.tx_n;
  const int width = 4 * w.tx_n;
  if (ty < w.ty_n) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[ty * width + 4 * tx + j] = s1[j];
      red[NT * 4 + ty * width + 4 * tx + j] = s2[j];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * width; t += NT) {
    const int stat = t / width;
    const int col = t % width;
    const int ch = blockIdx.x * width + col;
    if (ch >= c) continue;
    const float* r = red + stat * NT * 4 + col;
    float s = 0.f;
    for (int y = 0; y < w.ty_n; ++y) s += r[y * width];
    part[((size_t)stat * gridDim.y + blockIdx.y) * c + ch] = s;
  }
}

// #18.  One read of y [rows, C].
__global__ void __launch_bounds__(NT)
channel_stats_kernel(const float* __restrict__ y, int64_t rows, int c,
                     Walk w, float* __restrict__ part) {
  __shared__ float red[2 * NT * 4];
  const int tx = threadIdx.x % w.tx_n;
  const int ty = threadIdx.x / w.tx_n;
  const int q = blockIdx.x * w.tx_n + tx;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  if (ty < w.ty_n && 4 * q < c) {
    const int64_t r0 = (int64_t)blockIdx.y * w.chunk_rows;
    const int64_t r1 = r0 + w.chunk_rows < rows ? r0 + w.chunk_rows : rows;
    const float4* y4 = reinterpret_cast<const float4*>(y);
    const int qn = c / 4;
#pragma unroll 4
    for (int64_t r = r0 + ty; r < r1; r += w.ty_n) {
      const float4 v = y4[r * qn + q];
      s1[0] += v.x; s1[1] += v.y; s1[2] += v.z; s1[3] += v.w;
      s2[0] += v.x * v.x; s2[1] += v.y * v.y;
      s2[2] += v.z * v.z; s2[3] += v.w * v.w;
    }
  }
  block_partials(s1, s2, red, w, c, part);
}

// #21.  One read of g, x (and out under RELU); dx (and dres under RES)
// written as they are formed.
template <bool RELU, bool RES>
__global__ void __launch_bounds__(NT)
ssa_bwd_kernel(const float* __restrict__ g, const float* __restrict__ x,
               const float* __restrict__ out, const float* __restrict__ wv,
               float* __restrict__ dx, float* __restrict__ dres,
               int64_t rows, int c, Walk w, float* __restrict__ part) {
  __shared__ float red[2 * NT * 4];
  const int tx = threadIdx.x % w.tx_n;
  const int ty = threadIdx.x / w.tx_n;
  const int q = blockIdx.x * w.tx_n + tx;
  float sg[4] = {0.f, 0.f, 0.f, 0.f}, sgx[4] = {0.f, 0.f, 0.f, 0.f};
  if (ty < w.ty_n && 4 * q < c) {
    const int64_t r0 = (int64_t)blockIdx.y * w.chunk_rows;
    const int64_t r1 = r0 + w.chunk_rows < rows ? r0 + w.chunk_rows : rows;
    const int qn = c / 4;
    const float4 wq = reinterpret_cast<const float4*>(wv)[q];
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* o4 = reinterpret_cast<const float4*>(out);
#pragma unroll 2
    for (int64_t r = r0 + ty; r < r1; r += w.ty_n) {
      const int64_t i = r * qn + q;
      float4 gv = g4[i];
      const float4 xv = x4[i];
      if (RELU) {
        const float4 ov = o4[i];
        gv.x = ov.x > 0.f ? gv.x : 0.f;
        gv.y = ov.y > 0.f ? gv.y : 0.f;
        gv.z = ov.z > 0.f ? gv.z : 0.f;
        gv.w = ov.w > 0.f ? gv.w : 0.f;
      }
      reinterpret_cast<float4*>(dx)[i] = make_float4(
          __fmul_rn(gv.x, wq.x), __fmul_rn(gv.y, wq.y),
          __fmul_rn(gv.z, wq.z), __fmul_rn(gv.w, wq.w));
      if (RES) reinterpret_cast<float4*>(dres)[i] = gv;
      sg[0] += gv.x; sg[1] += gv.y; sg[2] += gv.z; sg[3] += gv.w;
      sgx[0] += gv.x * xv.x; sgx[1] += gv.y * xv.y;
      sgx[2] += gv.z * xv.z; sgx[3] += gv.w * xv.w;
    }
  }
  block_partials(sg, sgx, red, w, c, part);
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

// #19.  y [M, N] = x2 [M, K] w2^T (w2 [N, K]) on gemm.cuh's 128x128 tiles,
// unsplit; the block's column sums of the stored y go to
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

// #20.  Elementwise over [rows, C] as float4.
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

bool bad_shape(int64_t rows, int c) {
  return rows <= 0 || c <= 0 || c % 4 != 0;
}

}  // namespace

// Floats of partial sums #18 or #21 needs for y [rows, C]: 2 * chunks * C.
extern "C" int64_t ptt_stats_partials(int64_t rows, int c) {
  if (bad_shape(rows, c)) return 0;
  return 2 * (int64_t)make_walk(rows, c).chunks * c;
}

// Shared memory of a #19 block in bytes.
extern "C" int64_t ptt_dot_stats_smem() {
  return (int64_t)(GEMM_SMEM * sizeof(float));
}

// Floats of partial sums #19 needs for y [M, N]: 2 * ceil(M / 128) * N.
extern "C" int64_t ptt_dot_stats_partials(int m, int n) {
  return 2 * (int64_t)((m + GT - 1) / GT) * n;
}

// #18.  y [rows, C]; s1, s2 [C]; part: ptt_stats_partials floats.
extern "C" int ptt_channel_stats(const float* y, float* part, float* s1,
                                 float* s2, int64_t rows, int c,
                                 void* stream) {
  if (bad_shape(rows, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Walk w = make_walk(rows, c);
  channel_stats_kernel<<<dim3(w.col_tiles, w.chunks), NT, 0, s>>>(
      y, rows, c, w, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(part, w.chunks, c, s1, s2, s);
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

// #20.  x, out [rows, C]; wv, bv [C]; res [rows, C] or null.
extern "C" int ptt_ssa_fwd(const float* x, const float* wv, const float* bv,
                           const float* res, float* out, int64_t rows, int c,
                           int relu, void* stream) {
  if (bad_shape(rows, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t quads = rows * (c / 4);
  const int blocks = (int)std::min<int64_t>((quads + NT - 1) / NT,
                                            4 * kTargetBlocks);
  const int qn = c / 4;
  if (relu && res)
    ssa_fwd_kernel<true, true><<<blocks, NT, 0, s>>>(x, wv, bv, res, out,
                                                     quads, qn);
  else if (relu)
    ssa_fwd_kernel<true, false><<<blocks, NT, 0, s>>>(x, wv, bv, nullptr,
                                                      out, quads, qn);
  else if (res)
    ssa_fwd_kernel<false, true><<<blocks, NT, 0, s>>>(x, wv, bv, res, out,
                                                      quads, qn);
  else
    ssa_fwd_kernel<false, false><<<blocks, NT, 0, s>>>(x, wv, bv, nullptr,
                                                       out, quads, qn);
  return (int)cudaGetLastError();
}

// #21.  g, x, dx [rows, C]; out [rows, C] under relu, else null; dres
// [rows, C] with a residual, else null; wv, sg, sgx [C]; part:
// ptt_stats_partials floats.
extern "C" int ptt_ssa_bwd(const float* g, const float* x, const float* out,
                           const float* wv, float* dx, float* dres,
                           float* part, float* sg, float* sgx, int64_t rows,
                           int c, int relu, void* stream) {
  if (bad_shape(rows, c) || (relu && !out)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Walk w = make_walk(rows, c);
  const dim3 grid(w.col_tiles, w.chunks);
  if (relu && dres)
    ssa_bwd_kernel<true, true><<<grid, NT, 0, s>>>(g, x, out, wv, dx, dres,
                                                   rows, c, w, part);
  else if (relu)
    ssa_bwd_kernel<true, false><<<grid, NT, 0, s>>>(g, x, out, wv, dx,
                                                    nullptr, rows, c, w,
                                                    part);
  else if (dres)
    ssa_bwd_kernel<false, true><<<grid, NT, 0, s>>>(g, x, nullptr, wv, dx,
                                                    dres, rows, c, w, part);
  else
    ssa_bwd_kernel<false, false><<<grid, NT, 0, s>>>(g, x, nullptr, wv, dx,
                                                     nullptr, rows, c, w,
                                                     part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(part, w.chunks, c, sg, sgx, s);
}
