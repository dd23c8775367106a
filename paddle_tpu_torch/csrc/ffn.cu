// Decode feed-forward epilogue: out = LN3(x + relu(x W_in + b_in) W_out
// + b_out), f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/decode_step.py _ffn_kernel, the second
// launch per layer of the megastep's split-FFN mode.  The TPU kernel does
// the whole [b, d_model] batch in one grid step; a single block here would
// stream the 8 MB of Transformer-base FFN weights through one SM.  So the
// grid splits d_inner into 64-column chunks (and the batch into 16-row
// tiles):
//
//   block (chunk c, tile r): h = relu(x[r] W_in[:, c] + b_in[c])   [16, 64]
//                            partial[c, r] = h W_out[c, :]         [16, dm]
//
// The hidden activations never leave shared memory.  The partial products
// go to a scratch buffer; the last block of a row tile to finish (an atomic
// ticket per tile, after a __threadfence) sums them in chunk order, so the
// result does not depend on block scheduling, adds b_out and the residual,
// applies LN3 and writes out.  That block resets its ticket to 0 for the
// next launch.
//
// Bound: bytes (the two weight matrices, read once per row tile).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int BM = 16;   // batch rows per tile
constexpr int BN = 64;   // d_inner columns per chunk
constexpr int HS = BN + 1;

__global__ void __launch_bounds__(NT)
ffn_kernel(const float* __restrict__ x, const float* __restrict__ w_in,
           const float* __restrict__ b_in, const float* __restrict__ w_out,
           const float* __restrict__ b_out, const float* __restrict__ ln_s,
           const float* __restrict__ ln_b, float* out, float* partial,
           int* tickets, int batch, int dm, int di, float eps) {
  extern __shared__ float smem[];
  float* x_s = smem;              // [BM][dm]
  float* h_s = x_s + BM * dm;     // [BM][HS]
  __shared__ int last_s;

  const int chunk = blockIdx.x;
  const int tile = blockIdx.y;
  const int r0 = tile * BM;
  const int c0 = chunk * BN;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < BM * dm; idx += NT) {
    const int r = idx / dm;
    x_s[idx] = (r0 + r < batch) ? x[(size_t)(r0 + r) * dm + idx % dm] : 0.f;
  }
  __syncthreads();

  // phase 1: this chunk's hidden columns for the tile's rows
  {
    const int col = tid % BN;
    const int rg = tid / BN;  // rows rg*4 .. rg*4+3
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (c0 + col < di) {
      const float* wp = w_in + c0 + col;
#pragma unroll 8
      for (int k = 0; k < dm; ++k) {
        const float w = __ldg(wp + (size_t)k * di);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] += x_s[(rg * 4 + i) * dm + k] * w;
      }
    }
    const float bias = (c0 + col < di) ? b_in[c0 + col] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h_s[(rg * 4 + i) * HS + col] =
          (c0 + col < di) ? fmaxf(acc[i] + bias, 0.f) : 0.f;
  }
  __syncthreads();

  // phase 2: partial[chunk, rows, :] = h @ W_out[c0 : c0 + BN, :]
  const int n4 = dm >> 2;
  const int kn = min(BN, di - c0);
  for (int u = tid; u < 2 * n4; u += NT) {
    const int c4 = u % n4;
    const int half = u / n4;  // rows half*8 .. half*8+7
    float4 acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    const float* wp = w_out + (size_t)c0 * dm + c4 * 4;
    for (int k = 0; k < kn; ++k, wp += dm) {
      const float4 w = __ldg(reinterpret_cast<const float4*>(wp));
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float hv = h_s[(half * 8 + i) * HS + k];
        acc[i].x += hv * w.x; acc[i].y += hv * w.y;
        acc[i].z += hv * w.z; acc[i].w += hv * w.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + half * 8 + i;
      if (row < batch)
        *reinterpret_cast<float4*>(
            partial + ((size_t)chunk * batch + row) * dm + c4 * 4) = acc[i];
    }
  }

  // the last block of this row tile reduces the chunks
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_s = atomicAdd(tickets + tile, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  const int lane = tid & 31;
  for (int r = tid >> 5; r < BM; r += NW) {
    const int row = r0 + r;
    if (row >= batch) continue;
    float* y = x_s + r * dm;  // x row, overwritten by x + ffn
    float local = 0.f;
    for (int j = lane; j < dm; j += 32) {
      float f = 0.f;
      for (int c = 0; c < gridDim.x; ++c)
        f += __ldcg(partial + ((size_t)c * batch + row) * dm + j);
      const float v = y[j] + (f + b_out[j]);
      y[j] = v;
      local += v;
    }
    const float mean = ptt::warp_sum(local) / dm;
    local = 0.f;
    for (int j = lane; j < dm; j += 32) {
      const float d = y[j] - mean;
      local += d * d;
    }
    const float var = ptt::warp_sum(local) / dm;
    const float rstd = rsqrtf(var + eps);
    for (int j = lane; j < dm; j += 32)
      out[(size_t)row * dm + j] = (y[j] - mean) * rstd * ln_s[j] + ln_b[j];
  }
  if (tid == 0) tickets[tile] = 0;
}

}  // namespace

// Grid and scratch sizes, so the caller can allocate them.
extern "C" int ptt_ffn_chunks(int di) { return (di + BN - 1) / BN; }
extern "C" int ptt_ffn_tiles(int batch) { return (batch + BM - 1) / BM; }

// x/out [b, dm]; partial [chunks, b, dm] scratch; tickets [tiles] int32,
// zero on entry and left zero on exit.
extern "C" int ptt_ffn(const float* x, const float* w_in, const float* b_in,
                       const float* w_out, const float* b_out,
                       const float* ln_s, const float* ln_b, float* out,
                       float* partial, int* tickets, int batch, int dm,
                       int di, float eps, void* stream) {
  const int smem = (int)sizeof(float) * (BM * dm + BM * HS);
  static int configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid(ptt_ffn_chunks(di), ptt_ffn_tiles(batch));
  ffn_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w_in, b_in, w_out, b_out, ln_s, ln_b, out, partial, tickets, batch,
      dm, di, eps);
  return (int)cudaGetLastError();
}
