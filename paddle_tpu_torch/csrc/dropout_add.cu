// Fused dropout + residual add and its backward, f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/dropout_epilogue.py _kernel (#16) and
// _bwd_kernel (#17), the Pallas kernels behind dropout_add:
//
//   #16  out = keep ? x * inv_keep : 0  (+ residual, when one is given)
//   #17  dx  = keep ? g * inv_keep : 0
//
// keep is hash_rng::keep over the GLOBAL flat element index (a uint32:
// the caller refuses n >= 2^32), the mask of the reference's hash path
// and of its XLA fallback, bit for bit.  The mask is regenerated in the
// backward from the seed alone; it never reaches device memory.  Without
// a residual, #16 is the embedding sites' plain dropout.
//
// Design: an elementwise grid-stride loop, four elements a thread per
// step as float4 when every pointer is 16-byte aligned (each element
// still hashed at its own index), the tail past the last whole float4
// (and unaligned tensors) one element at a time.
//
// Bound: bytes.  #16 reads x and the residual and writes out (12 bytes an
// element), #17 reads g and writes dx (8); the hash is ~10 integer ops an
// element, under the memory time on the H100.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hash_rng.cuh"

namespace {

constexpr int NT = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ float drop1(float v, uint32_t idx,
                                       const hash_rng::Dropout& d) {
  return hash_rng::keep(d.seed, idx, d.threshold) ? v * d.inv_keep : 0.f;
}

// out[i] = drop(x[i]) (+ res[i] when RES), i < n.
template <bool RES>
__global__ void __launch_bounds__(NT)
dropout_kernel(const float* __restrict__ x, const float* __restrict__ res,
               float* __restrict__ out, uint32_t n, int vec,
               hash_rng::Dropout d) {
  const uint64_t stride = (uint64_t)gridDim.x * NT;
  uint64_t tail = 0;
  if (vec) {
    const uint64_t n4 = n / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* r4 = reinterpret_cast<const float4*>(res);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (uint64_t i = blockIdx.x * NT + threadIdx.x; i < n4; i += stride) {
      const float4 v = x4[i];
      const uint32_t e = (uint32_t)(4 * i);
      float4 o = make_float4(drop1(v.x, e, d), drop1(v.y, e + 1, d),
                             drop1(v.z, e + 2, d), drop1(v.w, e + 3, d));
      if (RES) {
        const float4 r = r4[i];
        o.x += r.x; o.y += r.y; o.z += r.z; o.w += r.w;
      }
      o4[i] = o;
    }
    tail = 4 * n4;
  }
  for (uint64_t i = tail + blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    float o = drop1(x[i], (uint32_t)i, d);
    if (RES) o += res[i];
    out[i] = o;
  }
}

int launch(const float* x, const float* res, float* out, int64_t n,
           double rate, uint32_t seed, uint32_t threshold, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n >= ((int64_t)1 << 32) || rate == 0.0)
    return (int)cudaErrorInvalidValue;  // the wrapper refuses both
  const hash_rng::Dropout d = hash_rng::make_dropout(rate, seed, threshold);
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(res) |
                    reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t work = vec ? n / 4 + n % 4 : n;
  const int blocks = (int)std::min<int64_t>((work + NT - 1) / NT,
                                            kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res)
    dropout_kernel<true><<<blocks, NT, 0, s>>>(x, res, out, (uint32_t)n, vec,
                                               d);
  else
    dropout_kernel<false><<<blocks, NT, 0, s>>>(x, nullptr, out, (uint32_t)n,
                                                vec, d);
  return (int)cudaGetLastError();
}

}  // namespace

// #16.  x, out [n] and res [n] or null, contiguous f32; 0 < rate < 1,
// n < 2^32; keep when mix32(i * GOLDEN + seed) >= threshold.
extern "C" int ptt_dropout_add(const float* x, const float* res, float* out,
                               int64_t n, double rate, unsigned seed,
                               unsigned threshold, void* stream) {
  return launch(x, res, out, n, rate, seed, threshold, stream);
}

// #17.  dx = g where kept, scaled; 0 elsewhere (the residual's gradient is
// g itself and needs no kernel).
extern "C" int ptt_dropout_add_bwd(const float* g, float* dx, int64_t n,
                                   double rate, unsigned seed,
                                   unsigned threshold, void* stream) {
  return launch(g, nullptr, dx, n, rate, seed, threshold, stream);
}
