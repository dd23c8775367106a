// Fused dropout + residual add and its backward, f32 and bf16, for sm_90a.
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
// Design: an elementwise grid-stride loop, 16 bytes a thread per step (4
// f32 or 8 bf16 elements) when every pointer is 16-byte aligned (each
// element still hashed at its own index), the tail past the last whole
// vector (and unaligned tensors) one element at a time.
//
// bf16 (amp): the arithmetic of the reference's bodies in x's dtype:
// inv_keep rounded to bf16 (1/0.9 -> 1.109375), each product rounded to
// bf16, then each sum with the residual rounded to bf16.  A product of two
// bf16 values is exact in f32 and so is rounded once; the sum is formed in
// f32 and rounded to bf16, as PyTorch's and XLA's CPU bf16 adds form it.
//
// Bound: bytes.  #16 reads x and the residual and writes out (12 bytes an
// f32 element, 6 a bf16 one), #17 reads g and writes dx (8, 4); the hash
// is ~10 integer ops an element, under the memory time on the H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dtype.cuh"
#include "hash_rng.cuh"

namespace {

constexpr int NT = 256;
constexpr int kMaxBlocks = 132 * 8;

// One element as the reference's body computes it in T: keep ? x *
// inv_keep : 0 (+ r), each operation rounded to T.
__device__ __forceinline__ float drop1(float v, uint32_t idx,
                                       const hash_rng::Dropout& d) {
  return hash_rng::keep(d.seed, idx, d.threshold) ? v * d.inv_keep : 0.f;
}

__device__ __forceinline__ float drop1(bf16 v, uint32_t idx,
                                       const hash_rng::Dropout& d) {
  // d.inv_keep is already bf16-valued (launch): the f32 product is exact
  return hash_rng::keep(d.seed, idx, d.threshold)
             ? __bfloat162float(__float2bfloat16_rn(
                   __fmul_rn(__bfloat162float(v), d.inv_keep)))
             : 0.f;
}

// One element: drop(x) (+ r when RES), rounded to T.
template <class T, bool RES>
__device__ __forceinline__ T drop_add1(T v, T r, uint32_t idx,
                                       const hash_rng::Dropout& d) {
  float o = drop1(v, idx, d);
  if (RES) o += r;
  return o;
}

template <>
__device__ __forceinline__ bf16 drop_add1<bf16, true>(
    bf16 v, bf16 r, uint32_t idx,
    const hash_rng::Dropout& d) {
  return __float2bfloat16_rn(__fadd_rn(drop1(v, idx, d), to_f32(r)));
}

template <>
__device__ __forceinline__ bf16 drop_add1<bf16, false>(
    bf16 v, bf16, uint32_t idx,
    const hash_rng::Dropout& d) {
  return __float2bfloat16_rn(drop1(v, idx, d));
}

//: elements of T in one 16-byte vector
template <class T>
constexpr int kVec = 16 / sizeof(T);

// out[i] = drop(x[i]) (+ res[i] when RES), i < n.
template <class T, bool RES>
__global__ void __launch_bounds__(NT)
dropout_kernel(const T* __restrict__ x, const T* __restrict__ res,
               T* __restrict__ out, uint32_t n, int vec,
               hash_rng::Dropout d) {
  constexpr int V = kVec<T>;
  const uint64_t stride = (uint64_t)gridDim.x * NT;
  uint64_t tail = 0;
  if (vec) {
    const uint64_t nv = n / V;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const uint4* rv = reinterpret_cast<const uint4*>(res);
    uint4* ov = reinterpret_cast<uint4*>(out);
    for (uint64_t i = blockIdx.x * NT + threadIdx.x; i < nv; i += stride) {
      const uint4 a = xv[i];
      uint4 r = make_uint4(0, 0, 0, 0);
      if (RES) r = rv[i];
      uint4 o;
      const T* av = reinterpret_cast<const T*>(&a);
      const T* bv = reinterpret_cast<const T*>(&r);
      T* cv = reinterpret_cast<T*>(&o);
      const uint32_t e = (uint32_t)(V * i);
#pragma unroll
      for (int u = 0; u < V; ++u)
        cv[u] = drop_add1<T, RES>(av[u], bv[u], e + u, d);
      ov[i] = o;
    }
    tail = V * nv;
  }
  for (uint64_t i = tail + blockIdx.x * NT + threadIdx.x; i < n;
       i += stride)
    out[i] = drop_add1<T, RES>(x[i], RES ? res[i] : x[i], (uint32_t)i, d);
}

template <class T>
int launch(const T* x, const T* res, T* out, int64_t n, double rate,
           uint32_t seed, uint32_t threshold, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n >= ((int64_t)1 << 32) || rate == 0.0)
    return (int)cudaErrorInvalidValue;  // the wrapper refuses both
  hash_rng::Dropout d = hash_rng::make_dropout(rate, seed, threshold);
  // the reference scales by inv_keep in x's dtype
  d.inv_keep = to_f32(from_f32<T>(d.inv_keep));
  constexpr int V = kVec<T>;
  const int vec = ((reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(res) |
                    reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const int64_t work = vec ? n / V + n % V : n;
  const int blocks = (int)std::min<int64_t>((work + NT - 1) / NT,
                                            kMaxBlocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res)
    dropout_kernel<T, true><<<blocks, NT, 0, s>>>(x, res, out, (uint32_t)n,
                                                  vec, d);
  else
    dropout_kernel<T, false><<<blocks, NT, 0, s>>>(x, nullptr, out,
                                                   (uint32_t)n, vec, d);
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
  return launch<float>(g, nullptr, dx, n, rate, seed, threshold, stream);
}

// #16 in bf16 (amp): as ptt_dropout_add, on contiguous bf16 tensors, with
// the reference's bf16 arithmetic.
extern "C" int ptt_dropout_add_bf16(const bf16* x,
                                    const bf16* res,
                                    bf16* out, int64_t n,
                                    double rate, unsigned seed,
                                    unsigned threshold, void* stream) {
  return launch<bf16>(x, res, out, n, rate, seed, threshold,
                               stream);
}

// #17 in bf16.
extern "C" int ptt_dropout_add_bwd_bf16(const bf16* g,
                                        bf16* dx, int64_t n,
                                        double rate, unsigned seed,
                                        unsigned threshold, void* stream) {
  return launch<bf16>(g, nullptr, dx, n, rate, seed, threshold,
                               stream);
}
