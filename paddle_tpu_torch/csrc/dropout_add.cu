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
// Bound: bytes.  #16 reads x and the residual and writes out (12 bytes an
// f32 element, 6 a bf16 one), #17 reads g and writes dx (8, 4).  The hash
// is ~11 integer operations an element, half of #17's bf16 byte time at
// the int32 rate, so the design keeps every load in flight while it
// hashes:
//
// * each thread owns kVecs 16-byte vectors (4 f32 or 8 bf16 lanes) of
//   every operand, a block's vectors NT apart so each load is coalesced,
//   and issues the loads of all of them, and of its next round's, before
//   it hashes a lane: no load waits behind the thread's own arithmetic;
// * the grid is one wave: the card's SM count (cudaDevAttrMultiProcessor-
//   Count) times the kernel's occupancy, fewer where the tensor needs
//   fewer; larger tensors take rounds;
// * the hash input idx * kGolden + seed is formed once a vector and
//   stepped by kGolden a lane (hash_rng::keep's values);
// * loads and stores stream (ld.global.cs / st.global.cs): every byte is
//   read or written once.
// The tail past the last whole vector, and tensors that are not 16-byte
// aligned, go element by element.
//
// bf16 (amp): the reference's body in x's dtype: inv_keep rounded to bf16
// (1/0.9 -> 1.109375), keep ? x * inv_keep : 0 rounded to bf16, then + r
// rounded to bf16, as packed bf16x2 arithmetic (mul.rn.bf16x2,
// add.rn.bf16x2: the exact product and sum rounded once).  The reference
// forms each in f32 and rounds that to bf16; since f32's 24 bits >= 2 * 8
// + 2, that double rounding is innocuous for x and + and the bits are the
// same (tests/test_torch_dropout.py holds the premise over every bf16 x
// and 2^20 sums on the CPU; chip_smoke.py the kernel over every bf16
// pattern of x on the card).  A dropped lane is its product ANDed with a
// zero half-word, +0, as torch.where(keep, x * s, 0) gives, whatever x.
// f32 keeps its arithmetic and bits: one f32 product, one f32 sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

#include "device.cuh"
#include "dtype.cuh"
#include "hash_rng.cuh"

namespace {

using hash_rng::kGolden;

constexpr int NT = 256;
//: 16-byte vectors of each operand a thread owns in a round
constexpr int kVecs = 2;
//: streaming loads and stores (each byte is touched once)
constexpr bool kStream = true;

// One dropout site as the kernels take it.
struct Drop {
  uint32_t seed, threshold;
  float inv_keep;      // f32: 1 / (1 - rate) rounded to f32
  uint32_t inv_keep2;  // bf16: 1 / (1 - rate) rounded to bf16, both halves
};

__device__ __forceinline__ bool kept(uint32_t h, const Drop& d) {
  return hash_rng::mix32(h) >= d.threshold;
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t c;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(c) : "r"(a), "r"(b));
  return c;
}

__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t c;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(c) : "r"(a), "r"(b));
  return c;
}

// One 32-bit word of T lanes (f32: one lane, bf16: two), h the hash input
// of its first lane: keep ? x * inv_keep : 0 (+ r), rounded to T.
template <class T, bool RES>
struct Word;

template <bool RES>
struct Word<float, RES> {
  static constexpr uint32_t kLanes = 1;
  static __device__ __forceinline__ uint32_t drop(uint32_t x, uint32_t r,
                                                  uint32_t h,
                                                  const Drop& d) {
    float o = kept(h, d) ? __uint_as_float(x) * d.inv_keep : 0.f;
    if (RES) o += __uint_as_float(r);
    return __float_as_uint(o);
  }
};

template <bool RES>
struct Word<bf16, RES> {
  static constexpr uint32_t kLanes = 2;
  static __device__ __forceinline__ uint32_t drop(uint32_t x, uint32_t r,
                                                  uint32_t h,
                                                  const Drop& d) {
    const uint32_t keep = (kept(h, d) ? 0x0000FFFFu : 0u) |
                          (kept(h + kGolden, d) ? 0xFFFF0000u : 0u);
    const uint32_t o = bf16x2_mul(x, d.inv_keep2) & keep;
    return RES ? bf16x2_add(o, r) : o;
  }
};

// The 16-byte vector of flat elements from e on, h = e * kGolden + seed.
template <class T, bool RES>
__device__ __forceinline__ uint4 drop16(uint4 x, uint4 r, uint32_t h,
                                        const Drop& d) {
  using W = Word<T, RES>;
  constexpr uint32_t step = W::kLanes * kGolden;
  uint4 o;
  o.x = W::drop(x.x, r.x, h, d);
  o.y = W::drop(x.y, r.y, h + step, d);
  o.z = W::drop(x.z, r.z, h + 2 * step, d);
  o.w = W::drop(x.w, r.w, h + 3 * step, d);
  return o;
}

__device__ __forceinline__ uint4 load16(const uint4* p) {
  return kStream ? __ldcs(p) : *p;
}

__device__ __forceinline__ void store16(uint4* p, uint4 v) {
  if (kStream)
    __stcs(p, v);
  else
    *p = v;
}

__device__ __forceinline__ uint32_t word_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t word_of(bf16 v) {
  return __bfloat16_as_ushort(v);
}
__device__ __forceinline__ void put(float* p, uint32_t w) {
  *p = __uint_as_float(w);
}
__device__ __forceinline__ void put(bf16* p, uint32_t w) {
  *p = __ushort_as_bfloat16(static_cast<unsigned short>(w));
}

// Element i alone (a bf16 element in the low lane of its word).
template <class T, bool RES>
__device__ __forceinline__ void drop_element(const T* x, const T* res,
                                             T* out, uint32_t i,
                                             const Drop& d) {
  put(out + i, Word<T, RES>::drop(word_of(x[i]), RES ? word_of(res[i]) : 0u,
                                  i * kGolden + d.seed, d));
}

// Load this thread's vectors of one round, i + u * NT for u < kVecs,
// those below nv.
template <bool RES>
__device__ __forceinline__ void load_round(const uint4* x, const uint4* res,
                                           uint32_t nv, uint32_t i,
                                           uint4 (&a)[kVecs],
                                           uint4 (&b)[kVecs]) {
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const uint32_t j = i + u * NT;
    if (j < nv) {
      a[u] = load16(x + j);
      if (RES) b[u] = load16(res + j);
    }
  }
}

// out[i] = drop(x[i]) (+ res[i] when RES), i < n; x, res and out 16-byte
// aligned.
template <class T, bool RES>
__global__ void __launch_bounds__(NT)
dropout_kernel(const T* __restrict__ x, const T* __restrict__ res,
               T* __restrict__ out, uint32_t n, Drop d) {
  constexpr uint32_t L = 16 / sizeof(T);
  const uint32_t nv = n / L;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(res);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const uint32_t round = gridDim.x * (NT * kVecs);
  uint32_t i = blockIdx.x * (NT * kVecs) + threadIdx.x;
  uint4 a[kVecs], b[kVecs] = {};
  load_round<RES>(xv, rv, nv, i, a, b);
  for (; i < nv; i += round) {
    // the next round's loads go out before this round's hashes
    uint4 an[kVecs], bn[kVecs] = {};
    load_round<RES>(xv, rv, nv, i + round, an, bn);
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const uint32_t j = i + u * NT;
      if (j < nv)
        store16(ov + j, drop16<T, RES>(a[u], b[u], j * (L * kGolden) +
                                                       d.seed, d));
      a[u] = an[u];
      b[u] = bn[u];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - nv * L)
    drop_element<T, RES>(x, res, out, nv * L + threadIdx.x, d);
}

// The same, element by element (a tensor that is not 16-byte aligned).
template <class T, bool RES>
__global__ void __launch_bounds__(NT)
dropout_elements_kernel(const T* __restrict__ x, const T* __restrict__ res,
                        T* __restrict__ out, uint32_t n, Drop d) {
  for (uint64_t i = blockIdx.x * NT + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * NT)
    drop_element<T, RES>(x, res, out, (uint32_t)i, d);
}

// Blocks of one wave of dropout_kernel<T, RES> (VEC) or of
// dropout_elements_kernel<T, RES> on the current device: its SMs times
// the blocks an SM holds, cached a device.
template <class T, bool RES, bool VEC>
int wave_blocks() {
  static int cache[kMaxDevices] = {};
  return cached_per_device(cache, [](int) {
    int per_sm = 0;
    if (VEC)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dropout_kernel<T, RES>, NT, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dropout_elements_kernel<T, RES>, NT, 0);
    return sm_count() * std::max(per_sm, 1);
  });
}

// f's value rounded to bf16 (to nearest even; f finite), as its 16 bits.
inline uint32_t bf16_bits(float f) {
  uint32_t u;
  memcpy(&u, &f, sizeof u);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) >> 16;
}

template <class T, bool RES>
void launch_kernel(const T* x, const T* res, T* out, uint32_t n,
                   const Drop& d, cudaStream_t s) {
  const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(res) |
                     reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  if (vec) {
    const int64_t nv = n / (16 / sizeof(T));
    const int64_t need = std::max<int64_t>(
        (nv + NT * kVecs - 1) / (NT * kVecs), 1);  // one for the tail
    const int blocks =
        (int)std::min<int64_t>(need, wave_blocks<T, RES, true>());
    dropout_kernel<T, RES><<<blocks, NT, 0, s>>>(x, res, out, n, d);
  } else {
    const int blocks = (int)std::min<int64_t>(
        ((int64_t)n + NT - 1) / NT, wave_blocks<T, RES, false>());
    dropout_elements_kernel<T, RES><<<blocks, NT, 0, s>>>(x, res, out, n,
                                                          d);
  }
}

template <class T>
int launch(const T* x, const T* res, T* out, int64_t n, double rate,
           uint32_t seed, uint32_t threshold, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (n >= ((int64_t)1 << 32) || rate == 0.0)
    return (int)cudaErrorInvalidValue;  // the wrapper refuses both
  const hash_rng::Dropout h = hash_rng::make_dropout(rate, seed, threshold);
  // the reference scales by inv_keep in x's dtype
  const uint32_t s16 = bf16_bits(h.inv_keep);
  const Drop d{seed, threshold, h.inv_keep, s16 | s16 << 16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (res)
    launch_kernel<T, true>(x, res, out, (uint32_t)n, d, s);
  else
    launch_kernel<T, false>(x, nullptr, out, (uint32_t)n, d, s);
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
extern "C" int ptt_dropout_add_bf16(const bf16* x, const bf16* res,
                                    bf16* out, int64_t n, double rate,
                                    unsigned seed, unsigned threshold,
                                    void* stream) {
  return launch<bf16>(x, res, out, n, rate, seed, threshold, stream);
}

// #17 in bf16.
extern "C" int ptt_dropout_add_bwd_bf16(const bf16* g, bf16* dx, int64_t n,
                                        double rate, unsigned seed,
                                        unsigned threshold, void* stream) {
  return launch<bf16>(g, nullptr, dx, n, rate, seed, threshold, stream);
}
