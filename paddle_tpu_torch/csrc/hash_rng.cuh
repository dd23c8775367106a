// Counter-based hash PRNG of the dropout masks, as device functions.
//
// The device form of paddle_tpu_torch/kernels/hash_rng.py (itself the
// port's copy of paddle_tpu/kernels/hash_rng.py): a keep bit is a pure
// function of a uint32 seed and a uint32 index,
//
//   keep(i) = mix32(i * GOLDEN + seed) >= threshold,  threshold =
//             round(rate * 2^32)
//
// so a backward kernel regenerates its forward's mask and no mask ever
// reaches device memory.  Every kernel that drops includes this header:
// the dropout-add kernels (#16, #17) key on the flat element index; the
// attention kernels (#1-#4, #6, #7) on (seed, b * H + h, q * Tk + k), the
// head folded into the seed by attn_head_seed and the in-plane index
// hashed by the cheaper mix32_fast, so the fused and the bthd kernels
// draw the same mask for the same element.

#pragma once

#include <stdint.h>

namespace hash_rng {

constexpr uint32_t kGolden = 0x9E3779B9u;  // 2^32 / phi, odd

// lowbias32
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The attention masks' two-round mixer.
__device__ __forceinline__ uint32_t mix32_fast(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  return x;
}

// Keep bit of flat element `idx` of a tensor (keep_mask).
__device__ __forceinline__ bool keep(uint32_t seed, uint32_t idx,
                                     uint32_t threshold) {
  return mix32(idx * kGolden + seed) >= threshold;
}

// Seed of head bh = b * H + h of one attention site.
__device__ __forceinline__ uint32_t attn_head_seed(uint32_t seed,
                                                   uint32_t bh) {
  return mix32(seed + bh * kGolden);
}

// Keep bit of in-plane element q * Tk + k of a head (keep_mask_attn).
__device__ __forceinline__ bool keep_attn(uint32_t head_seed, uint32_t plane,
                                          uint32_t threshold) {
  return mix32_fast(plane * kGolden + head_seed) >= threshold;
}

// One dropout site as a kernel receives it: `on` is false at rate 0,
// where the callers launch the kernel instantiation that never hashes.
struct Dropout {
  uint32_t seed;
  uint32_t threshold;
  float inv_keep;  // 1 / (1 - rate), rounded to f32
  bool on;
};

inline Dropout make_dropout(double rate, uint32_t seed, uint32_t threshold) {
  return Dropout{seed, threshold,
                 rate != 0.0 ? (float)(1.0 / (1.0 - rate)) : 1.f,
                 rate != 0.0};
}

}  // namespace hash_rng
