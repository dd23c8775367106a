// Constants and warp reductions shared by the port's decode kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace ptt {

// score of a masked row (the reference's -1e30)
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace ptt
