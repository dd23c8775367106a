// Reductions shared by the port's decode kernels.
#pragma once

#include <cuda_runtime.h>

namespace ptt {

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

// Sum of v over the whole block; red_s holds one float per warp.  Every
// thread gets the result.  The barrier at its start keeps a later call
// from overwriting red_s before every thread has read this one's total.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red_s) {
  constexpr int NW = NT / 32;
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) total += red_s[w];
  return total;
}

}  // namespace ptt
