// Element types of the kernels with a bf16 instantiation (amp) that
// compute in f32: f32 and bf16 operands are loaded and converted to f32 on
// their way into shared memory or registers, all arithmetic is f32, and a
// result is rounded to its tensor's type (round to nearest even, as
// PyTorch's .to(bfloat16) rounds) when it is stored.  The tensor-core
// kernels keep bf16 operands as they are (mma.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

// (host and device: a launch rounds dropout's inv_keep on the host)
__host__ __device__ __forceinline__ float to_f32(float v) { return v; }
__host__ __device__ __forceinline__ float to_f32(bf16 v) {
  return __bfloat162float(v);
}

template <class T>
__host__ __device__ __forceinline__ T from_f32(float v);
template <>
__host__ __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__host__ __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive elements at p as f32: one 16-byte load of f32 (p
// 16-byte aligned) or one 8-byte load of bf16 (p 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Store four f32 values at p as T, with the alignment load4 reads.
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Let `kernel` take `bytes` of dynamic shared memory, once (`configured`
// is the launch's own flag).
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace
