// The f32 GEMM of gemm.cuh on its own, for sm_90a: c = A B with the
// operand layouts the fused-projection kernels use, so that its rate can
// be measured at their shapes beside cuBLAS (kernels/gemm.py).  The same
// tile, split-K choice and summation order as inside #1 and #2 + #3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

// Floats of the `partials` buffer ptt_gemm needs for an M x N x K product
// on a card of `sms` SMs (0: pass null).
extern "C" int64_t ptt_gemm_partials(int m, int n, int k, int sms) {
  return gemm_partials(m, n, k, sms);
}

// c [m, n] (row stride ldc) = A B, split over K where the C tiles alone
// would not fill the card.  A(i, k) is a[k * lda + i] when a_kmajor, else
// a[i * lda + k]; B(k, j) is b[k * ldb + j] when b_kmajor, else
// b[j * ldb + k].  A k-major with B not returns cudaErrorInvalidValue (no
// kernel is compiled for it), as do empty shapes.
extern "C" int ptt_gemm(const float* a, int lda, int a_kmajor,
                        const float* b, int ldb, int b_kmajor, float* c,
                        int ldc, int m, int n, int k, float* partials,
                        int sms, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + GT - 1) / GT > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)gemm({a, lda, a_kmajor != 0}, {b, ldb, b_kmajor != 0}, c, ldc,
                   m, n, k, true, partials, sms,
                   static_cast<cudaStream_t>(stream));
}
