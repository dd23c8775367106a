// The f32 GEMM of gemm.cuh on its own, for sm_90a: c = A B with the
// operand layouts the fused-projection kernels use, so that its rate can
// be measured at their shapes beside cuBLAS (kernels/gemm.py).  The same
// tile, split-K choice and summation order as inside #1 and #2 + #3 (which
// split their dW products only: `split`); ptt_gemm_typed takes the
// element types of amp's instantiations (bf16 operands or C).

#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm.cuh"

// Floats of the `partials` buffer ptt_gemm needs for an M x N x K product
// on a card of `sms` SMs (0: pass null).
extern "C" int64_t ptt_gemm_partials(int m, int n, int k, int sms) {
  return gemm_partials(m, n, k, sms);
}

// Depth of each slab a split M x N x K product sums in one running f32
// sum on a card of `sms` SMs (K when it does not split).
extern "C" int ptt_gemm_slab(int m, int n, int k, int sms) {
  int slab;
  return gemm_splits(m, n, k, sms, &slab) > 1 ? slab : k;
}

// Shared memory of a GEMM block in bytes.
extern "C" int64_t ptt_gemm_smem() {
  return (int64_t)(GEMM_SMEM * sizeof(float));
}

// Dynamic shared memory of a block of the tensor-core tile (bf16 x bf16
// -> bf16, #1's y) in bytes.
extern "C" int64_t ptt_gemm_tc_smem() { return (int64_t)kGemmTcSmem; }

// c [m, n] (row stride ldc) = A B; with split, over K in slabs as
// gemm_splits cuts them (partials: ptt_gemm_partials floats), else in one
// sum (partials unused).  A(i, k) is a[k * lda + i] when a_kmajor, else
// a[i * lda + k]; B(k, j) is b[k * ldb + j] when b_kmajor, else
// b[j * ldb + k].  A k-major with B not returns cudaErrorInvalidValue (no
// kernel is compiled for it), as do empty shapes.
extern "C" int ptt_gemm(const float* a, int lda, int a_kmajor,
                        const float* b, int ldb, int b_kmajor, float* c,
                        int ldc, int m, int n, int k, float* partials,
                        int sms, int split, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + GT - 1) / GT > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)gemm({a, lda, a_kmajor != 0}, {b, ldb, b_kmajor != 0}, c, ldc,
                   m, n, k, split != 0, partials, sms,
                   static_cast<cudaStream_t>(stream));
}

namespace {

template <class TA, class TB, class TC>
int typed(const void* a, int lda, int a_kmajor, const void* b, int ldb,
          int b_kmajor, void* c, int ldc, int m, int n, int k,
          float* partials, int sms, int split, void* stream) {
  return (int)gemm<TA, TB, TC>(
      {static_cast<const TA*>(a), lda, a_kmajor != 0},
      {static_cast<const TB*>(b), ldb, b_kmajor != 0}, static_cast<TC*>(c),
      ldc, m, n, k, split != 0, partials, sms,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// ptt_gemm with element types: bit 0 of `dtypes` makes A bf16, bit 1 B,
// bit 2 C (f32 otherwise).  Compiled for the element types of amp's
// products: bf16 x bf16 -> f32 (3: the pair's projections) or -> bf16 (7:
// #1's y, dW_out), f32 x bf16 -> bf16 (6: the pair's dx) and bf16 x f32 ->
// bf16 (5: dW_qkv); any other returns cudaErrorInvalidValue (f32
// throughout is ptt_gemm).  7 with A i-major and B k-major (#1's y) runs
// the tensor-core tile, which takes N, K, lda and ldb multiples of 8 and
// 16-byte aligned operands (cudaErrorInvalidValue otherwise).
extern "C" int ptt_gemm_typed(int dtypes, const void* a, int lda,
                              int a_kmajor, const void* b, int ldb,
                              int b_kmajor, void* c, int ldc, int m, int n,
                              int k, float* partials, int sms, int split,
                              void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + GT - 1) / GT > 65535)
    return (int)cudaErrorInvalidValue;
  switch (dtypes) {
    case 3:
      return typed<bf16, bf16, float>(a, lda, a_kmajor, b, ldb, b_kmajor, c,
                                      ldc, m, n, k, partials, sms, split,
                                      stream);
    case 5:
      return typed<bf16, float, bf16>(a, lda, a_kmajor, b, ldb, b_kmajor, c,
                                      ldc, m, n, k, partials, sms, split,
                                      stream);
    case 6:
      return typed<float, bf16, bf16>(a, lda, a_kmajor, b, ldb, b_kmajor, c,
                                      ldc, m, n, k, partials, sms, split,
                                      stream);
    case 7:
      return typed<bf16, bf16, bf16>(a, lda, a_kmajor, b, ldb, b_kmajor, c,
                                     ldc, m, n, k, partials, sms, split,
                                     stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
