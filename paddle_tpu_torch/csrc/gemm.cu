// The GEMMs of gemm.cuh on their own, for sm_90a: c = A B with the
// operand layouts the fused-projection kernels use, so that their rates
// can be measured at their shapes beside cuBLAS (kernels/gemm.py).  The
// same tiles, split-K choice and summation order as inside #1 and #2 + #3
// (which split their dW products only: `split`): ptt_gemm the f32 tile,
// ptt_gemm_typed the tensor-core tile in amp's element types.

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

// Dynamic shared memory of a block of the tensor-core tile in bytes, A
// and B k-major or not and split into hi/lo planes or not (TcTile).
extern "C" int64_t ptt_gemm_tc_smem(int a_kmajor, int b_kmajor, int a_lo,
                                    int b_lo) {
  const int64_t a = a_kmajor ? TC_K * TC_BLD : GT * TC_ALD;
  const int64_t b = b_kmajor ? TC_K * TC_BLD : GT * TC_ALD;
  return TC_STAGES * (a * (a_lo ? 2 : 1) + b * (b_lo ? 2 : 1)) *
         (int64_t)sizeof(bf16);
}

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

template <bool A_KM, bool B_KM, bool A_LO, bool B_LO, class TC>
int typed(TcOperand a, TcOperand b, void* c, int ldc, int m, int n, int k,
          float* partials, int sms, int split, void* stream) {
  return (int)gemm_tc<A_KM, B_KM, A_LO, B_LO, TC>(
      a, b, static_cast<TC*>(c), ldc, m, n, k, split != 0, partials, sms,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

// gemm.cuh's tensor-core tile (amp) with element types: bit 0 of `dtypes`
// makes A bf16, bit 1 B, bit 2 C.  An f32 operand (its bit clear) is held
// as hi/lo bf16 planes, as the pair holds its f32 intermediates: the
// pointer is its hi plane and a_lo (b_lo) the offset of its lo plane in
// elements; an f32 C is f32.  Compiled for the products of #1 and the pair
// in their layouts: 3 (bf16 x bf16 -> f32) with A i-major and B k-major
// (q|k|v = x W_qkv) or i-major (dctx = g W_out^T); 5 (bf16 x planes ->
// bf16) with both k-major (dW_qkv = x^T dqkv); 6 (planes x bf16 -> bf16)
// with both i-major (dx = dqkv W_qkv^T); 7 (bf16 throughout) with A
// i-major and B k-major (y = ctx W_out) or both k-major (dW_out = ctx^T
// g).  Any other returns cudaErrorInvalidValue (f32 throughout is
// ptt_gemm), as does an operand the tile's 16-byte copies cannot take.
extern "C" int ptt_gemm_typed(int dtypes, const void* a, int lda,
                              int a_kmajor, int64_t a_lo, const void* b,
                              int ldb, int b_kmajor, int64_t b_lo, void* c,
                              int ldc, int m, int n, int k, float* partials,
                              int sms, int split, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || (m + GT - 1) / GT > 65535 ||
      (dtypes & 1) != (a_lo == 0) || (dtypes & 2) != 2 * (b_lo == 0))
    return (int)cudaErrorInvalidValue;
  const TcOperand A{static_cast<const bf16*>(a), lda, a_kmajor != 0, a_lo};
  const TcOperand B{static_cast<const bf16*>(b), ldb, b_kmajor != 0, b_lo};
  const int layout = (a_kmajor ? 1 : 0) + (b_kmajor ? 2 : 0);
  switch (dtypes * 4 + layout) {
    case 3 * 4 + 2:
      return typed<false, true, false, false, float>(
          A, B, c, ldc, m, n, k, partials, sms, split, stream);
    case 3 * 4 + 0:
      return typed<false, false, false, false, float>(
          A, B, c, ldc, m, n, k, partials, sms, split, stream);
    case 5 * 4 + 3:
      return typed<true, true, false, true, bf16>(
          A, B, c, ldc, m, n, k, partials, sms, split, stream);
    case 6 * 4 + 0:
      return typed<false, false, true, false, bf16>(
          A, B, c, ldc, m, n, k, partials, sms, split, stream);
    case 7 * 4 + 2:
      return typed<false, true, false, false, bf16>(
          A, B, c, ldc, m, n, k, partials, sms, split, stream);
    case 7 * 4 + 3:
      return typed<true, true, false, false, bf16>(
          A, B, c, ldc, m, n, k, partials, sms, split, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
