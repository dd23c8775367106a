// Tensor-core building blocks of the bf16 kernels (amp), for sm_90a:
// mma.sync m16n8k16 with bf16 operands and f32 accumulators, ldmatrix
// fragments, 16-byte cp.async with zero fill, and the hi/lo split of an
// f32 value into two bf16s.
//
// Used by the flash forward on tensor cores (flash_tc.cuh, #4 in bf16),
// the cluster route of #1 in bf16 (qkv_attention.cu), gemm.cuh's
// tensor-core tile (#1's y = ctx W_out and the pair's five products) and
// the pair #2 + #3's walks (flash_bwd_tc.cuh).
//
// Fragments of one warp, g = lane / 4, c = lane % 4 (PTX ISA, "Matrix
// fragments for mma.m16n8k16"):
//   A 16x16 (row-major), a[4]: a[0] = A[g][2c..2c+1], a[1] = A[g+8][2c..],
//     a[2] = A[g][2c+8..], a[3] = A[g+8][2c+8..]
//   B 16x8 (k x n), b[2]: b[0] = B[2c..2c+1][g], b[1] = B[2c+8..2c+9][g]
//   C/D 16x8 f32, d[4]: d[0..1] = D[g][2c..2c+1], d[2..3] = D[g+8][2c..]
// Two bf16s share a 32-bit register, the lower column (or k) in the low
// half.  D of two n8 tiles side by side, packed to bf16 pairs, is A of
// one k16 chunk (d of tile 2j gives a[0], a[1]; tile 2j+1 a[2], a[3]), so
// a product's f32 result feeds the next product without shared memory.
//
// Every product of two bf16 values is exact in f32, and the tensor core
// sums them in f32: a product whose operands are bf16 in the reference
// (which computes in f32 on the widened values) is computed here to f32
// summation error.  An f32 operand v is split as v = hi + lo, hi =
// bf16(v), lo = bf16(v - hi) (v - hi is exact in f32): hi + lo is v to
// 2^-16 of |v|, and a product of two split operands is taken as hi hi +
// hi lo + lo hi (the dropped lo lo is under 2^-16 of the product).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace tc {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte cp.async into shared memory: `bytes` (16 or 0) of them read
// from src, the rest zero-filled.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// addresses of matrix i's rows (16 bytes each), and r[i] is this lane's
// pair of it (row g, columns 2c, 2c+1).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// As ldsm4, each matrix transposed: r[i] holds rows 2c, 2c+1 of column g.
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b on one m16n8k16 tile (bf16 operands, f32 accumulators).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The lane's address offsets, in elements of a row-major tile of row
// stride ld, for ldsm4 of the 16x16 block at (r0, c0): matrices (rows
// r0.., cols c0..), (r0 + 8.., c0..), (r0.., c0 + 8..), (r0 + 8.., c0 +
// 8..).  Read so, the block of a row-major A is the A fragment a[0..3];
// with ldsm4_t, the block of a row-major [k][n] B is the B fragments of
// n tiles c0.. (r[0], r[1]) and c0 + 8.. (r[2], r[3]).
__device__ __forceinline__ int frag_offset(int ld, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  return (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + c0 +
         (lane >> 4) * 8;
}

// The lane's offsets for ldsm4 (not transposed) of the 16x16 block at
// (n0, k0) of a row-major [n][k] tile, read as the B operand (B[k][n] =
// tile[n][k]): matrices (n0.., k0..), (n0.., k0 + 8..), (n0 + 8.., k0..),
// (n0 + 8.., k0 + 8..), so r[0], r[1] are the B fragment of n tile n0..
// and r[2], r[3] that of n0 + 8...
__device__ __forceinline__ int frag_offset_nk(int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  return (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}

//: log2(e): the softmaxes run in base 2 (ex2), on scores times kLog2e
constexpr float kLog2e = 1.4426950408889634f;
//: ln(2), to bring a base-2 log back: lse = m2 * kLn2 + log(l)
constexpr float kLn2 = 0.6931471805599453f;

// 2^x by the SFU's ex2.approx.ftz.f32 (relative error under 2^-22; 2^-inf
// = 0), one instruction where expf takes several.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as a bf16 pair (round to nearest even), a in the low
// half.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi = (bf16(a), bf16(b)) and lo = the bf16s of what they leave.
__device__ __forceinline__ void split(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack(a - hf.x, b - hf.y);
}

// The A fragments (hi and lo) of k16 chunk j of a 16-row f32 result held
// as D fragments: tiles 2j and 2j + 1 of d.
__device__ __forceinline__ void split_a(const float (&d0)[4],
                                        const float (&d1)[4],
                                        uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split(d0[0], d0[1], hi[0], lo[0]);
  split(d0[2], d0[3], hi[1], lo[1]);
  split(d1[0], d1[1], hi[2], lo[2]);
  split(d1[2], d1[3], hi[3], lo[3]);
}

}  // namespace tc
}  // namespace
