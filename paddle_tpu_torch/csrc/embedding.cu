// Multi-table embedding kernels of the sparse CTR tier, f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/embedding.py:
//
//   #22  multi_table_gather's kernel (the pallas_call at :229): one launch
//        gathers out[s, b, :] = table_s[ids[s, b], :] for the S same-shape
//        [V, D] tables of a group (DeepFM: 26 x [1000001, 10] and
//        26 x [1000001, 1]).  An id outside [0, V) is never read: its row
//        is zero.
//   #23  _apply_pallas's kernel (the pallas_call at :343), the
//        read-modify-write behind multi_table_scatter_add (table += scale *
//        row; sparse SGD is scale = -lr) and multi_table_sparse_adam (lazy
//        Adam on param, m1 and m2), one launch for the group.
//
// The TPU kernel applies rows merged beforehand (merge_slot_rows), since a
// duplicate id would be read twice and one update lost.  Here the merge is
// folded into #23: the wrapper hands it each slot's ids sorted by a stable
// sort, with the permutation, and the thread at the start of each run of
// equal ids sums the run's rows serially, in the stable order, then
// applies once.  Every touched element thus has one writer, the sum has a
// fixed order (no atomics: a repeat gives the same bits), and the result
// is the reference's merge-then-apply.  Ids outside [0, V), the merged
// form's sentinel V among them, are skipped.  Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction) and the
// square root and division are IEEE, so the arithmetic is the plain
// twin's operation for operation.
//
// The S table pointers (3 S for Adam) reach the kernels by value in one
// struct of kMaxSlots entries: no device array to build or cache, and the
// tables are updated in place, so their addresses never move.
//
// Design: one thread per element (slot, row, column), a grid-stride loop.
// Bound: bytes.  The rows are random: a 40-byte row of a D = 10 table
// touches two 32-byte sectors, so both kernels are bound by the sectors
// they touch, not by coalescing; the walk is a few operations an element.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 256;
constexpr int kMaxBlocks = 132 * 16;
constexpr int kMaxSlots = 64;

struct Tables {
  float* p[kMaxSlots];
};

struct AdamTables {
  float* p[kMaxSlots];
  float* m1[kMaxSlots];
  float* m2[kMaxSlots];
};

int blocks_for(int64_t n) {
  return (int)std::max<int64_t>(
      1, std::min<int64_t>((n + NT - 1) / NT, kMaxBlocks));
}

__global__ void __launch_bounds__(NT)
gather_kernel(Tables t, const int* __restrict__ ids, float* __restrict__ out,
              int S, int B, int D, int64_t V) {
  const int64_t n = (int64_t)S * B * D;
  const int64_t stride = (int64_t)gridDim.x * NT;
  for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const int64_t sb = i / D;
    const int c = (int)(i - sb * D);
    const int s = (int)(sb / B);
    const int id = ids[sb];
    out[i] = (id >= 0 && id < V) ? t.p[s][(int64_t)id * D + c] : 0.f;
  }
}

enum Mode { kAdd = 0, kAdam = 1 };

// sids [S, K]: each slot's ids, stably sorted; order [S, K]: the row of
// rows [S, K, D] each sorted id came from.
template <int MODE>
__global__ void __launch_bounds__(NT)
apply_kernel(AdamTables t, const int* __restrict__ sids,
             const int64_t* __restrict__ order,
             const float* __restrict__ rows, int S, int K, int D, int64_t V,
             float scale, const float* __restrict__ lr_t, float b1,
             float omb1, float b2, float omb2, float eps) {
  const int64_t n = (int64_t)S * K * D;
  const int64_t stride = (int64_t)gridDim.x * NT;
  for (int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x; i < n;
       i += stride) {
    const int64_t sk = i / D;
    const int c = (int)(i - sk * D);
    const int s = (int)(sk / K);
    const int k = (int)(sk - (int64_t)s * K);
    const int id = sids[sk];
    if (id < 0 || id >= V) continue;
    if (k > 0 && sids[sk - 1] == id) continue;  // not the run's first
    const int64_t base = (int64_t)s * K;
    float g = rows[(base + order[sk]) * D + c];
    for (int j = k + 1; j < K && sids[base + j] == id; ++j)
      g = __fadd_rn(g, rows[(base + order[base + j]) * D + c]);
    const int64_t e = (int64_t)id * D + c;
    float* p = t.p[s] + e;
    if (MODE == kAdd) {
      *p = __fadd_rn(*p, __fmul_rn(scale, g));
    } else {
      float* m1 = t.m1[s] + e;
      float* m2 = t.m2[s] + e;
      const float m1n = __fadd_rn(__fmul_rn(b1, *m1), __fmul_rn(omb1, g));
      const float m2n =
          __fadd_rn(__fmul_rn(b2, *m2), __fmul_rn(omb2, __fmul_rn(g, g)));
      const float step = __fdiv_rn(__fmul_rn(*lr_t, m1n),
                                   __fadd_rn(__fsqrt_rn(m2n), eps));
      *p = __fsub_rn(*p, step);
      *m1 = m1n;
      *m2 = m2n;
    }
  }
}

}  // namespace

// #22.  tables: S pointers to contiguous f32 [V, D] tables; ids [S, B]
// int32; out [S, B, D] f32.  S <= 64.
extern "C" int ptt_table_gather(void* const* tables, int S, int64_t V, int D,
                                const int* ids, int B, float* out,
                                void* stream) {
  if (S < 1 || S > kMaxSlots || D < 1 || B < 0 || V < 1 ||
      V > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  Tables t = {};
  for (int s = 0; s < S; ++s) t.p[s] = static_cast<float*>(tables[s]);
  const int64_t n = (int64_t)S * B * D;
  gather_kernel<<<blocks_for(n), NT, 0, static_cast<cudaStream_t>(stream)>>>(
      t, ids, out, S, B, D, V);
  return (int)cudaGetLastError();
}

// #23.  mode 0: params[s][id] += scale * (sum of the id's rows); mode 1:
// lazy Adam on params, m1s, m2s with the bias-corrected rate *lr_t (a
// device scalar) and the host-rounded constants b1, 1 - b1, b2, 1 - b2,
// eps.  sids/order [S, K] (int32 / int64) from a stable sort of each
// slot's ids; rows [S, K, D] f32 in the unsorted order.  Tables of one
// call must be distinct buffers; S <= 64.
extern "C" int ptt_table_apply(int mode, void* const* params,
                               void* const* m1s, void* const* m2s, int S,
                               int64_t V, int D, const int* sids,
                               const int64_t* order, const float* rows,
                               int K, float scale, const float* lr_t,
                               float b1, float omb1, float b2, float omb2,
                               float eps, void* stream) {
  if (S < 1 || S > kMaxSlots || D < 1 || K < 0 || V < 1 || V > INT32_MAX ||
      (mode != kAdd && mode != kAdam) ||
      (mode == kAdam && (!m1s || !m2s || !lr_t)))
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  AdamTables t = {};
  for (int s = 0; s < S; ++s) {
    t.p[s] = static_cast<float*>(params[s]);
    if (mode == kAdam) {
      t.m1[s] = static_cast<float*>(m1s[s]);
      t.m2[s] = static_cast<float*>(m2s[s]);
    }
  }
  const int64_t n = (int64_t)S * K * D;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kAdd)
    apply_kernel<kAdd><<<blocks_for(n), NT, 0, st>>>(
        t, sids, order, rows, S, K, D, V, scale, nullptr, 0.f, 0.f, 0.f,
        0.f, 0.f);
  else
    apply_kernel<kAdam><<<blocks_for(n), NT, 0, st>>>(
        t, sids, order, rows, S, K, D, V, 0.f, lr_t, b1, omb1, b2, omb2,
        eps);
  return (int)cudaGetLastError();
}
