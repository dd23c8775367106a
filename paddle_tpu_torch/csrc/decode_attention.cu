// Flash-decode: single-query attention over a ring cache or a paged block
// pool, f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/decode_attention.py _decode_kernel (ring)
// and _paged_decode_kernel (paged): q [b, h, dh] against the first
// lengths[b] rows of one layer's cache, k/v [b, max_t, h, dh] or pools
// [num_blocks, block_t, h, dh] addressed through table [b, max_blocks],
// at head width dh 64 or 128 (instantiations of their own).
// A sequence with length 0 gets a zero context, as the TPU kernels give
// (their l_safe); lengths clamp to [0, capacity].
//
// Bound: bytes.  Each valid row of k and v read once (4 dh B a head), q,
// the output and the (acc, m, l) partials; a few FLOPs a byte.
//
// The TPU kernel takes one grid step a sequence, all heads at once.  One
// block a (head, sequence) here (this kernel's first version) put 8
// blocks on 132 SMs at b = 1, its time one block's serial latency, and
// streamed at about 0.9 TB/s at b = 64 with nothing staged ahead.  So one
// cooperative launch now spreads the rows that exist over the whole card,
// with the megastep's walk (decode_walk.cuh):
//
//   walk   items of (group of `group` heads, sequence, split of rows),
//          numbered over the rows that exist, block i taking items i,
//          i + grid, ...; each chunk of 16 rows of k and v, and q, staged
//          by 16-byte cp.async a chunk ahead across items; a
//          warp a head, two lanes a row; (acc, m, l) partials to scratch;
//   grid barrier (cooperative_groups);
//   merge  one warp a (sequence, head): the partials in split order.
//
// A paged chunk row reads its table entry a chunk ahead of its copy; the
// table row is not staged.  Blocks have `group` warps (8, 4, 2 or 1; at
// dh 128 a group of 8 heads' ring, 272 KB, exceeds a block's shared
// memory, so 4, 2 or 1), so that a small batch, whose items are few,
// still spreads over many SMs:
// the caller's plan (kernels/decode_attention.py decode_plan) picks the
// group, the split and the co-resident grid, and lays out its shared
// memory for a ring of STAGES chunks.  The entry points return
// cudaErrorInvalidValue for a plan they cannot run, and a refused
// cooperative launch returns its error.  No atomics: a repeated
// call gives the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using ptt::CR;
using ptt::Side;

struct Params {
  const float* q;  // [b, h, dh]
  Side side;
  const int* lengths;
  float* out;   // [b, h, dh]
  float* part;  // [b, ns, h, dh + 4]
  int batch, n_head, split, ns;
  float scale;
};

// chunks in the copy ring (kernels/decode_attention.py DECODE_STAGES; a
// third stage ran no faster on the H100)
constexpr int STAGES = 2;

template <int DH, bool PAGED, int NW>
__global__ void __launch_bounds__(32 * NW)
    decode_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  const ptt::WalkDims D{P.n_head, P.n_head * DH, P.batch, 0};
  const int* pre_s = ptt::walk_phase<DH, PAGED, NW, 32 * NW, STAGES>(
      D, P.side, P.lengths, P.q, P.split, P.ns, P.part, smem, P.scale);
  cg::this_grid().sync();
  ptt::merge_phase<DH, NW, 16>(pre_s, P.part, P.ns, P.batch, P.n_head,
                               P.out);
}

constexpr int kGroups[] = {1, 2, 4, 8};

template <int DH, bool PAGED>
const void* by_group(int group) {
  switch (group) {
    case 1: return (const void*)decode_kernel<DH, PAGED, 1>;
    case 2: return (const void*)decode_kernel<DH, PAGED, 2>;
    case 4: return (const void*)decode_kernel<DH, PAGED, 4>;
    case 8:  // a group of 8 heads of 128 does not fit a block
      if constexpr (DH == 64) return (const void*)decode_kernel<DH, PAGED, 8>;
      return nullptr;
    default: return nullptr;
  }
}

// The instantiation for a plan's head width and group, or nullptr.
const void* kernel_for(bool paged, int dh, int group) {
  if (dh == 64)
    return paged ? by_group<64, true>(group) : by_group<64, false>(group);
  if (dh == 128)
    return paged ? by_group<128, true>(group) : by_group<128, false>(group);
  return nullptr;
}

// Raise an instantiation's dynamic shared memory to `smem` bytes (once a
// size).
cudaError_t configure(bool paged, int dh, int group, int smem) {
  static int configured[2][2][4] = {};
  int g = 0;
  while (kGroups[g] != group) ++g;
  int& done = configured[dh == 128][paged][g];
  if (smem > done) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_for(paged, dh, group),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    done = smem;
  }
  return cudaSuccess;
}

bool plan_ok(const Params& P, int dh, int capacity, int group, int grid,
             int smem) {
  return P.batch >= 1 && P.n_head >= 1 && capacity >= 1 && grid >= 1 &&
         kernel_for(false, dh, group) != nullptr && P.split >= CR &&
         P.split % CR == 0 && P.ns <= ptt::MAX_SPLITS &&
         ptt::walk_floats(dh, group, STAGES, P.n_head, P.batch) <= smem / 4;
}

int launch(Params& P, bool paged, int dh, int capacity, int group, int grid,
           int smem, void* stream) {
  if (P.split < 1) return (int)cudaErrorInvalidValue;
  P.ns = (capacity + P.split - 1) / P.split;
  if (!plan_ok(P, dh, capacity, group, grid, smem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure(paged, dh, group, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(kernel_for(paged, dh, group),
                                    dim3(grid), dim3(32 * group), args,
                                    (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the (paged) kernel of head width dh and `group` warps an SM
// holds at once with `smem` bytes of dynamic shared memory, or minus a
// CUDA error.
extern "C" int ptt_flash_decode_occupancy(int paged, int dh, int group,
                                          int smem) {
  const void* fn = kernel_for(paged, dh, group);
  if (!fn) return -(int)cudaErrorInvalidValue;
  cudaError_t err = configure(paged, dh, group, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                      32 * group, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// q/out [b, n_head, dh]; k/v [b, max_t, n_head, dh]; lengths [b] int32;
// scratch [b, ceil(max_t / split), n_head, dh + 4] floats; dh 64 or 128.
// The plan's integers follow the widths.
extern "C" int ptt_flash_decode(const float* q, const float* k,
                                const float* v, const int* lengths,
                                float* out, float* scratch, int batch,
                                int max_t, int n_head, int dh, int group,
                                int grid, int split, int smem, float scale,
                                void* stream) {
  Params P{q, Side{k, v, nullptr, max_t, 0, 0}, lengths, out, scratch,
           batch, n_head, split, 0, scale};
  return launch(P, false, dh, max_t, group, grid, smem, stream);
}

// q/out [b, n_head, dh]; pools [num_blocks, block_t, n_head, dh] (one
// layer's slice); table [b, max_blocks] int32 pool block ids; lengths [b];
// scratch [b, ceil(max_blocks * block_t / split), n_head, dh + 4] floats.
extern "C" int ptt_flash_decode_paged(
    const float* q, const float* k_pool, const float* v_pool,
    const int* table, const int* lengths, float* out, float* scratch,
    int batch, int n_head, int dh, int num_blocks, int block_t,
    int max_blocks, int group, int grid, int split, int smem, float scale,
    void* stream) {
  if (block_t < 1 || max_blocks < 1) return (int)cudaErrorInvalidValue;
  const Side side{k_pool, v_pool, table, max_blocks, num_blocks, block_t};
  Params P{q, side, lengths, out, scratch, batch, n_head, split, 0, scale};
  return launch(P, true, dh, max_blocks * block_t, group, grid, smem,
                stream);
}
