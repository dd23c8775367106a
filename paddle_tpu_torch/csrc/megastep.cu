// Decode megastep: one decoder layer's attention half for one token, f32,
// for sm_90a, over ring caches or over paged block pools.
//
// Replaces paddle_tpu/kernels/decode_step.py _megastep_kernel (ring) and
// _paged_megastep_kernel (paged), each in its split-FFN mode; the
// feed-forward runs next, in ffn.cu.  For every sequence of the batch:
//
//   1. q, k, v = x @ Wqkv (packed q|k|v columns), q pre-scaled;
//   2. the k/v row is written IN PLACE into the self cache at row pos, for
//      active lanes only;
//   3. online-softmax walk over the first `lengths` rows of the self
//      cache, which includes the row just written;
//   4. x1 = LN1(x + ctx @ Wout);
//   5. cq = x1 @ Wcq, walk over the first `cross_lengths` rows of the
//      cross cache;
//   6. out = LN2(x1 + cctx @ Wcout).
//
// The two layouts differ only in where a row lives (Side::offset) and in
// the row write of step 2: the ring clamps pos into [0, max_t) as a 1-row
// dynamic_update_slice does; the paged write drops a row at or past
// max_blocks * block_t, as the reference's composition
// (paged_scatter_rows) does.
//
// Bound: bytes.  The layer's six h*dh x d_model weight matrices (6.3 MB at
// Transformer-base widths) and the cache rows the walks read (42 MB at
// batch 64 with half-full caches).  The TPU kernel takes one grid step a
// sequence with the weights resident in VMEM; one block a sequence here
// (this kernel's first version) streamed the weights through one SM per
// sequence, 400 MB of L2 traffic at batch 64 and one SM of 132 at batch 1,
// its time one block's serial latency.  So one launch now spreads each
// step of the layer over the whole card: a cooperative grid of one block
// an SM, all co-resident, with cooperative_groups grid barriers between
// the phases, each block taking work items in a grid-stride loop (a block
// with none still reaches every barrier):
//
//   P1  qkv = x Wqkv: (column tile, row group) items; each block stages
//       its W tile by 16-byte cp.async and its x rows transposed, and sums
//       each output over k in a fixed order (k groups, then a fixed
//       reduction); q goes to scratch, k and v straight into the cache
//       row of each active lane.
//   P2  self walk: items of 16 cache rows of a (head group of up to 8
//       heads of 64, or 4 of 128, sequence), numbered over the rows that
//       exist (a prefix sum of the lengths) so that every block gets as
//       many as any other; k and v rows (2 KB a row a group) and q staged
//       through a two-stage cp.async ring that runs on across the block's
//       items; a warp a head, two lanes a row (at head width 128 four of
//       the block's eight warps walk, and all eight copy).  Each item
//       leaves its (m, l, acc) per head in scratch; then the contexts,
//       one warp a (sequence, head), the items merged in order.  The walk
//       and its merge are decode_walk.cuh's, shared with flash-decode
//       (decode_attention.cu).
//   P3  y = ctx Wout: as P1.  Each projection's first W tile is copied a
//       phase ahead (P3's during P1 and P2, P4's during P3, P6's during
//       P4 and P5), so that after a barrier only the rows that phase
//       depends on are waited for.
//   P4  x1 = LN1(x + y), cq = x1 Wcq: as P1; each block recomputes LN1
//       for the rows it uses (one warp a row, one fixed order, so every
//       block holds the same bits); the first column tile stores x1.
//   P5  cross walk and its contexts, as P2.
//   P6  y2 = cctx Wcout, as P3.
//   P7  out = LN2(x1 + y2), a warp a row.
//
// The phases are functions called once each (not inlined), one copy of
// the projection and of the walk: code fetch after an L2 flush costs a
// large kernel several microseconds a phase on the H100.
//
// Every output element and every partial is summed by one block in one
// fixed order: no atomics, and a repeated call gives the same bits.  The
// work split is the caller's plan (kernels/decode_step.py megastep_plan);
// the entry points check it and return cudaErrorInvalidValue for a plan
// they cannot run, and a refused cooperative launch returns its error.
//
// Rows written in P1 are read after a grid barrier through cp.async.cg
// (L2, coherent), and the scratch written by one phase is read by the next
// through ld.global.cg; nothing that this launch writes is read through
// the read-only path or L1.
//
// Shared memory: P3's and P6's W tile, K (ct + 4) floats, then the larger
// of a walk, 2 (2*16 (gw + 8) + gw) floats with gw = dh * min(h, GH) (134
// KB at 8 heads of 64 or 4 of 128), and P1's or P4's W tile with the
// largest A^T and the reduction buffer, K (max(rg, 4) + 4) + 4224 floats:
// 200.5 KB at batch 64 (tiles (32, 32), (16, 16), (32, 8)), 150 KB at
// batch 1, at Transformer-base's widths.  At head width 128 a group of 8
// heads is 1024 floats a row and its walk would need 266 KB, over a
// block's 227 KB: the walk's group is GH = 4 heads there
// (kernels/decode_step.py MEGASTEP_GROUPS).  The kernel is instantiated
// for head widths 64 and 128.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_walk.cuh"

namespace cg = cooperative_groups;

namespace {

using ptt::CR;
using ptt::MAX_SPLITS;
using ptt::Side;
using ptt::capacity;
using ptt::copies_commit;
using ptt::copies_wait;
using ptt::copy16;
using ptt::merge_phase;
using ptt::offset;
using ptt::walk_phase;

constexpr int NT = 256;
constexpr int NW = NT / 32;
// heads a walk item takes at head width dh (a warp each)
__host__ __device__ constexpr int walk_group(int dh) {
  return dh == 64 ? 8 : 4;
}
// walk chunks in the copy ring (STAGES - 1 in flight while one computes;
// three ran no faster on the H100)
constexpr int STAGES = 2;
// floats of a projection's reduction buffer
constexpr int RED = NT * 16;
// floats after it: P1's row-write offsets (64 int64s)
constexpr int AUX = 128;
// features a lane holds in a layer norm's fast path (d_model <= 512)
constexpr int LNV = 16;

// The caller's work split (megastep_plan).
struct Plan {
  int grid;            // blocks, all co-resident
  int ct_qkv, rg_qkv;  // P1's column tile and row group
  int ct_out, rg_out;  // P3's and P6's
  int ct_cq, rg_cq;    // P4's
  int split_self;      // rows of a self-walk split, a multiple of CR
  int split_cross;     // rows of a cross-walk split
  int smem;            // dynamic shared memory, bytes
};

struct Params {
  const float* x;
  const float* wqkv;
  const float* wout;
  const float* ln1s;
  const float* ln1b;
  const float* wcq;
  const float* wcout;
  const float* ln2s;
  const float* ln2b;
  float* self_k;  // the self cache (or pools), written in place
  float* self_v;
  Side self_side, cross_side;
  const int* pos;
  const int* lengths;
  const int* cross_lengths;
  const int* active;
  float* out;
  // scratch: q [b, hd], cq [b, hd], ctx and cctx [b, hd], y [b, dm],
  // y2 [b, dm], x1 [b, dm], the walks' partials [b, splits, h, dh + 4]
  float* q1;
  float* q2;
  float* c1;
  float* c2;
  float* y1;
  float* y2;
  float* x1;
  float* p1;
  float* p2;
  int layer, batch, dm, n_head, hd;
  int ns_self, ns_cross;  // splits a sequence
  float scale, eps;
  Plan plan;
};

// LN(a + r) * s + b over n features by one warp, statistics in f32:
// every caller sums in the same order and gets the same bits.  Feature j
// goes to col[j * stride] (a column of a transposed tile) and row[j],
// where given.  a and r may be this launch's scratch (read through L2).
// Up to 32 * LNV features a lane loads its shares of a, r, s and b at
// once and keeps them; beyond, each pass reads them again.
__device__ __forceinline__ void ln_row(const float* a, const float* r,
                                       const float* __restrict__ s,
                                       const float* __restrict__ b, int n,
                                       float eps, float* col, int stride,
                                       float* row) {
  const int lane = threadIdx.x & 31;
  auto put = [&](int j, float v) {
    if (col) col[j * stride] = v;
    if (row) row[j] = v;
  };
  if (n <= 32 * LNV) {
    float v[LNV], sv[LNV], bv[LNV];
#pragma unroll
    for (int i = 0; i < LNV; ++i) {
      const int j = lane + 32 * i;
      const bool in = j < n;
      v[i] = in ? __ldcg(a + j) + __ldcg(r + j) : 0.f;
      sv[i] = in ? s[j] : 0.f;
      bv[i] = in ? b[j] : 0.f;
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < LNV; ++i) sum += v[i];
    const float mean = ptt::warp_sum(sum) / n;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < LNV; ++i) {
      const float d = lane + 32 * i < n ? v[i] - mean : 0.f;
      sq += d * d;
    }
    const float rstd = rsqrtf(ptt::warp_sum(sq) / n + eps);
#pragma unroll
    for (int i = 0; i < LNV; ++i)
      if (lane + 32 * i < n)
        put(lane + 32 * i, (v[i] - mean) * rstd * sv[i] + bv[i]);
    return;
  }
  float sum = 0.f;
  for (int j = lane; j < n; j += 32) sum += __ldcg(a + j) + __ldcg(r + j);
  const float mean = ptt::warp_sum(sum) / n;
  float sq = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float d = __ldcg(a + j) + __ldcg(r + j) - mean;
    sq += d * d;
  }
  const float rstd = rsqrtf(ptt::warp_sum(sq) / n + eps);
  for (int j = lane; j < n; j += 32)
    put(j, (__ldcg(a + j) + __ldcg(r + j) - mean) * rstd * s[j] + b[j]);
}

// Shared memory floats of a projection item past its W tile: A^T for at
// least 4 rows, the reduction buffer and AUX.
__host__ __device__ __forceinline__ int rows_floats(int k, int rg) {
  return k * ((rg > 4 ? rg : 4) + 4) + RED + AUX;
}

// Shared memory floats of a W tile of ct columns over k.
__host__ __device__ __forceinline__ int tile_floats(int k, int ct) {
  return k * (ct + 4);
}

// Start copying the W tile of ct columns from c0 (zeros past n) into w_s.
__device__ void load_tile(const float* __restrict__ W, int ldw, int K, int N,
                          int ct, int c0, float* w_s) {
  const int nq = ct / 4, wst = ct + 4;
  for (int u = threadIdx.x; u < K * nq; u += NT) {
    const int k = u / nq, c = c0 + 4 * (u % nq);
    copy16(w_s + k * wst + (c - c0), W + (size_t)k * ldw + (c < N ? c : 0),
           c < N ? 16 : 0);
  }
}

// Rows [r0, r0 + nr) of a [*, k] matrix (the input x, or scratch this
// launch wrote) into a_s transposed, a_s[j * lda + r - r0]: a thread a
// float4 at a time, up to eight in flight, consecutive threads on
// consecutive rows.
__device__ __noinline__ void stage_rows_t(const float* src, int k, int r0,
                                          int nr, float* a_s, int lda) {
  const int q4 = k / 4;
#pragma unroll 8
  for (int u = threadIdx.x; u < nr * q4; u += NT) {
    const int r = u % nr, j = 4 * (u / nr);
    const float4 v = __ldcg(
        reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * k + j));
    a_s[j * lda + r] = v.x;
    a_s[(j + 1) * lda + r] = v.y;
    a_s[(j + 2) * lda + r] = v.z;
    a_s[(j + 3) * lda + r] = v.w;
  }
}

// The four projections of a launch.
enum Proj { QKV, OUT, CQ, COUT };

// One projection's shape: out = A W over the batch, W [K, N] (row stride
// ldw), in items of (ct columns, rg rows).
struct Shape {
  const float* W;
  int ldw, K, N, ct, rg;
};

__device__ Shape shape(const Params& P, int which) {
  const Plan& pl = P.plan;
  switch (which) {
    case QKV:
      return Shape{P.wqkv, 3 * P.hd, P.dm, 3 * P.hd, pl.ct_qkv, pl.rg_qkv};
    case OUT:
      return Shape{P.wout, P.dm, P.hd, P.dm, pl.ct_out, pl.rg_out};
    case CQ:
      return Shape{P.wcq, P.hd, P.dm, P.hd, pl.ct_cq, pl.rg_cq};
    default:
      return Shape{P.wcout, P.dm, P.hd, P.dm, pl.ct_out, pl.rg_out};
  }
}

// Start copying this block's first W tile of a projection (its item
// blockIdx.x, if it has one) into w_s, ahead of the phase.
__device__ void prefetch_tile(const Params& P, int which, float* w_s) {
  const Shape sh = shape(P, which);
  const int tiles = (sh.N + sh.ct - 1) / sh.ct;
  if ((int)blockIdx.x < tiles * ((P.batch + sh.rg - 1) / sh.rg))
    load_tile(sh.W, sh.ldw, sh.K, sh.N, sh.ct, (blockIdx.x % tiles) * sh.ct,
              w_s);
}

// One projection phase: out[r, c] = sum_k A[r, k] W[k, c] for r < batch,
// c < N, W tiles in w_s and A^T, the reduction and P1's row offsets in
// a_s.  `prefetched`: the block's first tile is in w_s already (or in
// flight, committed); `ahead` >= 0 starts that projection's first tile
// into ahead_s once this one's is under way.  A is x (QKV), ctx (OUT),
// LN1(x + y) (CQ, which also stores x1) or cctx (COUT), staged
// transposed, a_s[k * lda + r - r0].
//
// A thread sums a patch of 4 rows by 4 columns over the k of its group
// (k = g, g + kg, ...), a float4 of A^T and one of W a k (rows past nr are
// never stored); the groups' sums are added by a butterfly within a warp
// where a warp holds several groups, then over at most 8 slots in order.
// Fixed order throughout.
template <bool PAGED>
__device__ __noinline__ void project(const Params& P, int which, float* w_s,
                                     float* a_s, bool prefetched, int ahead,
                                     float* ahead_s) {
  const Shape sh = shape(P, which);
  const int K = sh.K, N = sh.N, ct = sh.ct, rg = sh.rg;
  const int b = P.batch, hd = P.hd, dm = P.dm;
  const int wst = ct + 4;
  const int rgp = max(rg, 4);
  const int lda = rgp + 4;
  float* red_s = a_s + K * lda;  // [RED]
  long long* woff = reinterpret_cast<long long*>(red_s + RED);  // QKV
  const int nq = ct / 4;
  const int tiles = (N + ct - 1) / ct;
  const int items = tiles * ((b + rg - 1) / rg);
  const int patches = (rgp / 4) * nq;
  const int kg = NT / patches;
  const int live = min(rg, 4);  // rows of a patch that can hold outputs
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int p = t % patches;
  const int g = t / patches;
  const int rq = p / nq, cq = p % nq;
  const int slots = patches >= 32 ? kg : NW;
  const int slot = patches >= 32 ? g : t >> 5;
  if (!prefetched) prefetch_tile(P, which, w_s);
  copies_commit();
  if (ahead >= 0) prefetch_tile(P, ahead, ahead_s);
  copies_commit();
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int c0 = (item % tiles) * ct;
    const int r0 = (item / tiles) * rg;
    const int nr = min(rg, b - r0);
    const bool first = item == (int)blockIdx.x;
    if (!first) {
      load_tile(sh.W, sh.ldw, K, N, ct, c0, w_s);
      copies_commit();
    }
    if (which == QKV) {
      stage_rows_t(P.x, dm, r0, nr, a_s, lda);
      // where each lane's k and v row goes (-1: not written)
      const int r = t;
      if (r < nr) {
        const int pr = __ldg(P.pos + r0 + r);
        long long off = -1;
        if (__ldg(P.active + r0 + r)) {
          if constexpr (PAGED) {
            if (pr >= 0 && pr < capacity<true>(P.self_side))
              off = (long long)offset<true>(P.self_side, P.layer, b, r0 + r,
                                            pr, hd);
          } else {
            off = (long long)offset<false>(
                P.self_side, P.layer, b, r0 + r,
                min(max(pr, 0), P.self_side.rows - 1), hd);
          }
        }
        woff[r] = off;
      }
    } else if (which == CQ) {
      for (int r = t >> 5; r < nr; r += NW) {
        const size_t row = (size_t)(r0 + r) * dm;
        ln_row(P.x + row, P.y1 + row, P.ln1s, P.ln1b, dm, P.eps, a_s + r,
               lda, c0 == 0 ? P.x1 + row : nullptr);
      }
    } else {
      stage_rows_t(which == OUT ? P.c1 : P.c2, hd, r0, nr, a_s, lda);
    }
    if (first)
      copies_wait<1>();  // the ahead copies may stay in flight
    else
      copies_wait<0>();
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = g; k < K; k += kg) {
      const float4 w = *reinterpret_cast<const float4*>(w_s + k * wst + 4 * cq);
      const float4 a = *reinterpret_cast<const float4*>(a_s + k * lda + 4 * rq);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += av[i] * w.x;
        acc[i][1] += av[i] * w.y;
        acc[i][2] += av[i] * w.z;
        acc[i][3] += av[i] * w.w;
      }
    }
    if (patches < 32) {
      // lanes l, l + patches, ... of a warp hold one patch's groups
      for (int off = patches; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (i < live) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
          }
        }
      }
    }
    if (patches >= 32 || lane < patches) {
      float* dst = red_s + (slot * patches + p) * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(dst + 4 * i) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();
    for (int o = t; o < rg * ct; o += NT) {
      const int r = o / ct, c = o % ct;
      if (r >= nr || c0 + c >= N) continue;
      const int po = (r / 4) * nq + c / 4;
      const int e = (r % 4) * 4 + c % 4;
      float v = 0.f;
      for (int s = 0; s < slots; ++s) v += red_s[(s * patches + po) * 16 + e];
      const int row = r0 + r, col = c0 + c;
      if (which == QKV) {
        if (col < hd) {
          P.q1[(size_t)row * hd + col] = v * P.scale;
        } else if (woff[r] >= 0) {
          if (col < 2 * hd)
            P.self_k[woff[r] + col - hd] = v;
          else
            P.self_v[woff[r] + col - 2 * hd] = v;
        }
      } else if (which == CQ) {
        P.q2[(size_t)row * hd + col] = v * P.scale;
      } else {
        (which == OUT ? P.y1 : P.y2)[(size_t)row * dm + col] = v;
      }
    }
    __syncthreads();  // the tiles are free for the next item
  }
}

template <bool PAGED, int DH>
__global__ void __launch_bounds__(NT, 1)
    megastep_kernel(const __grid_constant__ Params P) {
  constexpr int GH = walk_group(DH);
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Plan& pl = P.plan;
  const int hd = P.hd, dm = P.dm, b = P.batch;
  // the walks' view of the launch (q is scaled by the projections)
  const ptt::WalkDims D{P.n_head, hd, b, P.layer};
  // P3's and P6's W tiles, then the walks' space, or P1's and P4's W tile
  // (wa) and the projections' A^T (at)
  float* wb = smem;
  float* rest = wb + tile_floats(hd, pl.ct_out);
  float* wa = rest;
  float* at = wa + tile_floats(dm, max(pl.ct_qkv, pl.ct_cq));

  // P1: qkv; q scaled into scratch, k and v into the self cache row of
  // each active lane; P3's first tile on its way
  project<PAGED>(P, QKV, wa, at, false, OUT, wb);
  grid.sync();

  // P2: the self walk, then its contexts
  const int* pre_s =
      walk_phase<DH, PAGED, GH, NT, STAGES>(D, P.self_side, P.lengths, P.q1,
                                           pl.split_self, P.ns_self, P.p1,
                                           rest, 1.f);
  grid.sync();
  merge_phase<DH, NW, 0>(pre_s, P.p1, P.ns_self, b, P.n_head, P.c1);
  grid.sync();

  // P3: y = ctx Wout; P4's first tile on its way
  project<PAGED>(P, OUT, wb, at, true, CQ, wa);
  grid.sync();

  // P4: x1 = LN1(x + y); cq = x1 Wcq, scaled; P6's first tile on its way
  project<PAGED>(P, CQ, wa, at, true, COUT, wb);
  grid.sync();

  // P5: the cross walk, then its contexts
  pre_s = walk_phase<DH, PAGED, GH, NT, STAGES>(
      D, P.cross_side, P.cross_lengths, P.q2, pl.split_cross, P.ns_cross,
      P.p2, rest, 1.f);
  grid.sync();
  merge_phase<DH, NW, 0>(pre_s, P.p2, P.ns_cross, b, P.n_head, P.c2);
  grid.sync();

  // P6: y2 = cctx Wcout
  project<PAGED>(P, COUT, wb, at, true, -1, nullptr);
  grid.sync();

  // P7: out = LN2(x1 + y2)
  for (int r = blockIdx.x * NW + (threadIdx.x >> 5); r < b;
       r += gridDim.x * NW) {
    const size_t row = (size_t)r * dm;
    ln_row(P.x1 + row, P.y2 + row, P.ln2s, P.ln2b, dm, P.eps, nullptr, 0,
           P.out + row);
  }
}

bool tile_ok(int ct, int rg) {
  if (ct != 4 && ct != 8 && ct != 16 && ct != 32 && ct != 64) return false;
  if (rg < 1 || rg > 64 || (rg & (rg - 1))) return false;
  return ((rg > 4 ? rg : 4) / 4) * (ct / 4) <= NT;
}

// Shared memory floats the kernel lays out for this plan: P3's and P6's W
// tile, then the larger of a walk and P1's or P4's W tile with the
// largest A^T.
int plan_floats(const Plan& pl, int batch, int dm, int n_head, int dh) {
  const int hd = n_head * dh;
  const int at =
      max(max(rows_floats(dm, pl.rg_qkv), rows_floats(hd, pl.rg_out)),
          rows_floats(dm, pl.rg_cq));
  return tile_floats(hd, pl.ct_out) +
         max(ptt::walk_floats(dh, walk_group(dh), STAGES, n_head, batch),
             tile_floats(dm, max(pl.ct_qkv, pl.ct_cq)) + at);
}

// cudaSuccess if the kernel can run `pl` at these widths.
cudaError_t check_plan(const Plan& pl, int batch, int dm, int n_head,
                       int dh) {
  const bool ok = (dh == 64 || dh == 128) && batch >= 1 && dm >= 4 &&
                  dm % 4 == 0 && n_head >= 1 &&
                  pl.grid >= 1 && tile_ok(pl.ct_qkv, pl.rg_qkv) &&
                  tile_ok(pl.ct_out, pl.rg_out) &&
                  tile_ok(pl.ct_cq, pl.rg_cq) && pl.split_self >= CR &&
                  pl.split_self % CR == 0 && pl.split_cross >= CR &&
                  pl.split_cross % CR == 0 &&
                  plan_floats(pl, batch, dm, n_head, dh) <= pl.smem / 4;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// The instantiation of a layout and head width (64 or 128).
const void* kernel_for(bool paged, int dh) {
  if (dh == 64)
    return paged ? (const void*)megastep_kernel<true, 64>
                 : (const void*)megastep_kernel<false, 64>;
  return paged ? (const void*)megastep_kernel<true, 128>
               : (const void*)megastep_kernel<false, 128>;
}

// Raise an instantiation's dynamic shared memory to `smem` bytes (once a
// size).
cudaError_t configure(bool paged, int dh, int smem) {
  static int configured[2][2] = {};
  int& done = configured[paged][dh == 128];
  if (smem > done) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_for(paged, dh), cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    done = smem;
  }
  return cudaSuccess;
}

int64_t splits(int rows, int split) { return (rows + split - 1) / split; }

int launch(Params& P, bool paged, int dh, void* stream) {
  if (P.ns_self > MAX_SPLITS || P.ns_cross > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = check_plan(P.plan, P.batch, P.dm, P.n_head, dh);
  if (err != cudaSuccess) return (int)err;
  err = configure(paged, dh, P.plan.smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(kernel_for(paged, dh), dim3(P.plan.grid),
                                    dim3(NT), args, (size_t)P.plan.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Carve the scratch into Params.
void carve(Params& P, float* scratch) {
  const size_t b = P.batch, hd = P.hd, dm = P.dm, h = P.n_head;
  const size_t part = ptt::part_floats(P.hd / P.n_head);
  P.q1 = scratch;
  P.q2 = P.q1 + b * hd;
  P.c1 = P.q2 + b * hd;
  P.c2 = P.c1 + b * hd;
  P.y1 = P.c2 + b * hd;
  P.y2 = P.y1 + b * dm;
  P.x1 = P.y2 + b * dm;
  P.p1 = P.x1 + b * dm;
  P.p2 = P.p1 + b * P.ns_self * h * part;
}

}  // namespace

// Floats of the scratch a launch at these widths needs, with ns_self and
// ns_cross splits a sequence (ceil(rows / split) of each walk).
extern "C" int64_t ptt_megastep_scratch(int batch, int dm, int n_head,
                                        int dh, int ns_self, int ns_cross) {
  const int64_t b = batch, hd = (int64_t)n_head * dh;
  return 4 * b * hd + 3 * b * dm +
         b * (int64_t)(ns_self + ns_cross) * n_head * ptt::part_floats(dh);
}

// Blocks of the (paged) kernel of head width dh an SM holds at once with
// `smem` bytes of dynamic shared memory, or minus a CUDA error.
extern "C" int ptt_megastep_occupancy(int paged, int dh, int smem) {
  if (dh != 64 && dh != 128) return -(int)cudaErrorInvalidValue;
  cudaError_t err = configure(paged, dh, smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_for(paged, dh), NT, smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// x/out [b, dm]; caches [L, b, max_t|cross_t, n_head, dh], dh 64 or 128;
// the int32 vectors are [b].  cache_k/cache_v are updated in place.
// scratch holds ptt_megastep_scratch floats; the plan's integers follow
// the widths.
extern "C" int ptt_megastep(
    const float* x, const float* wqkv, const float* wout, const float* ln1s,
    const float* ln1b, const float* wcq, const float* wcout,
    const float* ln2s, const float* ln2b, float* cache_k, float* cache_v,
    const float* cross_k, const float* cross_v, const int* pos,
    const int* lengths, const int* cross_lengths, const int* active,
    float* out, float* scratch, int layer, int batch, int dm, int n_head,
    int dh, int max_t, int cross_t, int grid, int ct_qkv, int rg_qkv,
    int ct_out,
    int rg_out, int ct_cq, int rg_cq, int split_self, int split_cross,
    int smem, float scale, float eps, void* stream) {
  Params P{x, wqkv, wout, ln1s, ln1b, wcq, wcout, ln2s, ln2b, cache_k,
           cache_v};
  P.self_side = Side{cache_k, cache_v, nullptr, max_t, 0, 0};
  P.cross_side = Side{cross_k, cross_v, nullptr, cross_t, 0, 0};
  P.pos = pos;
  P.lengths = lengths;
  P.cross_lengths = cross_lengths;
  P.active = active;
  P.out = out;
  P.layer = layer;
  P.batch = batch;
  P.dm = dm;
  P.n_head = n_head;
  P.hd = n_head * dh;
  P.scale = scale;
  P.eps = eps;
  P.plan = Plan{grid,   ct_qkv, rg_qkv,     ct_out,      rg_out,
                ct_cq,  rg_cq,  split_self, split_cross, smem};
  if (max_t < 1 || cross_t < 1 || split_self < 1 || split_cross < 1 ||
      n_head < 1)
    return (int)cudaErrorInvalidValue;
  P.ns_self = (int)splits(max_t, split_self);
  P.ns_cross = (int)splits(cross_t, split_cross);
  carve(P, scratch);
  return launch(P, false, dh, stream);
}

// x/out [b, dm]; pools [L, num_blocks, block_t, n_head, dh] (self) and
// [L, cross_num_blocks, cross_block_t, n_head, dh] (cross); tables
// [b, max_blocks] and [b, cross_max_blocks] of pool block ids; the int32
// vectors are [b].  pool_k/pool_v are updated in place.
extern "C" int ptt_megastep_paged(
    const float* x, const float* wqkv, const float* wout, const float* ln1s,
    const float* ln1b, const float* wcq, const float* wcout,
    const float* ln2s, const float* ln2b, float* pool_k, float* pool_v,
    const float* cross_k, const float* cross_v, const int* pos,
    const int* lengths, const int* cross_lengths, const int* self_table,
    const int* cross_table, const int* active, float* out, float* scratch,
    int layer, int batch, int dm, int n_head, int dh, int num_blocks,
    int block_t, int max_blocks, int cross_num_blocks, int cross_block_t,
    int cross_max_blocks, int grid, int ct_qkv, int rg_qkv, int ct_out,
    int rg_out, int ct_cq, int rg_cq, int split_self, int split_cross,
    int smem, float scale, float eps, void* stream) {
  Params P{x, wqkv, wout, ln1s, ln1b, wcq, wcout, ln2s, ln2b, pool_k,
           pool_v};
  P.self_side =
      Side{pool_k, pool_v, self_table, max_blocks, num_blocks, block_t};
  P.cross_side = Side{cross_k,          cross_v,          cross_table,
                      cross_max_blocks, cross_num_blocks, cross_block_t};
  P.pos = pos;
  P.lengths = lengths;
  P.cross_lengths = cross_lengths;
  P.active = active;
  P.out = out;
  P.layer = layer;
  P.batch = batch;
  P.dm = dm;
  P.n_head = n_head;
  P.hd = n_head * dh;
  P.scale = scale;
  P.eps = eps;
  P.plan = Plan{grid,   ct_qkv, rg_qkv,     ct_out,      rg_out,
                ct_cq,  rg_cq,  split_self, split_cross, smem};
  if (max_blocks < 1 || block_t < 1 || cross_max_blocks < 1 ||
      cross_block_t < 1 || split_self < 1 || split_cross < 1 || n_head < 1)
    return (int)cudaErrorInvalidValue;
  P.ns_self = (int)splits(max_blocks * block_t, split_self);
  P.ns_cross = (int)splits(cross_max_blocks * cross_block_t, split_cross);
  carve(P, scratch);
  return launch(P, true, dh, stream);
}
