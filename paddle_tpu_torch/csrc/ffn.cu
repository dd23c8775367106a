// Decode feed-forward epilogue: out = LN3(x + relu(x W_in + b_in) W_out
// + b_out), f32, for sm_90a.
//
// Replaces paddle_tpu/kernels/decode_step.py _ffn_kernel (:383), the
// second launch a layer of the megastep's split-FFN mode, launched after
// the ring megastep (:513) and after the paged one (:889).  The TPU kernel
// does the whole [b, d_model] batch in one grid step with both weight
// matrices resident in VMEM.
//
// Bound: bytes at small batch (the two weight matrices, 8.4 MB at
// Transformer-base widths, against 4 b d_model d_inner FLOPs), f32 FMAs
// at b = 64 (268 MFLOP: 4.0 us against 2.5 us of bytes on the H100).
// Either way every SM has to pull its share of the weights at once: a
// block that waits for one k step's loads at a time reads a round of
// latency per step.  So the kernel is one cooperative launch of one
// block an SM, all co-resident, in phases between cooperative_groups grid
// barriers, each block taking work items in a grid-stride loop (a block
// with none still reaches every barrier):
//
//   P0  at launch every block issues 16-byte cp.async for all the bytes of
//       its first items: its W_in column tile, its x rows and its slice of
//       b_in, LN3's scale and bias and b_out (read by P3 from shared
//       memory, not from DRAM at the end), then the W_out tile of its
//       first P2 item, which does not depend on h and may land during P1.
//   P1  h = relu(x W_in + b_in): items of (ct1 columns of d_inner, rg rows
//       of the batch), each output summed over the whole of d_model by
//       one block.
//   P2  partial[s] = h[:, slab s] W_out[slab s, :], split-K over d_inner.
//       Fused mode (small batch): an item's slab is its own P1 columns,
//       so h never leaves shared memory and no barrier stands between P1
//       and P2.  Split mode: h goes to scratch [b, d_inner]; after a
//       barrier, items of (ks rows of W_out, ct2 columns of d_model, rg
//       rows) stage their h slab by cp.async.cg and write partials
//       [d_inner / ks, b, d_model]: few slabs, few partials.
//   P3  out = x + (sum of the partials in slab order + b_out), each output
//       by `lanes` lanes of one warp (strided slabs, then a butterfly: one
//       fixed order); after a barrier, LN3 in place, a warp a row.
//
// Every output element and every partial is summed by one block in one
// fixed order: no atomics, and a repeated call gives the same bits.  The
// work split is the caller's plan (kernels/decode_step.py ffn_plan); the
// entry point checks it and returns cudaErrorInvalidValue for a plan it
// cannot run, and a refused cooperative launch returns its error.  What
// this launch writes (h, the partials, out) is read back only through L2
// (cp.async.cg, ld.global.cg), after a grid barrier.
//
// A product runs on a patch of 4 rows by 4 columns a thread, the rows
// strided by a quarter of the item's rows so that the 8 rows a warp loads
// at one k fall in 8 distinct bank quads of a row-major tile whose row
// stride is 4 mod 8 floats; the k steps of 4 are split over the groups of
// threads that share a patch, and the groups' sums are added in group
// order through shared memory.
//
// Shared memory (floats, ld(n) = n + 4 + n % 8): the W_in tile d_model
// ld(ct1), the W_out tile (fused: ct1 ld(d_model); split: ks ld(ct2)), the
// item's rows (x: rg ld(d_model); split P2's h slab: rg ld(ks)), fused
// mode's h rg ld(ct1), the group reduction (16 a thread) and the vectors
// (3 d_model + ct1): 225 KB at b = 64 (split, ct1 16, ks 128, ct2 64),
// 103 KB at b = 1 (fused, ct1 16).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int NW = NT / 32;
// floats of the group reduction buffer
constexpr int RED = NT * 16;
// features a lane holds in the layer norm's fast path (d_model <= 512)
constexpr int LNV = 16;

// 16-byte cp.async into shared memory through L2 (.cg): `bytes` (16 or 0)
// of them read from src, the rest zero-filled.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Row stride of a shared tile of n columns: 4 mod 8 floats.
__host__ __device__ __forceinline__ int ld_of(int n) { return n + 4 + n % 8; }

// The caller's work split (ffn_plan).
struct Plan {
  int grid;   // blocks, all co-resident
  int fused;  // 1: an item's P2 slab is its own P1 columns
  int ct1;    // P1: columns of d_inner an item
  int rg;     // batch rows an item, both products
  int ks;     // split P2: rows of W_out a slab
  int ct2;    // split P2: columns of d_model an item
  int lanes;  // P3: lanes summing one output's partials
  int smem;   // dynamic shared memory, bytes
};

struct Params {
  const float* x;
  const float* w_in;
  const float* b_in;
  const float* w_out;
  const float* b_out;
  const float* ln_s;
  const float* ln_b;
  float* out;
  float* h;     // split mode: [b, di]
  float* part;  // [slabs, b, dm]
  int batch, dm, di;
  float eps;
  Plan plan;
  int t1;       // P1 column tiles
  int groups;   // row groups
  int slabs;    // partial slabs
  int c2;       // split P2 column tiles
};

// Start copying rows [r0, r0 + nrows) by columns [c0, c0 + ncols) of a
// row-major matrix (row stride ld) into dst (row stride ldd); rows past
// rmax and columns past cmax (a multiple of 4) are zero-filled.
__device__ void copy_tile(const float* __restrict__ src, int ld, int r0,
                          int nrows, int rmax, int c0, int ncols, int cmax,
                          float* dst, int ldd) {
  const int nq = ncols / 4;
  for (int u = threadIdx.x; u < nrows * nq; u += NT) {
    const int r = u / nq, c = 4 * (u % nq);
    const bool in = r0 + r < rmax && c0 + c < cmax;
    copy16(dst + r * ldd + c, in ? src + (size_t)(r0 + r) * ld + c0 + c : src,
           in ? 16 : 0);
  }
}

// Where a product's outputs go: out[r, c] -> dst[r * ld + c] for c <
// cols; with bias, relu(v + bias[c]) (P1's h), else v.  `pad`: columns
// cols .. of the tile are written as 0 (fused mode's h, whose zero
// columns past d_inner meet W_out's zero-filled rows).
struct Out {
  float* dst;
  int ld;
  const float* bias;
  int cols;
  bool pad;
};

__device__ __forceinline__ void put(const Out& o, int r, int c, float v) {
  if (c < o.cols)
    o.dst[r * o.ld + c] = o.bias ? fmaxf(v + o.bias[c], 0.f) : v;
  else if (o.pad)
    o.dst[r * o.ld + c] = 0.f;
}

// out[r, c] = sum_k A[r, k] W[k, c] for r < nr and c < n, A row-major
// a_s[r * lda + k] over rgp rows (rows past nr may hold anything), W
// row-major w_s[k * ldw + c], K and n multiples of 4.  The product waits
// for the thread's copy groups but the newest one with `keep_newest`
// (a W_out tile still landing), then a barrier, before its k steps.
// Columns go in chunks of up to 4 NT / (rgp / 4); a thread owns
// rows rq + i rgp / 4 (i < 4) by columns 4 cq .. 4 cq + 3 of a chunk and
// sums k steps kb = g, g + kg, ... of its group g in increasing k; the kg
// groups' sums are added in group order through red_s.  Ends with a
// barrier: the outputs, if in shared memory, are visible and the tiles
// free.  (8x8, 8x4 and 4x8 patches, which load fewer float4s a FMA,
// and copies committed in k chunks that the product waits for one by one,
// all ran slower on the H100 at b = 33 and 64.)
__device__ __noinline__ void block_gemm(const float* a_s, int lda,
                                        const float* w_s, int ldw, int K,
                                        int n, int rgp, int nr, float* red_s,
                                        Out o, bool keep_newest) {
  if (keep_newest)
    copies_wait<1>();
  else
    copies_wait<0>();
  __syncthreads();
  const int r4 = rgp / 4;
  int nq = 1;
  while (2 * nq <= n / 4 && 2 * nq * r4 <= NT) nq *= 2;
  const int patches = r4 * nq;
  const int kg = NT / patches;
  const int t = threadIdx.x;
  const int p = t % patches, g = t / patches;
  const int cq = p % nq, rq = p / nq;
  for (int c0 = 0; c0 < n; c0 += 4 * nq) {
    const int cr = min(c0 + 4 * cq, n - 4);  // a column that exists
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int k = 4 * g; k < K; k += 4 * kg) {
      float4 a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(a_s + (rq + i * r4) * lda + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const float4*>(w_s + (k + j) * ldw + cr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][0] += av[j] * w[j].x;
          acc[i][1] += av[j] * w[j].y;
          acc[i][2] += av[j] * w[j].z;
          acc[i][3] += av[j] * w[j].w;
        }
      }
    }
    if (kg == 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rq + i * r4;
        if (r < nr) {
#pragma unroll
          for (int j = 0; j < 4; ++j) put(o, r, c0 + 4 * cq + j, acc[i][j]);
        }
      }
    } else {
      float* dst = red_s + (g * patches + p) * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(dst + 4 * i) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      __syncthreads();
      const int cw = 4 * nq;
      for (int u = t; u < rgp * cw; u += NT) {
        const int r = u / cw, c = u % cw;
        if (r >= nr) continue;
        const int e = (r / r4) * 4 + c % 4;
        const float* src = red_s + ((r % r4) * nq + c / 4) * 16 + e;
        float v = 0.f;
        for (int s = 0; s < kg; ++s) v += src[s * patches * 16];
        put(o, r, c0 + c, v);
      }
    }
    __syncthreads();
  }
}

// P3's sums: out[r, c] = x[r, c] + (sum_s part[s, r, c] + b_out[c]), each
// float4 of outputs by `lanes` consecutive lanes of a warp: lane j sums
// slabs j, j + lanes, ... in order, then a butterfly adds the lanes (the
// same bits in every lane).  Loop bounds are uniform over the warp.
__device__ __forceinline__ void sum_partials(const Params& P,
                                             const float* b_out) {
  const int q4 = P.dm / 4, units = P.batch * q4, lanes = P.plan.lanes;
  const int per_warp = 32 / lanes;
  const int lane = threadIdx.x & 31, sub = lane / lanes, j = lane % lanes;
  const size_t step = (size_t)units;
  const float4* part = reinterpret_cast<const float4*>(P.part);
  const int warps = gridDim.x * NW;
  for (int base = (blockIdx.x * NW + (threadIdx.x >> 5)) * per_warp;
       base < units; base += warps * per_warp) {
    const int u = base + sub;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < units) {
#pragma unroll 4
      for (int s = j; s < P.slabs; s += lanes) {
        const float4 v = __ldcg(part + s * step + u);
        f.x += v.x;
        f.y += v.y;
        f.z += v.z;
        f.w += v.w;
      }
    }
    for (int off = 1; off < lanes; off <<= 1) {
      f.x += __shfl_xor_sync(0xffffffffu, f.x, off);
      f.y += __shfl_xor_sync(0xffffffffu, f.y, off);
      f.z += __shfl_xor_sync(0xffffffffu, f.z, off);
      f.w += __shfl_xor_sync(0xffffffffu, f.w, off);
    }
    if (u < units && j == 0) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(P.x) + u);
      const float4 bo = reinterpret_cast<const float4*>(b_out)[u % q4];
      reinterpret_cast<float4*>(P.out)[u] =
          make_float4(xv.x + (f.x + bo.x), xv.y + (f.y + bo.y),
                      xv.z + (f.z + bo.z), xv.w + (f.w + bo.w));
    }
  }
}

// LN3 of out in place, a warp a row, statistics in f32; ln_s and ln_b in
// shared memory.  Up to 32 * LNV features a lane keeps its shares in
// registers; beyond, each pass reads the row again (every read of an
// element comes before its write).
__device__ __forceinline__ void layer_norm_rows(const Params& P,
                                                const float* ln_s,
                                                const float* ln_b) {
  const int lane = threadIdx.x & 31, n = P.dm;
  for (int r = blockIdx.x * NW + (threadIdx.x >> 5); r < P.batch;
       r += gridDim.x * NW) {
    float* row = P.out + (size_t)r * n;
    if (n <= 32 * LNV) {
      float v[LNV];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < LNV; ++i) {
        const int c = lane + 32 * i;
        v[i] = c < n ? __ldcg(row + c) : 0.f;
        sum += v[i];
      }
      const float mean = ptt::warp_sum(sum) / n;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < LNV; ++i) {
        const float d = lane + 32 * i < n ? v[i] - mean : 0.f;
        sq += d * d;
      }
      const float rstd = rsqrtf(ptt::warp_sum(sq) / n + P.eps);
#pragma unroll
      for (int i = 0; i < LNV; ++i) {
        const int c = lane + 32 * i;
        if (c < n) row[c] = (v[i] - mean) * rstd * ln_s[c] + ln_b[c];
      }
      continue;
    }
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) sum += __ldcg(row + c);
    const float mean = ptt::warp_sum(sum) / n;
    float sq = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float d = __ldcg(row + c) - mean;
      sq += d * d;
    }
    const float rstd = rsqrtf(ptt::warp_sum(sq) / n + P.eps);
    for (int c = lane; c < n; c += 32)
      row[c] = (__ldcg(row + c) - mean) * rstd * ln_s[c] + ln_b[c];
  }
}

// Shared memory floats of the W_out tile of a plan.
__host__ __device__ __forceinline__ int w2_floats(const Plan& pl, int dm) {
  return pl.fused ? pl.ct1 * ld_of(dm) : pl.ks * ld_of(pl.ct2);
}

// Shared memory floats of the item's rows (x, or split P2's h slab).
__host__ __device__ __forceinline__ int rows_floats(const Plan& pl, int dm) {
  const int rgp = pl.rg > 4 ? pl.rg : 4;
  const int ld = pl.fused || ld_of(dm) >= ld_of(pl.ks) ? ld_of(dm)
                                                        : ld_of(pl.ks);
  return rgp * ld;
}

// Shared memory floats of LN3's scale and bias, b_out and an item's
// slice of b_in.
__host__ __device__ __forceinline__ int vec_floats(const Plan& pl, int dm) {
  return 3 * dm + pl.ct1;
}

// Start copying P1's item (its rows r0 .. r0 + nr, columns c0 of
// d_inner): the W_in tile, the x rows and the b_in slice.
__device__ void load_p1(const Params& P, int c0, int r0, int nr, float* w1,
                        float* rows, float* bin) {
  const Plan& pl = P.plan;
  copy_tile(P.w_in, P.di, 0, P.dm, P.dm, c0, pl.ct1, P.di, w1, ld_of(pl.ct1));
  copy_tile(P.x, P.dm, r0, nr, P.batch, 0, P.dm, P.dm, rows, ld_of(P.dm));
  copy_tile(P.b_in, 0, 0, 1, 1, c0, pl.ct1, P.di, bin, 0);
}

// Start copying the W_out tile of P2's item `item` into w2: fused, the
// ct1 rows of P1's item; split, ks rows by ct2 columns.
__device__ void load_w2(const Params& P, int item, float* w2) {
  const Plan& pl = P.plan;
  if (pl.fused) {
    copy_tile(P.w_out, P.dm, item % P.t1 * pl.ct1, pl.ct1, P.di, 0, P.dm, P.dm,
              w2, ld_of(P.dm));
  } else {
    copy_tile(P.w_out, P.dm, item % P.slabs * pl.ks, pl.ks, P.di,
              item / P.slabs % P.c2 * pl.ct2, pl.ct2, P.dm, w2, ld_of(pl.ct2));
  }
}

__global__ void __launch_bounds__(NT, 1)
    ffn_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const Plan& pl = P.plan;
  const int b = P.batch, dm = P.dm, di = P.di;
  const int rgp = pl.rg > 4 ? pl.rg : 4;
  const int ldw1 = ld_of(pl.ct1), ldx = ld_of(dm);
  float* w1 = smem;                          // [dm][ldw1]
  float* w2 = w1 + dm * ldw1;                // W_out tile
  float* rows = w2 + w2_floats(pl, dm);      // x rows, or P2's h slab
  float* hs = rows + rows_floats(pl, dm);    // fused: h [rgp][ldw1]
  float* red = hs + (pl.fused ? rgp * ldw1 : 0);
  float* vec = red + RED;                    // ln_s, ln_b, b_out [dm]
  float* bin = vec + 3 * dm;                 // b_in [ct1] of the item
  const int items1 = P.t1 * P.groups;
  const int items2 = P.slabs * P.c2 * P.groups;

  // P0: the bytes of this block's first items in flight, in two copy
  // groups: the vectors with P1's first item, then the W_out tile
  const int first = blockIdx.x;
  copy_tile(P.ln_s, 0, 0, 1, 1, 0, dm, dm, vec, 0);
  copy_tile(P.ln_b, 0, 0, 1, 1, 0, dm, dm, vec + dm, 0);
  copy_tile(P.b_out, 0, 0, 1, 1, 0, dm, dm, vec + 2 * dm, 0);
  if (first < items1) {
    const int r0 = first / P.t1 * pl.rg;
    load_p1(P, first % P.t1 * pl.ct1, r0, min(pl.rg, b - r0), w1, rows, bin);
  }
  copies_commit();
  if (first < (pl.fused ? items1 : items2)) load_w2(P, first, w2);
  copies_commit();

  // P1 (and fused P2)
  for (int item = first; item < items1; item += gridDim.x) {
    const int tile = item % P.t1;
    const int c0 = tile * pl.ct1, r0 = item / P.t1 * pl.rg;
    const int nr = min(pl.rg, b - r0);
    if (item != first) {
      load_p1(P, c0, r0, nr, w1, rows, bin);
      if (pl.fused) load_w2(P, item, w2);
      copies_commit();
    }
    const Out h_out = pl.fused
                          ? Out{hs, ldw1, bin, di - c0, true}
                          : Out{P.h + (size_t)r0 * di + c0, di, bin,
                                min(pl.ct1, di - c0), false};
    // the first item's W_out tile may still be landing
    block_gemm(rows, ldx, w1, ldw1, dm, pl.ct1, rgp, nr, red, h_out,
               item == first);
    if (pl.fused)
      block_gemm(hs, ldw1, w2, ld_of(dm), pl.ct1, dm, rgp, nr, red,
                 Out{P.part + ((size_t)tile * b + r0) * dm, dm, nullptr, dm,
                     false},
                 false);
  }

  if (!pl.fused) {
    // split P2: partial[slab] = h[:, slab] W_out[slab, tile]
    grid.sync();
    for (int item = first; item < items2; item += gridDim.x) {
      const int slab = item % P.slabs, rest = item / P.slabs;
      const int c0 = rest % P.c2 * pl.ct2, r0 = rest / P.c2 * pl.rg;
      const int nr = min(pl.rg, b - r0);
      if (item != first) load_w2(P, item, w2);
      copy_tile(P.h, di, r0, nr, b, slab * pl.ks, pl.ks, di, rows,
                ld_of(pl.ks));
      copies_commit();
      block_gemm(rows, ld_of(pl.ks), w2, ld_of(pl.ct2), pl.ks, pl.ct2, rgp,
                 nr, red,
                 Out{P.part + ((size_t)slab * b + r0) * dm + c0, dm, nullptr,
                     min(pl.ct2, dm - c0), false},
                 false);
    }
  }
  copies_wait<0>();
  grid.sync();

  // P3: the partials' sums with the residual and b_out, then LN3
  sum_partials(P, vec + 2 * dm);
  grid.sync();
  layer_norm_rows(P, vec, vec + dm);
}

bool tile_ok(int c) {
  return c == 4 || c == 8 || c == 16 || c == 32 || c == 64;
}

bool pow2_in(int v, int lo, int hi) {
  return v >= lo && v <= hi && (v & (v - 1)) == 0;
}

// Shared memory floats the kernel lays out for this plan.
int64_t plan_floats(const Plan& pl, int dm) {
  const int rgp = pl.rg > 4 ? pl.rg : 4;
  return (int64_t)dm * ld_of(pl.ct1) + w2_floats(pl, dm) +
         rows_floats(pl, dm) + (pl.fused ? rgp * ld_of(pl.ct1) : 0) + RED +
         vec_floats(pl, dm);
}

// cudaSuccess if the kernel can run `pl` at these widths.
cudaError_t check_plan(const Plan& pl, int batch, int dm, int di) {
  const bool ok =
      batch >= 1 && dm >= 4 && dm % 4 == 0 && di >= 4 && di % 4 == 0 &&
      pl.grid >= 1 && (pl.fused == 0 || pl.fused == 1) && tile_ok(pl.ct1) &&
      pow2_in(pl.rg, 1, 64) && pow2_in(pl.lanes, 1, 32) &&
      (pl.fused || (pow2_in(pl.ks, 4, 1024) && tile_ok(pl.ct2))) &&
      plan_floats(pl, dm) <= pl.smem / 4;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

// Raise the kernel's dynamic shared memory to `smem` bytes (once a size).
cudaError_t configure(int smem) {
  static int configured = 0;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  return cudaSuccess;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// Blocks of the kernel an SM holds at once with `smem` bytes of dynamic
// shared memory, or minus a CUDA error.
extern "C" int ptt_ffn_occupancy(int smem) {
  cudaError_t err = configure(smem);
  if (err != cudaSuccess) return -(int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ffn_kernel, NT,
                                                      smem);
  return err != cudaSuccess ? -(int)err : blocks;
}

// x/out [b, dm]; w_in [dm, di], b_in [di], w_out [di, dm], b_out, ln_s,
// ln_b [dm].  scratch holds the plan's floats: h [b, di] in split mode,
// then the partials [slabs, b, dm] (slabs: ceil(di / ct1) fused,
// ceil(di / ks) split).  The plan's integers follow the widths.
extern "C" int ptt_ffn(const float* x, const float* w_in, const float* b_in,
                       const float* w_out, const float* b_out,
                       const float* ln_s, const float* ln_b, float* out,
                       float* scratch, int batch, int dm, int di, int grid,
                       int fused, int ct1, int rg, int ks, int ct2,
                       int lanes, int smem, float eps, void* stream) {
  Params P{x, w_in, b_in, w_out, b_out, ln_s, ln_b, out};
  P.batch = batch;
  P.dm = dm;
  P.di = di;
  P.eps = eps;
  P.plan = Plan{grid, fused, ct1, rg, ks, ct2, lanes, smem};
  cudaError_t err = check_plan(P.plan, batch, dm, di);
  if (err != cudaSuccess) return (int)err;
  P.t1 = cdiv(di, ct1);
  P.groups = cdiv(batch, rg);
  P.slabs = fused ? P.t1 : cdiv(di, ks);
  P.c2 = fused ? 1 : cdiv(dm, ct2);
  P.h = scratch;
  P.part = scratch + (fused ? 0 : (size_t)batch * di);
  err = configure(smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)ffn_kernel, dim3(grid),
                                    dim3(NT), args, (size_t)smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
