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
// Bound: bytes.  The rows are random: a 40-byte row of a D = 10 table
// touches two 32-byte sectors, so both kernels are bound by the sectors
// they touch (chip_smoke.py touched_sectors), not by their few operations
// an element.  Random sectors do not stream at the HBM's rate: on the H100
// #23's apply phase reads and writes them at about a third of it (PERF.md
// §6), and every row also sits behind a chain of dependent loads.
//
// #22: the row of each (slot, id) by a few lanes of a warp (5 lanes of a
// float2 each at D = 10, 3 rows a lane; a lane a row at D = 1): each id
// read once, every load of a lane issued before its first store, and a
// warp's stores contiguous.  The grid holds a DeepFM group's 106,496 rows
// in one wave, the TPU kernel's start-all-then-wait-all.
//
// #23.  The TPU kernel applies rows merged beforehand (merge_slot_rows),
// since a duplicate id would be read twice and one update lost.  Here the
// merge is folded into the launch, which is one cooperative launch of two
// phases around a grid barrier:
//
//   A  one block a slot sorts the slot's K <= 4096 ids with their
//      positions in shared memory by a stable LSD radix sort, five bits a
//      pass over the bits of V (ids outside [0, V) sort last as V), marks
//      the runs of equal ids and writes each run's record (id, length,
//      first sorted index and its first positions), the sorted positions
//      and two lists: the runs of up to 32 rows longer than lanes take,
//      and the longer ones.  (Where K exceeds 4096 the caller sorts with
//      torch.sort first and phase A only marks the runs.)  Meanwhile the
//      other blocks prefetch every touched table row and the rows into
//      L2, after the sort blocks' ids have had a head start.
//   B  the runs over the whole card.  A block takes each run of more than
//      32 rows: all its threads copy the rows into shared memory
//      (cp.async, all in flight), then a thread a column adds them.  A
//      warp takes each run of up to 32 rows the same way.  Lanes take
//      each run of up to 5 rows (5 lanes of a float2 each at D = 10, one
//      lane at D = 1), every load of the run and of its param and moments
//      issued before the first add.  So no run waits on its rows one
//      after another: its chain is its record, its rows, its adds.
//
// Each run's rows are summed in their stable order, left to right, one
// rounding an add, then applied once: every touched element has one
// writer, there are no atomics (a repeat gives the same bits), and the
// result is the reference's merge-then-apply.  Every product and sum is
// rounded on its own (__fmul_rn / __fadd_rn, no FMA contraction) and the
// square root and division are IEEE, so the arithmetic is the plain
// twin's operation for operation.  The caller's plan
// (kernels/embedding.py apply_plan) sizes the grid to the co-resident
// blocks and the scratch; the entry point rejects what it cannot run.
//
// The S table pointers (3 S for Adam) reach the kernels by value in one
// __grid_constant__ struct of kMaxSlots entries: no device array to build
// or cache, and the tables are updated in place, so their addresses never
// move.  Index math is 32-bit: the entry points refuse S K D >= 2^31
// (a table's row offset id * D is taken in 64 bits).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <initializer_list>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int NW = NT / 32;
constexpr int kMaxSlots = 64;
// keys a thread of the sort phase holds; a block sorts NT * kItems
constexpr int kItems = 8;
constexpr int kSortMax = NT * kItems;
constexpr int kDigitBits = 5;
constexpr int kDigits = 1 << kDigitBits;
// rows a warp item takes at most (longer runs are block items)
constexpr int kWarpMax = 32;
// a run record: id, rows, first sorted index, the first 5 positions (the
// second half written only for runs of more than one row)
constexpr int kRec = 8;
constexpr int kRecInline = kRec - 3;
// dynamic shared memory of an apply block: the sort's keys and positions
// (kSortMax ints each, a word of padding every 32), the run starts
// (kSortMax + 1 ints), the digit counts (kDigits x NT 16-bit) and the
// scans' warp totals
constexpr int kCountInts = kDigits * NT / 2;
constexpr int kApplySmem =
    4 * (2 * (kSortMax + kSortMax / 32) + kSortMax + 1 + kCountInts + 64);

struct Tables {
  const float* p[kMaxSlots];
};

struct AdamTables {
  float* p[kMaxSlots];
  float* m1[kMaxSlots];
  float* m2[kMaxSlots];
};

// -- #22 ----------------------------------------------------------------------

// Lanes of a gathered row: LPR lanes a row, CPL columns a lane (a float2
// at D = 10), U rows a lane, RPW rows a warp's step apart.
template <int DT>
struct GatherLanes {
  static constexpr int LPR = DT == 10 ? 5 : 1;
  static constexpr int CPL = DT == 10 ? 2 : DT;
  static constexpr int RPW = 32 / LPR;
  static constexpr int U = DT == 10 ? 3 : 1;
};

// A row of the compiled width DT (0: a runtime d, a thread a row): every
// id of the lane read once and every load issued before the first store.
template <int DT>
__global__ void __launch_bounds__(NT)
    gather_kernel(const __grid_constant__ Tables t,
                  const int* __restrict__ ids, float* __restrict__ out,
                  int S, int B, int d, int V) {
  if constexpr (DT == 0) {
    const int i = blockIdx.x * NT + threadIdx.x;
    if (i >= S * B) return;
    const int id = __ldg(ids + i);
    const bool ok = id >= 0 && id < V;
    const float* src = t.p[i / B] + (size_t)(ok ? id : 0) * d;
    for (int j = 0; j < d; ++j) out[i * d + j] = ok ? __ldg(src + j) : 0.f;
  } else {
    using L = GatherLanes<DT>;
    constexpr int C = L::CPL, U = L::U;
    const int lane = threadIdx.x & 31;
    const int sub = lane / L::LPR;
    const int col = (lane - sub * L::LPR) * C;
    const int i0 = (blockIdx.x * NT + threadIdx.x - lane) / 32 * L::RPW * U;
    if (sub >= L::RPW) return;
    int row[U];
    bool ok[U];
    float v[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      row[u] = i0 + u * L::RPW + sub;
      const int id = row[u] < S * B ? __ldg(ids + row[u]) : -1;
      ok[u] = id >= 0 && id < V;
      const float* src = t.p[ok[u] ? row[u] / B : 0] +
                         (size_t)(ok[u] ? id : 0) * DT + col;
      if constexpr (C == 2) {
        const float2 x = ok[u] ? __ldg(reinterpret_cast<const float2*>(src))
                               : make_float2(0.f, 0.f);
        v[u][0] = x.x;
        v[u][1] = x.y;
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) v[u][c] = ok[u] ? __ldg(src + c) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (row[u] >= S * B) continue;
      float* o = out + row[u] * DT + col;
      if constexpr (C == 2)
        *reinterpret_cast<float2*>(o) = make_float2(v[u][0], v[u][1]);
      else
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = v[u][c];
    }
  }
}

// -- #23 ----------------------------------------------------------------------

enum Mode { kAdd = 0, kAdam = 1 };

struct ApplyParams {
  AdamTables t;
  const int* ids;         // [S, K]: raw ids, or (presorted) sorted keys
  const int64_t* order;   // presorted: [S, K] positions; else null
  const float* rows;      // [S, K, D], in the ids' order
  int* rec;               // [S, K, kRec] run records
  int* pos;               // [S, K] sorted positions
  int* mid;               // [S, K] runs a warp takes
  int* lng;               // [S, K] runs a block takes
  int* starts;            // presorted: [S, K + 1] run starts
  int* counts;            // [S, 3]: runs, warp runs, block runs
  int S, K, D, V, bits, sort;
  float scale;
  const float* lr_t;
  float b1, omb1, b2, omb2, eps;
};

// rows a lane item takes at most: all of them in registers
template <int DT>
constexpr int kShortMax = DT == 1 || DT == 10 ? kRecInline : 0;

__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void copies_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Exclusive prefix sum of x over the block's threads in order; *total
// gets the sum.  tot: NW + 1 ints of shared memory.
__device__ __forceinline__ int block_scan(int x, int* tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NW ? tot[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < NW) tot[lane] = wi - w;
    if (lane == NW - 1) tot[NW] = wi;
  }
  __syncthreads();
  // a warp's lanes pass these reads before its next scan's shuffles, and
  // every thread before that scan's first barrier: tot is free after them
  *total = tot[NW];
  return tot[warp] + inc - x;
}

// Shared-memory index of item i of a block's keys or positions: a word of
// padding every 32, so that a thread's run of kItems items is read and
// written without bank conflicts.
__device__ __forceinline__ int pd(int i) { return i + (i >> 5); }

// Stable LSD radix sort of the block's kSortMax (key, value) pairs, the
// thread holding items [kItems t, kItems t + kItems) in k and v; `passes`
// passes of kDigitBits bits.  Each pass ranks a thread's items by digit
// in registers, scans the (digit, thread) counts digit-major, scatters
// the pairs to skey / sval and reads back the thread's slice.
__device__ void radix_sort(int (&k)[kItems], int (&v)[kItems], int passes,
                           int* skey, int* sval, unsigned short* cnt,
                           int* tot) {
  const int t = threadIdx.x;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * kDigitBits;
    // an item's rank among the thread's items of its digit, kept in the
    // high half of its value (positions are below 2^16)
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int d = (k[j] >> shift) & (kDigits - 1);
      int r = 0;
#pragma unroll
      for (int i = 0; i < j; ++i) r += ((k[i] >> shift) & (kDigits - 1)) == d;
      v[j] |= r << 16;
    }
#pragma unroll
    for (int dd = 0; dd < kDigits; ++dd) cnt[dd * NT + t] = 0;
    // the last item of a digit leaves the digit's count
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      cnt[((k[j] >> shift) & (kDigits - 1)) * NT + t] =
          (unsigned short)((v[j] >> 16) + 1);
    __syncthreads();
    // exclusive scan of cnt in place: a thread its kDigits entries, read
    // and written as 16-byte words of 8
    constexpr int W = kDigits / 8;
    uint4* c4 = reinterpret_cast<uint4*>(cnt) + W * t;
    unsigned w[4 * W];
#pragma unroll
    for (int u = 0; u < W; ++u) {
      const uint4 x = c4[u];
      w[4 * u] = x.x;
      w[4 * u + 1] = x.y;
      w[4 * u + 2] = x.z;
      w[4 * u + 3] = x.w;
    }
    int sum = 0;
#pragma unroll
    for (int u = 0; u < 4 * W; ++u) sum += (w[u] & 0xffff) + (w[u] >> 16);
    int total;
    int run = block_scan(sum, tot, &total);
#pragma unroll
    for (int u = 0; u < 4 * W; ++u) {
      const unsigned a = w[u] & 0xffff, b = w[u] >> 16;
      w[u] = (unsigned)run | (unsigned)(run + a) << 16;
      run += a + b;
    }
#pragma unroll
    for (int u = 0; u < W; ++u)
      c4[u] = make_uint4(w[4 * u], w[4 * u + 1], w[4 * u + 2], w[4 * u + 3]);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int d = (k[j] >> shift) & (kDigits - 1);
      const int dst = pd(cnt[d * NT + t] + (v[j] >> 16));
      skey[dst] = k[j];
      sval[dst] = v[j] & 0xffff;
    }
    __syncthreads();
    // (the next pass scatters only after two more barriers)
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      k[j] = skey[pd(t * kItems + j)];
      v[j] = sval[pd(t * kItems + j)];
    }
  }
}

__device__ __forceinline__ int key_of(int id, int V) {
  return id >= 0 && id < V ? id : V;
}

// Phase A for slot s (one block): SORT, the launch sorts the slot's ids
// (else they come sorted, with their positions).
template <int DT, bool SORT>
__device__ void plan_slot(const ApplyParams& P, int s, int passes,
                          int* smem) {
  const int K = P.K, V = P.V, t = threadIdx.x;
  int* skey = smem;
  int* sval = smem + pd(kSortMax);
  int* sstart = smem + 2 * pd(kSortMax);
  unsigned short* cnt =
      reinterpret_cast<unsigned short*>(sstart + kSortMax + 4);
  int* tot = sstart + kSortMax + 4 + kCountInts;
  int* pos = P.pos + s * K;
  // the sorted keys, their positions and the run starts: shared memory
  // when this block sorts, else the caller's sorted keys and scratch
  const int* keys = SORT ? skey : P.ids + s * K;
  const int* posp = SORT ? sval : pos;
  int* starts = SORT ? sstart : P.starts + s * (K + 1);

  // mark the runs, a chunk of kSortMax sorted keys at a time
  int n_runs = 0, n_valid = 0;
  for (int c0 = 0; c0 < K; c0 += kSortMax) {
    // the chunk's keys and positions, read across the threads into shared
    // memory, then a thread's kItems in a row from there
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = c0 + j * NT + t;
      skey[pd(i - c0)] = i < K ? key_of(__ldg(P.ids + s * K + i), V) : V;
      sval[pd(i - c0)] =
          SORT || i >= K ? i : (int)__ldg(P.order + s * K + i);
    }
    __syncthreads();
    int k[kItems], v[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      k[j] = skey[pd(t * kItems + j)];
      v[j] = sval[pd(t * kItems + j)];
    }
    if (SORT) radix_sort(k, v, passes, skey, sval, cnt, tot);
    const int i0 = c0 + t * kItems;
    int prev = -1;
    if (t > 0)
      prev = skey[pd(t * kItems - 1)];
    else if (c0 > 0)
      prev = key_of(__ldg(P.ids + s * K + c0 - 1), V);
    // a start: a valid key unlike the one before; packed with the valid
    // count in the high half
    int flags = 0, packed = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const bool valid = k[j] < V;
      const bool start = valid && k[j] != (j ? k[j - 1] : prev);
      flags |= (int)start << j;
      packed += (int)start + ((int)valid << 16);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = c0 + j * NT + t;
      if (i < K) pos[i] = sval[pd(i - c0)];
    }
    int total;
    int r = n_runs + (block_scan(packed, tot, &total) & 0xffff);
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (flags >> j & 1) starts[r++] = i0 + j;
    // (every read of this chunk's keys came before block_scan's barriers,
    // so the next chunk may be staged)
    n_runs += total & 0xffff;
    n_valid += total >> 16;
  }
  if (t == 0) starts[n_runs] = n_valid;
  __syncthreads();

  // records and the warp and block lists, kSortMax runs at a time; thread
  // t takes runs r0 + j NT + t, and lists its own in j order after the
  // lower threads' (kernels/embedding.py apply_items)
  int n_mid = 0, n_long = 0;
  int* rec = P.rec + s * K * kRec;
  constexpr int smax = kShortMax<DT>;
  for (int r0 = 0; r0 < n_runs; r0 += kSortMax) {
    int cls = 0, packed = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int r = r0 + j * NT + t;
      if (r < n_runs) {
        const int st = starts[r];
        const int n = starts[r + 1] - st;
        int q[kRecInline];
#pragma unroll
        for (int u = 0; u < kRecInline; ++u)
          q[u] = u < n ? posp[SORT ? pd(st + u) : st + u] : 0;
        int4* dst = reinterpret_cast<int4*>(rec + r * kRec);
        dst[0] = make_int4(keys[SORT ? pd(st) : st], n, st, q[0]);
        if (n > 1) dst[1] = make_int4(q[1], q[2], q[3], q[4]);
        const int c = n <= smax ? 0 : n <= kWarpMax ? 1 : 2;
        cls |= c << (2 * j);
        packed += c == 1 ? 1 : c == 2 ? 1 << 16 : 0;
      }
    }
    int total;
    const int ex = block_scan(packed, tot, &total);
    int m = n_mid + (ex & 0xffff), l = n_long + (ex >> 16);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int c = cls >> (2 * j) & 3;
      const int r = r0 + j * NT + t;
      if (c == 1) P.mid[s * K + m++] = r;
      if (c == 2) P.lng[s * K + l++] = r;
    }
    n_mid += total & 0xffff;
    n_long += total >> 16;
  }
  if (t == 0) {
    P.counts[3 * s] = n_runs;
    P.counts[3 * s + 1] = n_mid;
    P.counts[3 * s + 2] = n_long;
  }
}

// g already summed: the update of one element e of slot s's tables.
template <int MODE>
__device__ __forceinline__ void update(const ApplyParams& P, int s,
                                       size_t e, float g, float pv,
                                       float m1v, float m2v) {
  if (MODE == kAdd) {
    P.t.p[s][e] = __fadd_rn(pv, __fmul_rn(P.scale, g));
  } else {
    const float m1n = __fadd_rn(__fmul_rn(P.b1, m1v), __fmul_rn(P.omb1, g));
    const float m2n =
        __fadd_rn(__fmul_rn(P.b2, m2v), __fmul_rn(P.omb2, __fmul_rn(g, g)));
    const float step = __fdiv_rn(__fmul_rn(*P.lr_t, m1n),
                                 __fadd_rn(__fsqrt_rn(m2n), P.eps));
    P.t.p[s][e] = __fsub_rn(pv, step);
    P.t.m1[s][e] = m1n;
    P.t.m2[s][e] = m2n;
  }
}

// A run of n rows staged into `stage` by `lanes` threads (this one
// `lane`), `cap` rows at a time, and summed a column a thread: threads
// lane < D (columns lane, lane + lanes, ...) apply.  sync() is the
// barrier of the `lanes` threads.
template <int MODE, int DT, typename Sync>
__device__ __forceinline__ void staged_run(const ApplyParams& P, int s,
                                           const int* r4, int lane,
                                           int lanes, float* stage,
                                           int cap, Sync sync) {
  const int D = DT > 0 ? DT : P.D;
  const int K = P.K;
  const int id = r4[0], n = r4[1], st = r4[2];
  const float* rows = P.rows + s * K * D;
  const int* pos = P.pos + s * K;
  // the columns' param and moments first: they depend on the id alone
  for (int c0 = 0; c0 < D; c0 += lanes) {
    const int c = c0 + lane;
    const size_t e = (size_t)id * D + c;
    float pv = 0.f, m1v = 0.f, m2v = 0.f, g = 0.f;
    if (c < D) {
      pv = P.t.p[s][e];
      if (MODE == kAdam) {
        m1v = P.t.m1[s][e];
        m2v = P.t.m2[s][e];
      }
    }
    const int w = D - c0 < lanes ? D - c0 : lanes;
    for (int k0 = 0; k0 < n; k0 += cap) {
      const int rn = n - k0 < cap ? n - k0 : cap;
      for (int x = lane; x < rn * w; x += lanes) {
        const int i = x / w;
        const int q = __ldcg(pos + st + k0 + i);
        copy4(stage + x, rows + q * D + c0 + (x - i * w));
      }
      copies_commit();
      copies_wait_all();
      sync();
      if (c < D)
        for (int i = 0; i < rn; ++i) {
          const float v = stage[i * w + lane];
          g = k0 + i == 0 ? v : __fadd_rn(g, v);
        }
      sync();
    }
    if (c < D) update<MODE>(P, s, e, g, pv, m1v, m2v);
  }
}

// The slot of a flat item index x: the largest s with pre[s] <= x.
__device__ __forceinline__ int slot_of(const int* pre, int S, int x) {
  int lo = 0, hi = S - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= x) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The lane items of a compiled width: a run of up to kShortMax<DT> rows
// takes LPR lanes, CPL columns a lane (a float2 at D = 10), RPW runs a
// warp: every load of the run (its rows, param and moments) in flight
// before the first add.  (Two or four runs a lane at once ran slower on
// the H100: PERF.md §6.)
template <int DT>
struct Lanes {
  static constexpr int LPR = DT == 10 ? 5 : 1;
  static constexpr int CPL = DT / LPR;
  static constexpr int RPW = 32 / LPR;
};

template <int C>
struct Cols {
  float v[C];
};

template <int C>
__device__ __forceinline__ Cols<C> load_cols(const float* p) {
  Cols<C> c;
  if constexpr (C == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    c.v[0] = x.x;
    c.v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) c.v[i] = p[i];
  }
  return c;
}

template <int C>
__device__ __forceinline__ void store_cols(float* p, const Cols<C>& c) {
  if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(c.v[0], c.v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) p[i] = c.v[i];
  }
}

// One warp's step over the lane items x0 .. x0 + RPW - 1 (flat (slot,
// run) indices s K + r); runs longer than kShortMax<DT> rows, and indices
// past a slot's runs, are skipped.
template <int MODE, int DT>
__device__ __forceinline__ void lane_runs(const ApplyParams& P,
                                          const int* runs, int x0) {
  using L = Lanes<DT>;
  constexpr int R = kShortMax<DT>, C = L::CPL;
  const int lane = threadIdx.x & 31;
  const int sub = lane / L::LPR;
  const int col = (lane - sub * L::LPR) * C;
  const int K = P.K, x = x0 + sub;
  if (sub >= L::RPW || x >= P.S * K) return;
  const int s = x / K;
  if (x - s * K >= runs[s]) return;
  const int4* r8 = reinterpret_cast<const int4*>(P.rec + x * kRec);
  const int4 a = __ldcg(r8);
  const int n = a.y;
  if (n > R) return;
  const int4 b = n > 1 ? __ldcg(r8 + 1) : a;
  const int q[kRecInline] = {a.w, b.x, b.y, b.z, b.w};
  const size_t e = (size_t)a.x * DT + col;
  Cols<C> pv, m1v, m2v, v[R];
  pv = load_cols<C>(P.t.p[s] + e);
  if (MODE == kAdam) {
    m1v = load_cols<C>(P.t.m1[s] + e);
    m2v = load_cols<C>(P.t.m2[s] + e);
  }
  const float* rows = P.rows + (s * K) * DT + col;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < n) v[i] = load_cols<C>(rows + q[i] * DT);
  Cols<C> po, m1o, m2o;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float g = v[0].v[c];
#pragma unroll
    for (int i = 1; i < R; ++i)
      if (i < n) g = __fadd_rn(g, v[i].v[c]);
    if (MODE == kAdd) {
      po.v[c] = __fadd_rn(pv.v[c], __fmul_rn(P.scale, g));
    } else {
      m1o.v[c] = __fadd_rn(__fmul_rn(P.b1, m1v.v[c]), __fmul_rn(P.omb1, g));
      m2o.v[c] = __fadd_rn(__fmul_rn(P.b2, m2v.v[c]),
                           __fmul_rn(P.omb2, __fmul_rn(g, g)));
      const float step = __fdiv_rn(__fmul_rn(*P.lr_t, m1o.v[c]),
                                   __fadd_rn(__fsqrt_rn(m2o.v[c]), P.eps));
      po.v[c] = __fsub_rn(pv.v[c], step);
    }
  }
  store_cols<C>(P.t.p[s] + e, po);
  if (MODE == kAdam) {
    store_cols<C>(P.t.m1[s] + e, m1o);
    store_cols<C>(P.t.m2[s] + e, m2o);
  }
}

template <int MODE, int DT>
__global__ void __launch_bounds__(NT)
    apply_kernel(const __grid_constant__ ApplyParams P) {
  extern __shared__ __align__(16) int smem[];
  const int S = P.S, K = P.K, D = DT > 0 ? DT : P.D;
  const int t = threadIdx.x;

  // phase A: block s < S plans slot s (the grid holds at least S
  // blocks); the others prefetch the rows phase B reads into L2, once the
  // sort blocks' ids have had 3 us to arrive ahead of that traffic
  const int passes = (P.bits + kDigitBits - 1) / kDigitBits;
  if ((int)blockIdx.x < S) {
    if (P.sort)
      plan_slot<DT, true>(P, blockIdx.x, passes, smem);
    else
      plan_slot<DT, false>(P, blockIdx.x, passes, smem);
  } else {
    __nanosleep(3000);
    const int stride = ((int)gridDim.x - S) * NT;
    for (int x = ((int)blockIdx.x - S) * NT + t; x < S * K; x += stride) {
      const int s = x / K;
      const int id = __ldg(P.ids + x);
      prefetch_l2(P.rows + x * D);
      if (id < 0 || id >= P.V) continue;
      const size_t e = (size_t)id * D;
      prefetch_l2(P.t.p[s] + e);
      prefetch_l2(P.t.p[s] + e + D - 1);
      if (MODE == kAdam) {
        prefetch_l2(P.t.m1[s] + e);
        prefetch_l2(P.t.m1[s] + e + D - 1);
        prefetch_l2(P.t.m2[s] + e);
        prefetch_l2(P.t.m2[s] + e + D - 1);
      }
    }
  }
  cg::this_grid().sync();

  // phase B.  The slots' counts and the prefix sums of their warp and
  // block runs
  int* runs = smem;                     // [S]
  int* pre_mid = smem + kMaxSlots;      // [S + 1]
  int* pre_lng = smem + 2 * kMaxSlots + 1;
  float* stage = reinterpret_cast<float*>(smem + 4 * kMaxSlots);
  if (t < 32) {
    int cm[2], cl[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * t + u;
      cm[u] = s < S ? __ldcg(P.counts + 3 * s + 1) : 0;
      cl[u] = s < S ? __ldcg(P.counts + 3 * s + 2) : 0;
      if (s < S) runs[s] = __ldcg(P.counts + 3 * s);
    }
    int im = cm[0] + cm[1], il = cl[0] + cl[1];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int ym = __shfl_up_sync(0xffffffffu, im, off);
      const int yl = __shfl_up_sync(0xffffffffu, il, off);
      if (t >= off) {
        im += ym;
        il += yl;
      }
    }
    // exclusive prefixes at 2t and 2t + 1; the totals at S
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int s = 2 * t + u;
      if (s < S) {
        pre_mid[s] = im - cm[1] - (u ? 0 : cm[0]);
        pre_lng[s] = il - cl[1] - (u ? 0 : cl[0]);
      }
    }
    if (t == 31) {
      pre_mid[S] = im;
      pre_lng[S] = il;
    }
  }
  __syncthreads();
  const int total_mid = pre_mid[S], total_lng = pre_lng[S];

  // block items: the runs longer than kWarpMax rows
  const int block_cap = (kApplySmem / 4 - 4 * kMaxSlots) / (D < NT ? D : NT);
  for (int x = blockIdx.x; x < total_lng; x += gridDim.x) {
    const int s = slot_of(pre_lng, S, x);
    const int r = __ldcg(P.lng + s * K + (x - pre_lng[s]));
    const int4 a = __ldcg(reinterpret_cast<const int4*>(
        P.rec + (s * K + r) * kRec));
    const int r4[3] = {a.x, a.y, a.z};
    staged_run<MODE, DT>(P, s, r4, t, NT, stage, block_cap,
                         [] { __syncthreads(); });
  }

  // warp items: the runs of kShortMax + 1 .. kWarpMax rows
  {
    const int lane = t & 31, warp = t >> 5;
    const int wcap = (kApplySmem / 4 - 4 * kMaxSlots) / NW;
    const int warp_cap = wcap / (D < 32 ? D : 32);
    float* wstage = stage + warp * wcap;
    for (int x = blockIdx.x * NW + warp; x < total_mid;
         x += gridDim.x * NW) {
      const int s = slot_of(pre_mid, S, x);
      const int r = __ldcg(P.mid + s * K + (x - pre_mid[s]));
      const int4 a = __ldcg(reinterpret_cast<const int4*>(
          P.rec + (s * K + r) * kRec));
      const int r4[3] = {a.x, a.y, a.z};
      staged_run<MODE, DT>(P, s, r4, lane, 32, wstage, warp_cap,
                           [] { __syncwarp(); });
    }
  }

  // lane items: the runs of up to kShortMax rows
  if constexpr (kShortMax<DT> > 0) {
    constexpr int per_warp = Lanes<DT>::RPW;
    for (int x0 = (blockIdx.x * NW + (t >> 5)) * per_warp; x0 < S * K;
         x0 += gridDim.x * NW * per_warp)
      lane_runs<MODE, DT>(P, runs, x0);
  }
}

template <int MODE, int DT>
const void* apply_fn() {
  return (const void*)apply_kernel<MODE, DT>;
}

// The instantiation for (mode, D): D 10 and 1 compiled in, others at
// run time.
const void* apply_for(int mode, int d) {
  if (mode == kAdd)
    return d == 10 ? apply_fn<kAdd, 10>() : d == 1 ? apply_fn<kAdd, 1>()
                                                   : apply_fn<kAdd, 0>();
  return d == 10 ? apply_fn<kAdam, 10>() : d == 1 ? apply_fn<kAdam, 1>()
                                                  : apply_fn<kAdam, 0>();
}

// Raise every instantiation's dynamic shared memory limit (once).
cudaError_t configure() {
  static bool done = false;
  if (done) return cudaSuccess;
  for (int mode = 0; mode < 2; ++mode)
    for (int d : {10, 1, 0}) {
      const cudaError_t err = cudaFuncSetAttribute(
          apply_for(mode, d), cudaFuncAttributeMaxDynamicSharedMemorySize,
          kApplySmem);
      if (err != cudaSuccess) return err;
    }
  done = true;
  return cudaSuccess;
}

// The instantiation's D: 10 where every table and the rows are 8-byte
// aligned (its float2 loads), 1, or 0 (any D at run time).
int instance(int d, const ApplyParams& P) {
  if (d == 1) return 1;
  if (d != 10 || reinterpret_cast<uintptr_t>(P.rows) % 8) return 0;
  for (int s = 0; s < P.S; ++s)
    for (const float* t : {P.t.p[s], P.t.m1[s], P.t.m2[s]})
      if (reinterpret_cast<uintptr_t>(t) % 8) return 0;
  return 10;
}

bool fits_32(int64_t s, int64_t k, int64_t d) {
  return s * k * d < (int64_t)INT32_MAX && s * k * kRec < (int64_t)INT32_MAX;
}

}  // namespace

// #22.  tables: S pointers to contiguous f32 [V, D] tables; ids [S, B]
// int32; out [S, B, D] f32.  S <= 64, S B D < 2^31.
extern "C" int ptt_table_gather(void* const* tables, int S, int64_t V, int D,
                                const int* ids, int B, float* out,
                                void* stream) {
  if (S < 1 || S > kMaxSlots || D < 1 || B < 0 || V < 1 ||
      V > INT32_MAX || !fits_32(S, B, D))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  Tables t = {};
  bool even = D % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  for (int s = 0; s < S; ++s) {
    t.p[s] = static_cast<const float*>(tables[s]);
    even = even && reinterpret_cast<uintptr_t>(tables[s]) % 8 == 0;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = (int)V;
  // blocks of NT threads for `rows` rows taken `per_warp` a warp
  auto blocks = [&](int per_warp) {
    const int warps = (S * B + per_warp - 1) / per_warp;
    return (warps * 32 + NT - 1) / NT;
  };
  using L10 = GatherLanes<10>;
  if (D == 10 && even)
    gather_kernel<10><<<blocks(L10::RPW * L10::U), NT, 0, st>>>(
        t, ids, out, S, B, D, v);
  else if (D == 1)
    gather_kernel<1><<<blocks(32), NT, 0, st>>>(t, ids, out, S, B, D, v);
  else
    gather_kernel<0><<<blocks(32), NT, 0, st>>>(t, ids, out, S, B, D, v);
  return (int)cudaGetLastError();
}

// Blocks of the apply kernel for (mode, D) an SM holds at once (the
// fewer of its instantiation's and the runtime-D one's, which misaligned
// tables take), or minus a CUDA error.
extern "C" int ptt_table_apply_occupancy(int mode, int d) {
  if (mode != kAdd && mode != kAdam) return -(int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return -(int)err;
  int least = NT;
  for (const void* fn : {apply_for(mode, d), apply_for(mode, 0)}) {
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT,
                                                        kApplySmem);
    if (err != cudaSuccess) return -(int)err;
    least = std::min(least, blocks);
  }
  return least;
}

// #23.  mode 0: params[s][id] += scale * (sum of the id's rows); mode 1:
// lazy Adam on params, m1s, m2s with the bias-corrected rate *lr_t (a
// device scalar) and the host-rounded constants b1, 1 - b1, b2, 1 - b2,
// eps.  ids [S, K] int32 and rows [S, K, D] f32 in the callers' order;
// with sort = 0, ids are each slot's keys (ids outside [0, V) as V)
// stably sorted and order [S, K] int64 their positions, else order is
// null and K <= 4096.  bits: the bits of V (the sort's passes); grid: the
// co-resident blocks (at least S); scratch: S (12 K + 4) ints
// (kernels/embedding.py apply_plan).  Tables of one call must be
// distinct buffers; S <= 64.
extern "C" int ptt_table_apply(int mode, void* const* params,
                               void* const* m1s, void* const* m2s, int S,
                               int V, int D, const int* ids,
                               const int64_t* order, const float* rows,
                               int K, int* scratch, int sort, int bits,
                               int grid, float scale, const float* lr_t,
                               float b1, float omb1, float b2, float omb2,
                               float eps, void* stream) {
  if (S < 1 || S > kMaxSlots || D < 1 || K < 0 || V < 1 ||
      V == INT32_MAX || !fits_32(S, K, D) ||
      (mode != kAdd && mode != kAdam) ||
      (mode == kAdam && (!m1s || !m2s || !lr_t)) ||
      (sort ? K > kSortMax || order || (1ll << bits) <= V || bits > 31
            : !order) ||
      grid < S || !scratch)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaSuccess;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  ApplyParams P = {};
  for (int s = 0; s < S; ++s) {
    P.t.p[s] = static_cast<float*>(params[s]);
    if (mode == kAdam) {
      P.t.m1[s] = static_cast<float*>(m1s[s]);
      P.t.m2[s] = static_cast<float*>(m2s[s]);
    }
  }
  const int sk = S * K;
  P.rec = scratch;
  P.pos = P.rec + sk * kRec;
  P.mid = P.pos + sk;
  P.lng = P.mid + sk;
  P.counts = P.lng + sk;
  P.starts = P.counts + 3 * S;
  P.ids = ids;
  P.order = order;
  P.rows = rows;
  P.S = S;
  P.K = K;
  P.D = D;
  P.V = V;
  P.bits = bits;
  P.sort = sort;
  P.scale = scale;
  P.lr_t = lr_t;
  P.b1 = b1;
  P.omb1 = omb1;
  P.b2 = b2;
  P.omb2 = omb2;
  P.eps = eps;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(apply_for(mode, instance(D, P)),
                                    dim3(grid),
                                    dim3(NT), args, (size_t)kApplySmem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
