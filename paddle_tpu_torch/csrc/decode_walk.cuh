// The single-query walk of the port's decode kernels: the megastep's self
// and cross walks (megastep.cu) and flash-decode (decode_attention.cu).
//
// A walk phase takes items of (head group, sequence, split of cache rows),
// numbered over the rows that exist (a prefix sum of the lengths), so that
// every block of a grid gets as many as any other whatever the lengths;
// it stages k, v and q through a cp.async ring that runs on across the
// block's items, scores each row with two lanes and leaves fixed-order
// (acc, m, l) partials.  A merge phase, after a grid barrier, sums each
// (sequence, head)'s partials in split order, a warp a pair.  No atomics:
// a repeated call gives the same bits.
//
// A walk's item takes a group of at most GH heads, one warp a head, in
// blocks of NT threads (GH <= NT / 32; the warps past GH copy but do not
// score).  The head width DH, 64 or 128, is a template parameter: a lane
// holds DH / 32 of a head's context dims (a float2 at 64, a float4 at
// 128) and scores half of a row's DH dims.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "common.cuh"

namespace ptt {

// cache rows a walk stages at once (two lanes a row of a warp)
constexpr int CR = 16;
// floats of one walk partial of head width dh: acc[dh], m, l, padding
__host__ __device__ constexpr int part_floats(int dh) { return dh + 4; }
// walk splits a sequence at most (a merge lane each)
constexpr int MAX_SPLITS = 32;

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

// One cache side.  Ring: k, v [L, b, rows, h, DH].  Paged: pools [L, nb,
// bt, h, DH] and the table [b, rows] of pool block ids.
struct Side {
  const float* k;
  const float* v;
  const int* tab;
  int rows;
  int nb, bt;
};

// What a walk reads of its launch: heads, their width h * DH, the batch
// and the layer of the caches.
struct WalkDims {
  int n_head, hd, batch, layer;
};

template <bool PAGED>
__device__ __forceinline__ int capacity(const Side& s) {
  return PAGED ? s.rows * s.bt : s.rows;
}

// The pool block of row r of sequence seq (paged; 0 for a ring): one
// table read.
template <bool PAGED>
__device__ __forceinline__ int block_of(const Side& s, int seq, int r) {
  if constexpr (PAGED)
    return __ldg(s.tab + (size_t)seq * s.rows + r / s.bt);
  else
    return 0;
}

// Where row r of sequence seq starts, in floats from k (and v), given its
// pool block blk (block_of).
template <bool PAGED>
__device__ __forceinline__ size_t offset_in(const Side& s, int layer,
                                            int batch, int seq, int r,
                                            int blk, int hd) {
  if constexpr (PAGED)
    return (((size_t)layer * s.nb + blk) * s.bt + r % s.bt) * hd;
  else
    return (((size_t)layer * batch + seq) * s.rows + r) * hd;
}

// Where row r of sequence seq starts, in floats from k (and v).  A paged
// row costs one table read and one division.
template <bool PAGED>
__device__ __forceinline__ size_t offset(const Side& s, int layer, int batch,
                                         int seq, int r, int hd) {
  return offset_in<PAGED>(s, layer, batch, seq, r,
                          block_of<PAGED>(s, seq, r), hd);
}

// A sequence's length clamped to [0, capacity].
template <bool PAGED>
__device__ __forceinline__ int valid_rows(const Side& s, const int* lengths,
                                          int seq) {
  return min(max(__ldg(lengths + seq), 0), capacity<PAGED>(s));
}

// Shared memory floats of a walk of head width dh whose items take
// groups of at most g heads: `stages` chunks of k and v rows of a head
// group (8 floats of padding a row), a q row each, and the batch's prefix
// sum of splits.
__host__ __device__ __forceinline__ int walk_floats(int dh, int g, int stages,
                                                    int n_head, int batch) {
  const int gw = (n_head < g ? n_head : g) * dh;
  return stages * (2 * CR * (gw + 8) + gw) + batch + 1;
}

// The DH / 32 context dims a lane holds: a float2 at 64, a float4 at 128.
template <int DH>
struct Lane;
template <>
struct Lane<64> {
  using V = float2;
  __device__ static V zero() { return make_float2(0.f, 0.f); }
  __device__ static void fma(V& a, float p, const V& v) {
    a.x += p * v.x;
    a.y += p * v.y;
  }
  __device__ static V scaled(const V& a, float s) {
    return make_float2(a.x * s, a.y * s);
  }
};
template <>
struct Lane<128> {
  using V = float4;
  __device__ static V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void fma(V& a, float p, const V& v) {
    a.x += p * v.x;
    a.y += p * v.y;
    a.z += p * v.z;
    a.w += p * v.w;
  }
  __device__ static V scaled(const V& a, float s) {
    return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
  }
};

// A walk's contexts from its partials, after a grid barrier: ctx [b, hd],
// one warp a (sequence, head) over the grid's warps (NW a block).  pre_s
// is the walk's prefix sum of splits in this block's shared memory
// (walk_phase's return), so the splits holding rows of sequence seq are
// pre_s[seq + 1] - pre_s[seq], read without a trip to memory.  Lane s <
// those splits reads split s's (m, l); the lane's DH / 32 context dims
// sum the splits in split order (ctx 0 where no split holds a row).  The
// dims of the first PRE splits are loaded with (m, l), before the
// reductions: flash-decode's merge is its kernel's tail, and 16 takes an
// L2 round trip off it; the megastep (PRE 0) measured slower with it.
template <int DH, int NW, int PRE>
__device__ __noinline__ void merge_phase(const int* pre_s, const float* part,
                                         int ns, int batch, int h,
                                         float* ctx) {
  using LV = Lane<DH>;
  using V = typename LV::V;
  constexpr int PART = part_floats(DH);
  const int lane = threadIdx.x & 31;
  const size_t step = (size_t)h * PART;
  for (int pair = blockIdx.x * NW + (threadIdx.x >> 5); pair < batch * h;
       pair += gridDim.x * NW) {
    const int seq = pair / h, head = pair % h;
    const int nvs = pre_s[seq + 1] - pre_s[seq];
    const float* pp = part + ((size_t)seq * ns * h + head) * PART;
    const float m = lane < nvs ? __ldcg(pp + lane * step + DH) : -INFINITY;
    const float l = lane < nvs ? __ldcg(pp + lane * step + DH + 1) : 0.f;
    V a[PRE > 0 ? PRE : 1];
#pragma unroll
    for (int s = 0; s < PRE; ++s)
      a[s] = s < nvs ? __ldcg(reinterpret_cast<const V*>(pp + s * step) + lane)
                     : LV::zero();
    const float mx = warp_max(m);
    const float e = lane < nvs ? expf(m - mx) : 0.f;
    const float total = warp_sum(l * e);
    V acc = LV::zero();
#pragma unroll
    for (int s = 0; s < PRE; ++s) {
      if (s < nvs) {
        const float es = __shfl_sync(0xffffffffu, e, s);
        LV::fma(acc, es, a[s]);
      }
    }
#pragma unroll 8
    for (int s = PRE; s < nvs; ++s) {
      const float es = __shfl_sync(0xffffffffu, e, s);
      const V b = __ldcg(reinterpret_cast<const V*>(pp + s * step) + lane);
      LV::fma(acc, es, b);
    }
    const float inv = nvs ? 1.f / total : 0.f;
    *(reinterpret_cast<V*>(ctx + (size_t)seq * h * DH + head * DH) + lane) =
        LV::scaled(acc, inv);
  }
}

// The online-softmax state of one warp for one head: the lane's DH / 32
// context dims from (DH / 32) lane.
template <int DH>
struct Walk {
  float m, l;
  typename Lane<DH>::V acc;
};

// Where a walk is in a block's items: item `it` (of the phase's list of
// nonempty (head group, sequence, split) triples) and what it stands for,
// its chunk `ch`, `ord`, the block's count of items before it, and `blk`,
// the pool block of this thread's row of the chunk (read one chunk ahead
// of its copy and first used by it, so that the table read is not waited
// on).
struct Cursor {
  int it, seq, grp, sp, ch, ord, blk;
};

// One walk phase, run by every thread of NT-thread blocks.  Its items are
// the (head group, sequence, split) triples whose split holds rows,
// numbered in that order from a prefix sum of the sequences' splits, and
// block i takes items i, i + G, ...: every block gets as many as any
// other, give or take one, whatever the lengths.  Each item's valid rows
// go in chunks of CR, each chunk's k and v rows (the group's heads, at
// most GH of them) and, with an item's first chunk, its q row staged by
// cp.async STAGES - 1 chunks ahead, across items too, by all NT threads;
// warp w < GH walks head w of the group; lanes 2r and 2r + 1 score row r of
// the chunk, each over half of the head's DH dims, and the score is q.k
// times `scale`.  Leaves
// each (sequence, split, head)'s (acc, m, l) in part [b, ns, h, PART] and
// returns the prefix sum of splits in smem that merge_phase reads.
template <int DH, bool PAGED, int GH, int NT, int STAGES>
__device__ __noinline__ const int* walk_phase(const WalkDims& D, const Side& side,
                                        const int* lengths, const float* q,
                                        int split, int ns, float* part,
                                        float* smem, float scale) {
  static_assert(GH * 32 <= NT, "a warp a head of the group");
  using LV = Lane<DH>;
  using V = typename LV::V;
  constexpr int PART = part_floats(DH);
  constexpr int TPR = NT / CR;  // threads copying a chunk row
  const int h = D.n_head, hd = D.hd, b = D.batch;
  const int ng = (h + GH - 1) / GH;
  const int gw = min(h, GH) * DH;
  const int rs = gw + 8;  // conflict-free float4 scores: rs / 4 = 2 mod 8
  const int stage_f = 2 * CR * rs;
  float* q_s = smem + STAGES * stage_f;  // [STAGES][gw]
  int* pre_s = reinterpret_cast<int*>(q_s + STAGES * gw);  // [b + 1]
  const int G = gridDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int crow = lane >> 1, half = lane & 1;
  const int row = t / TPR;  // the chunk row this thread copies

  // pre_s[seq]: the splits holding rows of the sequences before seq
  if (warp == 0) {
    int carry = 0;
    for (int base = 0; base < b; base += 32) {
      const int seq = base + lane;
      const int n =
          seq < b ? (valid_rows<PAGED>(side, lengths, seq) + split - 1) / split
                  : 0;
      int incl = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      if (seq < b) pre_s[seq] = carry + incl - n;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0) pre_s[b] = carry;
  }
  __syncthreads();
  const int per_group = pre_s[b];
  const int items = per_group * ng;

  auto rows_of = [&](const Cursor& c) {
    return min(split, valid_rows<PAGED>(side, lengths, c.seq) - c.sp * split);
  };
  auto first_row = [&](const Cursor& c) {
    return c.sp * split + c.ch * CR + row;
  };
  auto locate = [&](Cursor c) {
    if (c.it < items && row < min(CR, rows_of(c) - c.ch * CR))
      c.blk = block_of<PAGED>(side, c.seq, first_row(c));
    return c;
  };
  auto item_at = [&](int it, int ord) {
    Cursor c{it, 0, 0, 0, 0, ord, 0};
    if (it < items) {
      const int k = it % per_group;
      int lo = 0, hi = b;  // the last seq with pre_s[seq] <= k
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (pre_s[mid] <= k)
          lo = mid;
        else
          hi = mid;
      }
      c.seq = lo;
      c.grp = it / per_group;
      c.sp = k - pre_s[lo];
    }
    return locate(c);
  };
  auto next = [&](const Cursor& c) {
    if ((c.ch + 1) * CR < rows_of(c)) {
      Cursor n = c;
      ++n.ch;
      return locate(n);
    }
    return item_at(c.it + G, c.ord + 1);
  };
  auto issue = [&](const Cursor& c, int st) {
    const int nr = min(CR, rows_of(c) - c.ch * CR);
    const int width = min(GH, h - c.grp * GH) * DH;
    float* ks = smem + st * stage_f;
    float* vs = ks + CR * rs;
    if (row < nr) {
      const size_t off = offset_in<PAGED>(side, D.layer, b, c.seq,
                                          first_row(c), c.blk, hd) +
                         c.grp * gw;
      for (int u = t % TPR; u < width / 4; u += TPR) {
        copy16(ks + row * rs + 4 * u, side.k + off + 4 * u, 16);
        copy16(vs + row * rs + 4 * u, side.v + off + 4 * u, 16);
      }
    }
    if (c.ch == 0 && t < width / 4)
      copy16(q_s + (c.ord % STAGES) * gw + 4 * t,
             q + (size_t)c.seq * hd + c.grp * gw + 4 * t, 16);
  };

  Walk<DH> st{-INFINITY, 0.f, LV::zero()};
  Cursor comp = item_at(blockIdx.x, 0);
  Cursor fill = comp;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (fill.it < items) {
      issue(fill, s);
      fill = next(fill);
    }
    copies_commit();
  }
  int stage = 0;
  while (comp.it < items) {
    if (fill.it < items) {
      issue(fill, (stage + STAGES - 1) % STAGES);
      fill = next(fill);
    }
    copies_commit();
    copies_wait<STAGES - 1>();
    __syncthreads();

    const int head = comp.grp * GH + warp;
    const int nr = min(CR, rows_of(comp) - comp.ch * CR);
    const bool last = (comp.ch + 1) * CR >= rows_of(comp);
    if (warp < GH && head < h) {
      const float* ks = smem + stage * stage_f;
      const float* vs = ks + CR * rs;
      const float* qh = q_s + (comp.ord % STAGES) * gw + warp * DH;
      float d = 0.f;
      if (crow < nr) {
        const float* kr = ks + crow * rs + warp * DH;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const int u = 4 * (2 * j + half);
          const float4 kv = *reinterpret_cast<const float4*>(kr + u);
          const float4 qv = *reinterpret_cast<const float4*>(qh + u);
          d += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      const float s = crow < nr ? d * scale : kMaskValue;
      const float m_new = fmaxf(st.m, warp_max(s));
      const float pe = expf(s - m_new);
      const float alpha = expf(st.m - m_new);
      st.l = st.l * alpha + warp_sum(half ? 0.f : pe);
      st.acc = LV::scaled(st.acc, alpha);
      const float* vp = vs + warp * DH + (DH / 32) * lane;
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float pj = __shfl_sync(0xffffffffu, pe, 2 * r);
        LV::fma(st.acc, pj, *reinterpret_cast<const V*>(vp + r * rs));
      }
      st.m = m_new;
      if (last) {
        // the item's last chunk: its partial, then a fresh state
        float* dst =
            part + (((size_t)comp.seq * ns + comp.sp) * h + head) * PART;
        reinterpret_cast<V*>(dst)[lane] = st.acc;
        if (lane == 0) {
          dst[DH] = st.m;
          dst[DH + 1] = st.l;
        }
        st = Walk<DH>{-INFINITY, 0.f, LV::zero()};
      }
    }
    __syncthreads();  // this stage and q row are free for the next issue
    if (last) {
      comp = item_at(comp.it + G, comp.ord + 1);
    } else {
      ++comp.ch;
    }
    stage = (stage + 1) % STAGES;
  }
  copies_wait<0>();
  return pre_s;
}

}  // namespace ptt
