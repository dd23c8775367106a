#!/usr/bin/env python3
"""Where the bf16 tensor-core kernels spend their time, on one CUDA card,
at the amp step's shapes (b 32, 8 heads of 64, t 256, d_model 512): #4's
forward (``csrc/flash_tc.cuh``), #1's cluster route
(``qkv_cluster_tc_kernel`` in ``csrc/qkv_attention.cu``), #1's y tile
(``gemm_tc`` in ``csrc/gemm.cuh``), the pair #2 + #3 (its walks in
``csrc/flash_bwd_tc.cuh``, its GEMM stages on ``gemm_tc``) and #6, #7
(the same walks on bf16 rows); and #16, #17 (``csrc/dropout_add.cu``,
no tensor cores) alone with ``dropout``.

    python3 chip_tc_phases.py [dropout | width128]

Builds temporary copies of the sources by ``chip_kernel_copies`` (the
tree is not changed):

* ``clocks``: thread 0 of every block sums ``clock64()`` over each phase
  of its walk (#4: the ring's wait and barrier, the loads issued with the
  bias and s, the softmax, p v, the epilogue; #1: the projection's waits,
  its MMAs, the split and the cluster barrier, the peer copies and their
  barriers, s, the softmax, p v, the epilogue); printed as each phase's
  share of a block's clock, the mean over the blocks.  A phase's clock
  ends when its last instruction issues, so an MMA's latency falls to the
  phase that reads its result;
* #4 with other tiles: 128-row blocks (2 an SM), a third ring stage,
  170 registers (3 blocks an SM); and, for timing only (wrong outputs),
  without s's MMAs, without the exponentials; and without p_lo's MMAs
  (p rounded to one bf16 in p v);
* #1 without p_lo's MMA, and without all three low-half products (q, k,
  v and p each rounded to one bf16);
* y with other rings: 4 and 5 stages of 32 k, 3 and 2 stages of 64 k;
* the pair: its walks' clocks (the ring's wait and barrier, the next
  tile's copies and the bias loads, s and dp, p and ds, the accumulating
  products, the epilogue), and copies without each low half in turn
  (q and k; dctx and v; p; ds; dq | dk | dv, in the dx and dW products),
  and without all of them;
* #6 and #7 in bf16 (their walks on one bf16 plane, in
  ``csrc/flash_attention.cu``): their walks' clocks, copies without p's
  low half (in dv += p^T dO) and without ds's (in dq += ds k and dk +=
  ds^T q), and copies with other tiles (2 blocks an SM, the dq walk in
  128 registers, a third ring stage);
* #16 and #17 (``dropout``, only they): copies with 1, 3 or 4 vectors a
  thread in a round (the tree's kVecs is 2), without the streaming
  hints, and with streaming loads but plain stores; each held to the
  tree's bits on the amp step's [32*256, 512] in bf16 and f32 and timed
  beside the tree after the repo's flush (the L2 left dirty) and after a
  clean one (``cuda_ms(clean=True)``), with the same-bytes
  ``torch.add`` / ``torch.mul`` beside; and the tree's SASS op counts
  (conversions, packed and f32 arithmetic, loads and stores) of each
  ``dropout_kernel`` instantiation;
* ``width128`` (only it): the backward walks at head width 128 with the
  other split of a 16-row group's head columns (``Bw<SPLIT, D>::kCols``
  in ``csrc/flash_bwd_tc.cuh``): #6's and #7's one-plane walks with two
  warps a group (64 columns each, both computing s and dp) and the
  pair's walks with one warp (all 128 columns); each copy's registers,
  spills and stack at 128 beside the tree's (``-Xptxas -v``), its bits
  against the tree's, and its time beside the tree's (alternated tree,
  copy, copy, tree) at the amp step's cross-attention (#6, #7) and
  encoder self-attention (the pair) at 8 heads of 128, d_model 1024.

#4's copies are timed on the cross-attention (pad bias) and the decoder
self-attention (decoder bias) beside the tree's kernel and masked
``F.scaled_dot_product_attention``; #1's on the decoder self-attention
beside the tree's kernel; y's beside the tree's tile and
``torch.matmul``; the pair's on the decoder self-attention beside the
tree's pair, with the profile's split of the tree's pair between its
GEMM stages and its walks (``chip_smoke._pair_stages``); #6's and #7's
on the cross-attention and the decoder self-attention beside the
backward of masked SDPA, at rates 0 and 0.1; all device time only
(``chip_smoke.cuda_ms`` with ``hide_host``).  What the hi/lo split buys:
the tree's o (#4), ctx (#1), dx, dW_qkv, dW_out (the pair) and dq, dk,
dv (#6, #7), and the copies' without the low halves, against the
float64 twin on the same bf16 operands (``error64``: the max abs error
and the share of elements that are not the float64 value rounded to
bf16).  Prints the
card and its power limit, one JSON line per measurement, and last
``{"ok": true}``.  Exits 2 without a card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

import chip_kernel_copies as ck

HERE = os.path.dirname(os.path.abspath(__file__))
#: a per-block sum of clock64() for each of up to 8 phases, and the
#: block's whole clock in slot 9
CLOCKS = """
__device__ long long g_clk[4096 * 10];
#define CLK(i) { const long long c_now = clock64(); \\
  ck_sum[i] += c_now - c_mark; c_mark = c_now; }
"""
CLOCKS_ENTRY = """
extern "C" int ptt_clocks(long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_clk, sizeof(long long) * n);
}
"""
CLOCKS_START = ("  long long ck_sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                "  const long long c_start = clock64();\n"
                "  long long c_mark = c_start;\n")
CLOCKS_END = ("  if (threadIdx.x == 0) {\n"
              "    const int blk = (blockIdx.z * gridDim.y + blockIdx.y) *"
              " gridDim.x + blockIdx.x;\n"
              "    for (int i = 0; i < 8; ++i) g_clk[blk * 10 + i] ="
              " ck_sum[i];\n"
              "    g_clk[blk * 10 + 9] = clock64() - c_start;\n  }\n")
FLASH_PHASES = ("ring wait", "loads, bias and s", "softmax", "p v",
                "epilogue")
QKV_PHASES = ("projection waits", "projection MMAs", "split and cluster "
              "barrier", "peer copies", "s", "softmax", "p v", "epilogue")


def read(name):
    from paddle_tpu_torch.kernels import _build

    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def const(src, name, value, what):
    """``src`` with ``constexpr int name`` set to ``value``."""
    new, n = re.subn(rf"constexpr int {name} = \d+;",
                     f"constexpr int {name} = {value};", src)
    if n != 1:
        raise RuntimeError(f"{what} has no one constexpr {name}")
    return new


def inline(src, header, text, what):
    """``src`` with ``#include "header"`` replaced by ``text``."""
    return ck.edit(src, f'#include "{header}"\n', text + "\n", what)


def flash_clocks(h):
    w = "flash_tc.cuh (clocks)"
    h = ck.edit(h, "template <class L, bool DROP>\n__global__",
                CLOCKS + "template <class L, bool DROP>\n__global__", w)
    for old, new in (
            ("  // this lane's two rows: r = 0 the warp's row g, r = 1 row g"
             " + 8\n", CLOCKS_START),
            ("                      // slot the next load takes was "
             "consumed last step\n", "    CLK(0)\n"),
            ("        tc::mma(acc[2 * dg + 1], pl, vf[2], vf[3]);\n      }\n"
             "    }\n", "    CLK(3)\n"),
            ("          masked ? INFINITY : m[r] * tc::kLn2 + logf(l[r]);\n"
             "  }\n", "  CLK(4)\n" + CLOCKS_END)):
        h = ck.edit(h, old, old + new, w)
    for old, i in (("    // scale and bias, in base 2", 1),
                   ("    // acc += p_hi v + p_lo v", 2)):
        h = ck.edit(h, old, f"    CLK({i})\n" + old, w)
    return h


def qkv_clocks(src):
    w = "qkv_attention.cu (clocks)"
    src = ck.edit(src, "template <int R, bool DROP>\n__global__ void "
                  "__launch_bounds__(ClusterTc<R>::NT, 2)",
                  CLOCKS + "template <int R, bool DROP>\n__global__ void "
                  "__launch_bounds__(ClusterTc<R>::NT, 2)", w)
    for old, new in (
            ("  const bf16* xb = x + (size_t)bi * t * dm;\n\n  // ---- "
             "project", None),
            ("      __syncthreads();  // chunk c has landed; slot (c + 2) % 3"
             " is consumed\n", "      CLK(0)\n"),
            ("          tc::mma(pa[2 * jp + 1], af, bf[2], bf[3]);\n"
             "        }\n      }\n", "      CLK(1)\n"),
            ("  cluster.sync();  // every block's k and v are ready; the ring"
             " is read\n", "  CLK(2)\n")):
        if new is None:  # the clocks start before the projection
            src = ck.edit(src, old, old.replace(
                "\n\n  // ---- project", "\n" + CLOCKS_START
                + "\n  // ---- project"), w)
        else:
            src = ck.edit(src, old, old + new, w)
    for old, i in (("    // this lane's bias pairs of the tile", 3),
                   ("    // the bias (in base 2) and, where the tile", 4),
                   ("    if (more) {  // the next tile's k replaces", 5),
                   ("    if (more) {  // ... and its v this one's", 6)):
        src = ck.edit(src, old, f"    CLK({i})\n" + old, w)
    old = ("  cluster.sync();  // no block leaves while a peer may still "
           "read its tiles\n}\n\n// -----------------------------------------"
           "----------------------------------\n// launches")
    src = ck.edit(src, old, old.replace("\n}\n", "\n  CLK(7)\n" + CLOCKS_END
                                        + "}\n"), w)
    return src + CLOCKS_ENTRY


def flash_variants():
    """{name: flash_attention.cu with an edited flash_tc.cuh inlined}."""
    src, h = read("flash_attention.cu"), read("flash_tc.cuh")
    w = "flash_tc.cuh"
    edits = {
        "rows_128": lambda t: const(const(t, "FT_ROWS", 128, w),
                                    "FT_MIN_BLOCKS", 2, w),
        "stages_3": lambda t: const(t, "FT_STAGES", 3, w),
        "registers_170": lambda t: const(t, "FT_MIN_BLOCKS", 3, w),
        "no_s_mma": lambda t: ck.edit(
            t, "        tc::mma(s[2 * kg], qf, kf[0], kf[1]);\n"
            "        tc::mma(s[2 * kg + 1], qf, kf[2], kf[3]);\n",
            "        s[2 * kg][0] += __uint_as_float(kf[0] & 0x80008000u);\n",
            w),
        "no_p_lo_mma": lambda t: ck.edit(ck.edit(
            t, "        tc::mma(acc[2 * dg], pl, vf[0], vf[1]);\n", "", w),
            "        tc::mma(acc[2 * dg + 1], pl, vf[2], vf[3]);\n", "", w),
        "no_exp": lambda t: ck.edit(
            t, "        s[n][e] = tc::ex2(s[n][e] - m[r]);",
            "        s[n][e] = s[n][e] - m[r];", w),
    }
    out = {name: inline(src, "flash_tc.cuh", e(h), name)
           for name, e in edits.items()}
    out["flash_clocks"] = inline(src, "flash_tc.cuh", flash_clocks(h),
                                 "clocks") + CLOCKS_ENTRY
    return out


def gemm_variants():
    """{name: gemm.cu with an edited gemm.cuh inlined}."""
    src, h = read("gemm.cu"), read("gemm.cuh")
    return {f"y_{k}x{stages}": inline(src, "gemm.cuh", const(const(
        h, "TC_K", k, "gemm.cuh"), "TC_STAGES", stages, "gemm.cuh"), name)
        for name, (k, stages) in (("4", (32, 4)), ("5", (32, 5)),
                                  ("64", (64, 3)), ("64_2", (64, 2)))}


#: #1's products of the low halves: p_lo v_hi in p v, and all three
#: low-half products (q_lo k_hi and q_hi k_lo in s, p_hi v_lo in p v)
QKV_LO = {"p_lo": "          tc::mma(o[2 * dg + h2], pl, vh[2 * h2], "
          "vh[2 * h2 + 1]);\n",
          "v_lo": "          tc::mma(o[2 * dg + h2], ph, vl[2 * h2], "
          "vl[2 * h2 + 1]);\n",
          "q_lo": "          tc::mma(s[2 * kg + h2], ql, kh[2 * h2], "
          "kh[2 * h2 + 1]);\n",
          "k_lo": "          tc::mma(s[2 * kg + h2], qh, kl[2 * h2], "
          "kl[2 * h2 + 1]);\n"}


def qkv_variants():
    """{name: qkv_attention.cu without some of #1's low-half products}:
    no_p_lo (p rounded to one bf16 in p v) and no_lo (q, k, v and p each
    rounded to one bf16: one MMA a product)."""
    src, w = read("qkv_attention.cu"), "qkv_attention.cu"
    no_p_lo = ck.edit(src, QKV_LO["p_lo"], "", w)
    no_lo = no_p_lo
    for part in ("v_lo", "q_lo", "k_lo"):
        no_lo = ck.edit(no_lo, QKV_LO[part], "", w)
    return {"qkv_no_p_lo": no_p_lo, "qkv_no_lo": no_lo}


#: the walks' products in flash_bwd_tc.cuh, by call site: the pair's
#: (hi/lo planes) and #6's, #7's (bf16 rows)
PAIR_SITES = {"s_dq": "    bw_scores<true>(s, q_s, k_s, warp);\n",
              "dp_dq": "    bw_scores<true>(dp, dc_s, v_s, warp);\n",
              "acc_dq": "    bw_accumulate<true>(acc, s, k_s);  // dq += ds k\n",
              "s_dkv": "    bw_scores<true>(s, k_s, q_t, warp);  // s^T = k "
                       "q^T\n",
              "dp_dkv": "    bw_scores<true>(dp, v_s, dc_t, warp);  // dp^T = "
                        "v dctx^T\n",
              "acc_dv": "    bw_accumulate<true>(dv, s, dc_t);  // dv += p^T "
                        "dctx\n",
              "acc_dk": "    bw_accumulate<true>(dk, dp, q_t);  // dk += ds^T "
                        "q\n"}
FLASH_SITES = {"acc_dq": "    bw_accumulate<false>(acc, s, k_s);  // dq += ds "
                         "k\n",
               "acc_dv": "    bw_accumulate<false>(dv, s, dc_t);  // dv += "
                         "p^T dO\n",
               "acc_dk": "    bw_accumulate<false>(dk, dp, q_t);  // dk += "
                         "ds^T q\n"}
#: each copy's products without a low half: {site: "na" (no lo of the A
#: operand), "nb" (no lo of B) or "hh" (hi hi only)}, and whether the dx
#: and dW products drop dq | dk | dv's lo plane.  The pair's copies
PAIR_LO = {"no_qk_lo": ({"s_dq": "hh", "s_dkv": "hh", "acc_dq": "nb",
                         "acc_dk": "nb"}, False),
           "no_dctx_v_lo": ({"dp_dq": "hh", "dp_dkv": "hh",
                             "acc_dv": "nb"}, False),
           "no_p_lo": ({"acc_dv": "na"}, False),
           "no_ds_lo": ({"acc_dq": "na", "acc_dk": "na"}, False),
           "no_dqkv_lo": ({}, True),
           "no_lo": ({site: "hh" for site in PAIR_SITES}, True)}
#: ... and #6's, #7's on bf16 rows, whose only split operands are p and ds
FLASH_BWD_LO = {"flash_no_p_lo": ({"acc_dv": "na"}, False),
                "flash_no_ds_lo": ({"acc_dq": "na", "acc_dk": "na"}, False)}
#: #6's and #7's walks with other tiles (the tree's bits, timing): 2
#: blocks an SM, the dq walk in the 128 registers of 4 blocks an SM (its
#: shared memory holds 3), a third ring stage at 2 blocks an SM
FLASH_BWD_TILES = {
    "flash_blocks_2": (("BW1_DQ_BLOCKS", 2), ("BW1_DKV_BLOCKS", 2)),
    "flash_dq_blocks_4": (("BW1_DQ_BLOCKS", 4),),
    "flash_stages_3": (("BW1_STAGES", 3), ("BW1_DQ_BLOCKS", 2),
                       ("BW1_DKV_BLOCKS", 2))}
WALK_PHASES = ("ring wait", "next copies and bias", "s", "p", "dp and ds",
               "accumulating products", "epilogue")
#: each kind's clocked walks: (clocks name, kernel's first lines, its
#: phase marks (text, mark, before it), its last statement)
WALK_CLOCKS = {
    "pair": (
        ("dq", "template <bool DROP>\n__global__ void __launch_bounds__("
         "BW_NT, BW_MIN_BLOCKS)\nbwd_dq_tc_kernel(", "  int qpos[2];\n", (
             ("(and q, dctx) have landed; the\n                      "
              "// slot the next load takes was consumed last step\n",
              "    CLK(0)\n", 0),
             ("    // p = exp(s * scale + bias", "    CLK(1)\n", 1),
             ("    const bool edge = k0 + BW_ROWS", "    CLK(2)\n", 1),
             ("    // ds = p (dp - delta)", "    CLK(3)\n", 1),
             (PAIR_SITES["acc_dq"], "    CLK(4)\n", 1),
             (PAIR_SITES["acc_dq"], "    CLK(5)\n", 0)),
         "  bw_store<true>(dq, acc, bi, q0, t, head);\n"),
        ("dkv", "template <bool DROP>\n__global__ void __launch_bounds__("
         "BW_NT, BW_MIN_BLOCKS)\nbwd_dkv_tc_kernel(", "  int kpos[2];\n", (
             ("the next load takes was consumed last step\n",
              "    CLK(0)\n", 0),
             ("    // p^T = exp(s^T * scale", "    CLK(1)\n", 1),
             ("    const bool edge = q0 + BW_ROWS", "    CLK(2)\n", 1),
             ("    // ds^T into dp, then p^T", "    CLK(3)\n", 1),
             (PAIR_SITES["acc_dv"], "    CLK(4)\n", 1),
             (PAIR_SITES["acc_dk"], "    CLK(5)\n", 0)),
         "  bw_store<true>(dv_p, dv, bi, k0, t, head);\n")),
    "flash": (
        ("flash_dq", "template <bool DROP>\n__global__ void __launch_bounds__("
         "BW_NT, BW1_DQ_BLOCKS)\nflash_dq_tc_kernel(", "  int qpos[2];\n", (
             ("(and q, dO) have landed; the\n                      "
              "// slot the next load takes was consumed last step\n",
              "    CLK(0)\n", 0),
             ("    // p = exp(s * scale + bias", "    CLK(1)\n", 1),
             ("    const bool edge =\n        k0 + BW_ROWS", "    CLK(2)\n",
              1),
             ("    // ds = p (dp - delta)", "    CLK(3)\n", 1),
             (FLASH_SITES["acc_dq"], "    CLK(4)\n", 1),
             (FLASH_SITES["acc_dq"], "    CLK(5)\n", 0)),
         "  bw_store<false>(PlanesOf<bf16>{a.dq, 0, hd}, acc, bi, q0, tq, "
         "head);\n"),
        ("flash_dkv", "template <bool DROP>\n__global__ void "
         "__launch_bounds__(BW_NT, BW1_DKV_BLOCKS)\nflash_dkv_tc_kernel(",
         "  int kpos[2];\n", (
             ("the next load takes was consumed last step\n",
              "    CLK(0)\n", 0),
             ("    // p^T = exp(s^T * scale", "    CLK(1)\n", 1),
             ("    const bool edge = q0 + BW_ROWS", "    CLK(2)\n", 1),
             ("    // ds^T into dp, then p^T", "    CLK(3)\n", 1),
             (FLASH_SITES["acc_dv"], "    CLK(4)\n", 1),
             (FLASH_SITES["acc_dk"], "    CLK(5)\n", 0)),
         "  bw_store<false>(PlanesOf<bf16>{a.dv, 0, hd}, dv, bi, k0, tk, "
         "head);\n"))}


def _hi_only(h, w):
    """flash_bwd_tc.cuh with copies of mma2, mma3, bw_scores and
    bw_accumulate that drop A's lo (_na), B's lo (_nb) or both (_hh)."""
    fns = {name: re.search(r"(template <bool SPLIT>\n)?__device__ "
                           r"__forceinline__ void " + name
                           + r"\(.*?\n}\n", h, re.S).group(0)
           for name in ("mma2", "mma3", "bw_scores", "bw_accumulate")}
    text = ""
    for suffix, drop in (("na", ("al,",)), ("nb", ("bl[",)),
                         ("hh", ("al,", "bl["))):
        for name in ("mma2", "mma3"):
            text += "".join(line + "\n" for line in fns[name].replace(
                f"void {name}(", f"void {name}_{suffix}(").splitlines()
                if not any(d in line for d in drop))
        for name in ("bw_scores", "bw_accumulate"):
            text += fns[name].replace(
                f"void {name}(", f"void {name}_{suffix}(").replace(
                "mma3(", f"mma3_{suffix}(").replace(
                "mma2(", f"mma2_{suffix}(")
    anchor = "__device__ __forceinline__ float bf16_bits"
    return ck.edit(h, anchor, text + anchor, w)


def _walk_copies(src, h, g, table, sites):
    """{name: src with an edited flash_bwd_tc.cuh (and, for dq | dk | dv's
    lo, gemm.cuh) inlined}, one a ``table`` entry over ``sites``."""
    w = "flash_bwd_tc.cuh"
    out = {}
    for name, (edits, dqkv) in table.items():
        v = _hi_only(h, w)
        for site, suffix in edits.items():
            old = sites[site]
            call = old.split("<", 1)[0]
            v = ck.edit(v, old, old.replace(call + "<",
                                            f"{call}_{suffix}<"), w)
        copy = inline(src, "flash_bwd_tc.cuh", v, name)
        if dqkv:  # dx and dW_qkv: hi only of the split operand
            gv = ck.edit(ck.edit(
                g, "          for (int plane = 0; plane < 2; ++plane) {",
                "          for (int plane = 0; plane < 1; ++plane) {",
                "gemm.cuh"),
                "          for (int plane = 0; plane < (B_LO ? 2 : 1); "
                "++plane) {", "          for (int plane = 0; plane < 1; "
                "++plane) {", "gemm.cuh")
            copy = inline(copy, "gemm.cuh", gv, name)
        out[name] = copy
    return out


def _walk_clocks(src, h, kind):
    """{"<walk>_clocks": src with a flash_bwd_tc.cuh whose walk sums its
    phases' clocks}, for each walk of WALK_CLOCKS[kind] (the pair's in
    qkv_attention_bwd.cu, #6's and #7's in flash_attention.cu)."""
    out = {}
    for walk, anchor, start, edits, end in WALK_CLOCKS[kind]:
        what = f"flash_bwd_tc.cuh ({walk} clocks)"
        v = ck.edit(h, anchor, CLOCKS + anchor, what)
        # the kernel's own text: from its first line to its closing brace
        head, rest = v.split(CLOCKS + anchor, 1)
        body, tail = rest.split("\n}\n", 1)
        body += "\n}\n"
        body = ck.edit(body, start, CLOCKS_START + start, what)
        for old, new, before in edits:
            body = ck.edit(body, old, new + old if before else old + new,
                           what)
        body = ck.edit(body, end, end + "  CLK(6)\n" + CLOCKS_END, what)
        out[f"{walk}_clocks"] = inline(
            src, "flash_bwd_tc.cuh", head + CLOCKS + anchor + body + tail,
            walk) + CLOCKS_ENTRY
    return out


def pair_variants():
    """{name: qkv_attention_bwd.cu with an edited flash_bwd_tc.cuh (and,
    for dq | dk | dv's lo, gemm.cuh) inlined}: PAIR_LO's copies (timing
    and the split's worth), and the walks' clocks (dq_clocks,
    dkv_clocks)."""
    src, h, g = (read("qkv_attention_bwd.cu"), read("flash_bwd_tc.cuh"),
                 read("gemm.cuh"))
    return {**_walk_copies(src, h, g, PAIR_LO, PAIR_SITES),
            **_walk_clocks(src, h, "pair")}


def flash_bwd_variants():
    """{name: flash_attention.cu with an edited flash_bwd_tc.cuh inlined}:
    FLASH_BWD_LO's and FLASH_BWD_TILES' copies of #6's and #7's walks in
    bf16, and their clocks (flash_dq_clocks, flash_dkv_clocks)."""
    src, h = read("flash_attention.cu"), read("flash_bwd_tc.cuh")
    tiles = {}
    for name, consts in FLASH_BWD_TILES.items():
        v = h
        for const_name, value in consts:
            v = const(v, const_name, value, name)
        tiles[name] = inline(src, "flash_bwd_tc.cuh", v, name)
    return {**_walk_copies(src, h, None, FLASH_BWD_LO, FLASH_SITES),
            **tiles, **_walk_clocks(src, h, "flash")}


def error64(got, exact):
    """(max abs error of the bf16 ``got`` against the float64 ``exact``,
    the share of its elements that are not ``exact`` rounded to bf16)."""
    return ((got.double() - exact).abs().max().item(),
            (got != exact.to(got.dtype)).double().mean().item())


def phase_shares(lib, n_blocks, phases):
    """The clocked copy's phases as shares of a block's clock (mean over
    the last launch's blocks) and the mean block clock."""
    host = (ctypes.c_longlong * (n_blocks * 10))()
    torch.cuda.synchronize()
    lib.ptt_clocks(ctypes.cast(host, ctypes.c_void_p), n_blocks * 10)
    a = np.array(host[:], dtype=np.float64).reshape(n_blocks, 10)
    total = a[:, 9].mean()
    return dict(zip(phases, (a[:, :len(phases)].mean(0) / total).round(4)
                    .tolist()), block_clock=total)


def dropout_variants():
    """``csrc/dropout_add.cu`` as it is ("tree") and copies with another
    round of vectors a thread or other cache hints."""
    w = "dropout_add.cu"
    src = read(w)
    plain_stores = ck.edit(src, "    __stcs(p, v);", "    *p = v;", w)
    return {"tree": src,
            **{f"vecs_{n}": const(src, "kVecs", n, w) for n in (1, 3, 4)},
            "no_hints": ck.edit(src, "constexpr bool kStream = true;",
                                "constexpr bool kStream = false;", w),
            "plain_stores": plain_stores}


def sass_ops(build, so, kernel, ops):
    """{function: {op: count}} of the functions of the shared object
    ``so`` whose names hold ``kernel`` (``cuobjdump -sass``), for the
    opcodes ``ops`` (modifiers dropped)."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if kernel in m.group(1) else None
            if fn:
                counts[fn] = dict.fromkeys(ops, 0)
            continue
        m = re.search(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if fn and m and m.group(1) in ops:
            counts[fn][m.group(1)] += 1
    return counts


def dropout_times():
    """#16 (with a residual) and #17 at [32*256, 512] in bf16 and f32: the
    tree's and ``dropout_variants``' device ms after a dirty and a clean
    flush, three rounds in turn, the same-bytes calls beside."""
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import dropout_epilogue as kde

    with tempfile.TemporaryDirectory() as out_dir:
        libs = ck.build(_build, out_dir, dropout_variants(), [
            "ptt_dropout_add", "ptt_dropout_add_bwd", "ptt_dropout_add_bf16",
            "ptt_dropout_add_bwd_bf16"])
        print(json.dumps({"sass": sass_ops(
            _build, os.path.join(out_dir, "libtree.so"), "dropout_kernel",
            ("F2F", "F2FP", "HMUL2", "HADD2", "HFMA2", "FMUL", "FADD",
             "LDG", "STG"))}))
    gen = torch.Generator().manual_seed(0)
    shape, rate, seed = (cs.DROPOUT_ROWS, cs.BASE["d_model"]), cs.DROPOUT, 7
    for dtype in (torch.bfloat16, torch.float32):
        x, r, g = (cs.randn(gen, *shape).to(dtype) for _ in range(3))
        calls = {"fwd": lambda: kde.dropout_add_fwd(x, r, rate, seed),
                 "bwd": lambda: kde.dropout_add_bwd(g, rate, seed)}
        scale = float(kde._scale(rate, dtype))
        same = {"fwd": lambda: torch.add(x, r),
                "bwd": lambda: torch.mul(g, scale)}
        with cs.kernel_library(libs["tree"]):
            want = {k: fn() for k, fn in calls.items()}
        times = {}
        for rnd in range(3):
            for name in (list(libs) if rnd % 2 == 0 else list(libs)[::-1]):
                with cs.kernel_library(libs[name]):
                    for k, fn in calls.items():
                        if not torch.equal(fn(), want[k]):
                            raise RuntimeError(f"{name} {k}: not the "
                                               "tree's bits")
                        for clean in (False, True):
                            times.setdefault((name, k, clean), []).append(
                                cs.cuda_ms(fn, hide_host=True, clean=clean))
        for k in calls:
            rec = dict(kernel=f"dropout_add_{k}", dtype=str(dtype)[6:])
            for clean in (False, True):
                flush = "clean" if clean else "dirty"
                rec[f"same_bytes_{flush}_ms"] = cs.cuda_ms(
                    same[k], hide_host=True, clean=clean)
                for name in libs:
                    rec[f"{name}_{flush}_ms"] = float(
                        np.median(times[(name, k, clean)]))
            print(json.dumps(rec))


def main():
    if not torch.cuda.is_available():
        print("chip_tc_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import attention as ka
    from paddle_tpu_torch.kernels import gemm as kg

    print(ck.card())
    if sys.argv[1:] == ["dropout"]:
        dropout_times()
        print(json.dumps({"ok": True}))
        return 0
    if sys.argv[1:] == ["width128"]:
        width128_times()
        print(json.dumps({"ok": True}))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    with tempfile.TemporaryDirectory() as out_dir:
        flash, gemm, qkv = flash_variants(), gemm_variants(), qkv_variants()
        pair, flash_bwd = pair_variants(), flash_bwd_variants()
        libs = ck.build(_build, out_dir, {
            **flash, **gemm, **qkv, **pair, **flash_bwd,
            "qkv_clocks": qkv_clocks(read("qkv_attention.cu"))}, [])
    for name, lib in libs.items():
        entries = (["ptt_flash_fwd_bf16"] if name in flash
                   else ["ptt_flash_bwd_dq_bf16", "ptt_flash_bwd_dkv_bf16"]
                   if name in flash_bwd
                   else ["ptt_gemm_typed", "ptt_gemm_partials"]
                   if name in gemm else ["ptt_qkv_bwd_bf16",
                                         "ptt_qkv_bwd_scratch"]
                   if name in pair else ["ptt_qkv_attention_fwd_bf16",
                                         "ptt_qkv_fwd_scratch"])
        for e in entries + ["ptt_error_string"] * hasattr(
                lib, "ptt_error_string"):
            fn = getattr(lib, e)
            fn.restype, fn.argtypes = _build._SIGNATURES[e]
        if hasattr(lib, "ptt_clocks"):
            lib.ptt_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    gen = torch.Generator().manual_seed(0)
    b, h = cs.TRAIN_BATCH, cs.BASE["n_head"]
    for case, bias_kind in (("cross", "pad"), ("decoder self", "decoder")):
        q, k, v, _, bias = cs._bf16(*cs._flash_inputs(gen, 256, 256,
                                                      bias_kind, False))
        kw = dict(scale=0.125, causal=False)
        want = ka.reference_flash_fwd(q, k, v, bias, **kw)[0]
        exact = ka.reference_flash_fwd(
            *(a.double() for a in (q, k, v, bias)), **kw)[0]
        fn = lambda: ka.flash_fwd(q, k, v, bias, **kw)  # noqa: E731
        rec = dict(kernel="flash_fwd_bf16", case=case,
                   tree_ms=cs.cuda_ms(fn, hide_host=True),
                   tree_err=error64(fn()[0], exact),
                   sdpa_ms=cs.cuda_ms(
                       lambda: torch.nn.functional.scaled_dot_product_attention(
                           q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), attn_mask=bias, scale=0.125),
                       hide_host=True))
        for name in flash:
            if name == "flash_clocks":
                continue
            with cs.kernel_library(libs[name]):
                o = fn()[0]
                rec[name + "_ms"] = cs.cuda_ms(fn, hide_host=True)
            if name == "no_p_lo_mma":  # p rounded to one bf16 in p v
                rec[name + "_err"] = error64(o, exact)
            elif not name.startswith("no_"):  # the others compute wrong
                cs.compare_bf16(f"{name} {case}", o, want)
        with cs.kernel_library(libs["flash_clocks"]):
            fn()
        rec["phases"] = phase_shares(libs["flash_clocks"], 4 * h * b,
                                     FLASH_PHASES)
        print(json.dumps(rec))
    x, w_qkv, w_out, _, bias = cs._bf16(*cs._qkv_inputs(gen, 256, "decoder"))
    kw = dict(n_head=h, scale=0.125, causal=False)
    fn = lambda: ka.qkv_attention_fwd(  # noqa: E731
        x, w_qkv, w_out, bias, **kw)
    with cs.kernel_library(libs["qkv_clocks"]):
        ctx = fn()[1]
    cs.compare_bf16("qkv clocks ctx", ctx, ka.reference_qkv_fwd(
        x, w_qkv, w_out, bias, **kw)[1])
    exact = ka.reference_qkv_fwd(
        *(a.double() for a in (x, w_qkv, w_out, bias)), **kw)[1]
    rec = dict(kernel="qkv_attention_fwd_bf16", case="decoder self",
               phases=phase_shares(libs["qkv_clocks"], 4 * h * b,
                                   QKV_PHASES),
               tree_ms=cs.cuda_ms(fn, hide_host=True),
               tree_err=error64(fn()[1], exact))
    for name in qkv:
        with cs.kernel_library(libs[name]):
            rec[name + "_err"] = error64(fn()[1], exact)
            rec[name + "_ms"] = cs.cuda_ms(fn, hide_host=True)
    print(json.dumps(rec))
    a = cs.randn(gen, 8192, 512, scale=512 ** -0.5).bfloat16()
    w = cs.randn(gen, 512, 512).bfloat16()
    want = kg.reference_gemm(a, w, torch.bfloat16)
    fn = lambda: kg.gemm(a, w, True, torch.bfloat16)  # noqa: E731
    rec = dict(kernel="gemm_tc", case="y 8192 x 512 x 512",
               tree_ms=cs.cuda_ms(fn, hide_host=True),
               matmul_ms=cs.cuda_ms(lambda: a @ w, hide_host=True))
    for name in gemm:
        with cs.kernel_library(libs[name]):
            cs.compare_bf16(name, fn(), want)
            rec[name + "_ms"] = cs.cuda_ms(fn, hide_host=True)
    print(json.dumps(rec))
    pair_times(gen, pair, libs)
    flash_bwd_times(gen, flash_bwd, libs)
    print(json.dumps({"ok": True}))
    return 0


#: the tree's split of a row group's head columns, and the other one
WIDTH_SPLIT = ("  static constexpr int kCols = SPLIT && D > BW_COLS ? BW_COLS "
               ": D;\n",
               "  static constexpr int kCols = !SPLIT && D > BW_COLS ? "
               "BW_COLS : D;\n")


def ptxas_registers(log, kernels):
    """[(kernel, template arguments, registers, spill stores, stack
    bytes)] of the head-width-128 instantiations of ``kernels`` in an
    ``-Xptxas -v`` log."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = next((k for k in kernels if k in m.group(1)
                        and "Li128E" in m.group(1)
                        and not (k.startswith("bwd_") and "flash" in
                                 m.group(1))), None)
            if cur:
                args = m.group(1).split(cur, 1)[1]
                cur = [cur, args[:args.find("EE") + 2]]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if cur and m:
            cur += [int(m[2]), int(m[1])]
        m = re.search(r"Used (\d+) registers", line)
        if cur and m:
            out.append((cur[0], cur[1], int(m[1]), *cur[2:]))
            cur = None
    return out


def width128_times():
    """The ``width128`` mode: the walks with the other split of a row
    group's columns (WIDTH_SPLIT), built as copies of
    ``flash_attention.cu`` and ``qkv_attention_bwd.cu``; one JSON line
    each of the builds and of the timed walks."""
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import attention as ka

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    walks = ("flash_dq_tc_kernel", "flash_dkv_tc_kernel", "bwd_dq_tc_kernel",
             "bwd_dkv_tc_kernel")
    print(json.dumps({"build": "tree", "walks": ptxas_registers(
        _build.build_log(), walks)}))
    h = ck.edit(read("flash_bwd_tc.cuh"), *WIDTH_SPLIT, "flash_bwd_tc.cuh")
    libs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        jobs = []
        for src in ("flash_attention.cu", "qkv_attention_bwd.cu"):
            path = os.path.join(out_dir, src)
            with open(path, "w") as f:
                f.write(inline(read(src), "flash_bwd_tc.cuh", h, src))
            so = os.path.join(out_dir, f"lib{src[:-3]}.so")
            jobs.append((src, so, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-I",
                 _build.CSRC_DIR, "-o", so, path], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        for src, so, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on the {src} copy:\n{log}")
            print(json.dumps({"build": "other split", "source": src,
                              "walks": ptxas_registers(log, walks)}))
            lib = ctypes.CDLL(so)
            for name, (restype, argtypes) in _build._SIGNATURES.items():
                if hasattr(lib, name):
                    fn = getattr(lib, name)
                    fn.restype, fn.argtypes = restype, argtypes
            libs[src] = lib
    gen = torch.Generator().manual_seed(3)
    q, k, v, do, bias = cs._bf16(*cs._flash_inputs(gen, 256, 256, "pad",
                                                   False, cs.BIG))
    kw = dict(scale=128 ** -0.5, causal=False)
    o, lse = ka.flash_fwd(q, k, v, bias, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    bw = (q, k, v, bias, do, lse, delta)
    x, w_qkv, w_out, g, qb = cs._bf16(*cs._qkv_inputs(
        gen, 256, "pad", cs.TRAIN_BATCH, cs.BIG["d_model"]))
    qkw = dict(n_head=cs.BIG["n_head"], scale=128 ** -0.5)
    _, ctx, qlse = ka.qkv_attention_fwd(x, w_qkv, w_out, qb, **qkw)
    pw = (x, w_qkv, w_out, qb, g, ctx, qlse)
    for name, src, fn in (
            ("flash_bwd_dq_bf16_dh128", "flash_attention.cu",
             lambda: (ka.flash_bwd_dq(*bw, **kw),)),
            ("flash_bwd_dkv_bf16_dh128", "flash_attention.cu",
             lambda: ka.flash_bwd_dkv(*bw, **kw)),
            ("qkv_bwd_bf16_dh128", "qkv_attention_bwd.cu",
             lambda: ka.qkv_bwd(*pw, **qkw))):
        tree = fn()
        with cs.kernel_library(libs[src]):
            other = fn()
            torch.cuda.synchronize()
        times = []
        for lib in (None, libs[src], libs[src], None):
            with cs.kernel_library(lib or _build.lib()):
                times.append(cs.cuda_ms(fn, hide_host=True))
        print(json.dumps({
            "kernel": name, "same_bits": all(
                torch.equal(a, c) for a, c in zip(tree, other)),
            "tree_ms": [times[0], times[3]],
            "other_split_ms": [times[1], times[2]], "card": ck.card()}))


def flash_bwd_times(gen, variants, libs):
    """#6's and #7's records in bf16 at the amp step's cross-attention
    (pad bias) and decoder self-attention (decoder bias): each walk's time
    at rates 0 and 0.1 beside the backward of masked
    ``F.scaled_dot_product_attention``, dq, dk and dv against the float64
    twin (``error64``), FLASH_BWD_LO's copies' times and errors,
    FLASH_BWD_TILES' copies' times (each held to the tree's bits), and
    each walk's clocks; all device time only."""
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import attention as ka

    b, h = cs.TRAIN_BATCH, cs.BASE["n_head"]
    names = ("dq", "dk", "dv")
    for case, bias_kind in (("cross", "pad"), ("decoder self", "decoder")):
        q, k, v, do, bias = cs._bf16(*cs._flash_inputs(gen, 256, 256,
                                                      bias_kind, False))
        kw = dict(scale=0.125, causal=False)
        o, lse = ka.flash_fwd(q, k, v, bias, **kw)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        bw = (q, k, v, bias, do, lse, delta)
        b64 = [a.double() for a in bw]
        exact = (ka.reference_flash_bwd_dq(*b64, **kw),
                 *ka.reference_flash_bwd_dkv(*b64, **kw))
        del b64
        kw_d = dict(kw, dropout_rate=cs.DROPOUT, dropout_seed=1234)

        def dq(**kw_):
            return ka.flash_bwd_dq(*bw, **kw_)

        def dkv(**kw_):
            return ka.flash_bwd_dkv(*bw, **kw_)

        def errors():
            got = (dq(**kw), *dkv(**kw))
            return {n: error64(a, e) for n, a, e in zip(names, got, exact)}

        tree = (dq(**kw), *dkv(**kw))

        def require_same(name, got):
            cs.require(all(torch.equal(a, b) for a, b in zip(got, tree)),
                       f"{name} {case}: not the tree's bits")

        lq, lk, lv = (a.transpose(1, 2).detach().requires_grad_()
                      for a in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=bias, scale=0.125)
        rec = dict(kernel="flash_bwd_bf16", case=case,
                   dq_ms=cs.cuda_ms(lambda: dq(**kw), hide_host=True),
                   dkv_ms=cs.cuda_ms(lambda: dkv(**kw), hide_host=True),
                   dq_dropout_ms=cs.cuda_ms(lambda: dq(**kw_d),
                                            hide_host=True),
                   dkv_dropout_ms=cs.cuda_ms(lambda: dkv(**kw_d),
                                             hide_host=True),
                   sdpa_bwd_ms=cs.cuda_ms(lambda: torch.autograd.grad(
                       lib_out, (lq, lk, lv), do.transpose(1, 2),
                       retain_graph=True), hide_host=True),
                   tree_err=errors())
        del lib_out
        for name in variants:
            if name.endswith("_clocks"):
                continue
            with cs.kernel_library(libs[name]):
                if name in FLASH_BWD_TILES:  # the same arithmetic
                    require_same(name, (dq(**kw), *dkv(**kw)))
                else:
                    rec[name + "_err"] = errors()
                rec[name + "_ms"] = (
                    cs.cuda_ms(lambda: dq(**kw), hide_host=True),
                    cs.cuda_ms(lambda: dkv(**kw), hide_host=True))
        for walk, call in (("dq", dq), ("dkv", dkv)):
            lib = libs[f"flash_{walk}_clocks"]
            with cs.kernel_library(lib):
                call(**kw)
            rec[f"{walk}_phases"] = phase_shares(lib, 4 * h * b,
                                                 WALK_PHASES)
        print(json.dumps(rec))


def pair_times(gen, pair, libs):
    """The pair's records at the decoder self-attention: the tree's time,
    its profile split and its outputs' error against the float64 twin,
    each timing copy's time and error, and each walk's clocks."""
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import attention as ka

    b, h, dm = cs.TRAIN_BATCH, cs.BASE["n_head"], cs.BASE["d_model"]
    x, w_qkv, w_out, g, bias = cs._bf16(*cs._qkv_inputs(gen, 256,
                                                        "decoder"))
    kw = dict(n_head=h, scale=0.125, causal=False)
    _, ctx, lse = ka.qkv_attention_fwd(x, w_qkv, w_out, bias, **kw)
    bw = (x, w_qkv, w_out, bias, g, ctx, lse)
    exact = ka.reference_qkv_bwd(*(a.double() for a in bw), **kw)
    fn = lambda: ka.qkv_bwd(*bw, **kw)  # noqa: E731
    names = ("dx", "dW_qkv", "dW_out")

    def errors(got):
        return {n: error64(a, e) for n, a, e in zip(names, got, exact)}

    rec = dict(kernel="qkv_bwd_bf16", case="decoder self",
               tree_ms=cs.cuda_ms(fn, hide_host=True), tree_err=errors(fn()),
               stages=cs._pair_stages(fn, b, 256, dm, h * 64))
    for name in pair:
        if name.endswith("_clocks"):
            continue
        with cs.kernel_library(libs[name]):
            rec[name + "_err"] = errors(fn())
            rec[name + "_ms"] = cs.cuda_ms(fn, hide_host=True)
    for walk, call in (("dq", ka.qkv_bwd_dq), ("dkv", ka.qkv_bwd_dkv)):
        lib = libs[f"{walk}_clocks"]
        with cs.kernel_library(lib):
            call(*bw, **kw)
        rec[f"{walk}_phases"] = phase_shares(lib, 4 * h * b, WALK_PHASES)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
