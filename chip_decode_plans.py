#!/usr/bin/env python3
"""Flash-decode (#14/#15, ``csrc/decode_attention.cu``) under its plans, on
one CUDA card, at the unfused decode step's shapes: Transformer-base's 8
heads of 64, the self side (caches of 128 rows, lengths 1-128) and the
cross side (256 rows, lengths 8-256) as ``chip_smoke.check_flash_decode``
draws them, at b = 1, 33 and 64, and full caches at b = 64.

    python3 chip_decode_plans.py

For each case and layout, the plan that ``decode_plan`` picks and the
other plans of ``group_plan`` (heads an item 8, 4, 2, 1; 1 or 2
eight-warp blocks' worth of warps an SM) are each held against the plain
twin at ``chip_smoke.TOL_KERNEL`` and timed as phase 2 times the kernels
(``chip_smoke.cuda_ms``: medians of 20 calls after the 256 MB L2 flush),
in two rounds, the second in reverse order.  A copy of the kernel that
stamps ``%globaltimer`` (``chip_kernel_copies``: start, walk end, after
the grid barrier, merge end) gives the chosen plan's phase ends, the
latest block's stamp less the earliest block's start, in us, medians of
9 calls after the flush.  At full caches, ``k.sum()`` and ``v.sum()``
timed the same way give what streaming the walk's bytes costs without
it.

Prints the card and its power limit, one JSON line per measurement, and
last ``{"ok": true}``.  Exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

import chip_kernel_copies as ck

HERE = os.path.dirname(os.path.abspath(__file__))
WHAT = "chip_decode_plans: csrc/decode_attention.cu"
#: the kernel's first lines, before which the stamps are defined
ANCHOR = "template <int DH, bool PAGED, int NW>\n__global__"
#: (case, side, b, full caches)
CASES = (("b=64", "self", 64, False), ("b=64", "cross", 64, False),
         ("b=1", "self", 1, False), ("b=1", "cross", 1, False),
         ("b=33", "cross", 33, False), ("full b=64", "cross", 64, True))
#: other plans: (heads an item, eight-warp blocks' worth of warps an SM)
VARIANTS = tuple((g, m) for g in (8, 4, 2, 1) for m in (1, 2))
#: phase ends of the stamped copy, in stamp order
PHASES = ("last block start", "walk", "grid barrier", "merge")


def stamped(src):
    """csrc/decode_attention.cu with %globaltimer stamps at the kernel's
    start, the walk's end, after the grid barrier and at the merge's
    end."""
    return ck.stamped(src, WHAT, ANCHOR, (
        ("  extern __shared__ __align__(16) float smem[];\n",
         "  extern __shared__ __align__(16) float smem[];\n  stamp(0);\n"),
        ("  cg::this_grid().sync();\n",
         "  stamp(1);\n  cg::this_grid().sync();\n  stamp(2);\n"),
        ("P.out);\n", "P.out);\n  stamp(3);\n")))


def call(lib, paged, inputs, plan, scale):
    """One launch of the entry point on ``plan``; returns the output."""
    from paddle_tpu_torch.kernels import _build

    q, k, v, lens, table, k_pool, v_pool = inputs
    b, h, dh = q.shape
    buf = torch.empty(b * h * dh + plan.scratch, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    head = (buf.data_ptr(), buf.data_ptr() + 4 * b * h * dh, b)
    if paged:
        nb, bt = k_pool.shape[:2]
        err = lib.ptt_flash_decode_paged(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            table.data_ptr(), lens.data_ptr(), *head, h, dh, nb, bt,
            table.shape[1], *plan.ints(), scale, stream)
    else:
        err = lib.ptt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), *head,
            k.shape[1], h, dh, *plan.ints(), scale, stream)
    _build.check(err, "flash_decode")
    return buf[:b * h * dh].view(b, h, dh)


def main():
    if not torch.cuda.is_available():
        print("chip_decode_plans: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import decode_attention as kda
    from paddle_tpu_torch.kernels.attention import sm_count

    print(ck.card())
    tree = _build.lib()
    sms = sm_count(torch.device("cuda"))
    h, dh = cs.BASE["n_head"], cs.BASE["d_key"]
    scale = dh ** -0.5
    gen = torch.Generator().manual_seed(15)
    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(_build.CSRC_DIR,
                               "decode_attention.cu")) as f:
            stamps_lib = ck.build(
                _build, out_dir, {"decode_stamped": stamped(f.read())},
                ["ptt_flash_decode", "ptt_flash_decode_paged"])[
                    "decode_stamped"]
        for case, side, b, full in CASES:
            inputs = cs._flash_decode_inputs(gen, b, side, full)
            q, k, v, lens = inputs[:4]
            want = kda.reference_decode(q, k, v, lens, scale)
            rows = k.shape[1]
            for paged in (False, True):
                chosen = kda.device_decode_plan(q.device, paged, b, h, rows)
                plans = [chosen]
                for g, m in VARIANTS:
                    fits = kda.group_plan(g, b, h, rows, sms, m)
                    if fits is None or fits[0] in plans:
                        continue
                    per_sm = tree.ptt_flash_decode_occupancy(
                        int(paged), dh, g, fits[0].smem)
                    if per_sm * sms >= fits[0].grid:
                        plans.append(fits[0])
                errs = [(call(tree, paged, inputs, p, scale)
                         - want).abs().max().item() for p in plans]
                for p, err in zip(plans, errs):
                    cs.require(err <= cs.TOL_KERNEL,
                               f"{case} {side} paged={paged} plan {p}: max "
                               f"abs err {err}")
                times = [[] for _ in plans]
                for order in (range(len(plans)),
                              reversed(range(len(plans)))):
                    for i in order:
                        times[i].append(cs.cuda_ms(
                            lambda: call(tree, paged, inputs, plans[i],
                                         scale)))
                for i, p in enumerate(plans):
                    print(json.dumps(dict(
                        case=case, side=side, paged=paged,
                        chosen=p == chosen, plan=p._asdict(),
                        max_abs_err=errs[i], ms=float(np.median(times[i])),
                        ms_rounds=times[i])), flush=True)

                ends = ck.phase_ends(
                    stamps_lib, chosen.grid, len(PHASES),
                    lambda: call(stamps_lib, paged, inputs, chosen, scale))
                print(json.dumps(dict(
                    case=case, side=side, paged=paged,
                    phase_end_us={p: round(float(t), 3)
                                  for p, t in zip(PHASES, ends)})),
                      flush=True)

                if full and not paged:
                    # the same bytes streamed by one PyTorch reduction each
                    # for k and v, after the same flush: what reading them
                    # costs the card without the walk
                    print(json.dumps(dict(
                        case=case, side=side,
                        stream_ms=cs.cuda_ms(lambda: (k.sum(), v.sum())),
                        stream_bytes=2 * k.numel() * 4)), flush=True)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
