#!/usr/bin/env python3
"""Where the decode FFN kernel (#11/#13, ``csrc/ffn.cu``) spends its time,
on one CUDA card, at Transformer-base's widths (d_model 512, d_inner
2048) and the batches 1, 33 and 64.

    python3 chip_ffn_phases.py

Builds temporary copies of ``csrc/ffn.cu`` by ``chip_kernel_copies`` (the
tree is not changed):

* ``stamped``: thread 0 of every block reads ``%globaltimer`` after a
  barrier at each phase end (P1 and fused P2, the split barrier, split
  P2, the P3 barrier, P3's sums, the LN barrier, LN3); the phase ends are
  printed as the latest block's stamp less the earliest block's start, in
  us, medians of 9 calls after the 256 MB L2 flush;
* ``no_k_loop``: the products skip their k steps (wrong outputs: what
  the kernel costs without its FMAs);
* ``k_loop_twice``: every k step runs twice (the FMAs' cost, doubled);
* ``no_x_copy``: P1 does not stage the x rows (what staging x costs).

Each variant and the tree's kernel are timed alternately, device time
only (``chip_smoke.cuda_ms`` with ``hide_host``), on the plan that
``ffn_plan`` picks and, with the tree's kernel, on other plans of both
layouts.  Prints the card and its power limit, one JSON line per
measurement, and last ``{"ok": true}``.  Exits 2 without a card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

import chip_kernel_copies as ck

HERE = os.path.dirname(os.path.abspath(__file__))
WHAT = "chip_ffn_phases: csrc/ffn.cu"
#: the kernel's first line, before which the stamps are defined
ANCHOR = "__global__ void __launch_bounds__(NT, 1)"
DM, DI = 512, 2048
BATCHES = (1, 33, 64)
#: phase ends of the stamped copy, in stamp order
PHASES = ("start spread", "P1 (and fused P2)", "split barrier", "split P2",
          "P3 barrier", "P3 sums", "LN barrier", "LN3")


def stamped(src):
    """csrc/ffn.cu with %globaltimer stamps at its phase ends
    (``chip_kernel_copies.stamped``)."""
    return ck.stamped(src, WHAT, ANCHOR, (
        ("  cg::grid_group grid = cg::this_grid();\n",
         "  cg::grid_group grid = cg::this_grid();\n  stamp(0);\n"),
        ("  if (!pl.fused) {\n    // split P2",
         "  stamp(1);\n  if (!pl.fused) {\n    // split P2"),
        ("W_out[slab, tile]\n    grid.sync();\n",
         "W_out[slab, tile]\n    grid.sync();\n    stamp(2);\n"),
        ("  copies_wait<0>();\n  grid.sync();\n",
         "  stamp(3);\n  copies_wait<0>();\n  grid.sync();\n"
         "  stamp(4);\n"),
        ("  sum_partials(P, vec + 2 * dm);\n  grid.sync();\n",
         "  sum_partials(P, vec + 2 * dm);\n  stamp(5);\n"
         "  grid.sync();\n  stamp(6);\n"),
        ("  layer_norm_rows(P, vec, vec + dm);\n",
         "  layer_norm_rows(P, vec, vec + dm);\n  stamp(7);\n")))


K_LOOP = "    for (int k = 4 * g; k < K; k += 4 * kg) {"
X_COPY = ("  copy_tile(P.x, P.dm, r0, nr, P.batch, 0, P.dm, P.dm, rows, "
          "ld_of(P.dm));\n")

VARIANTS = {
    "stamped": stamped,
    "no_k_loop": lambda s: ck.edit(s, K_LOOP,
                                   K_LOOP.replace("k < K", "k < 0"), WHAT),
    "k_loop_twice": lambda s: ck.edit(
        s, K_LOOP, "    for (int rep = 0; rep < 2; ++rep)\n" + K_LOOP,
        WHAT),
    "no_x_copy": lambda s: ck.edit(s, X_COPY, "", WHAT),
}


def forced_plan(kds, b, fused, ct1, rg, ks=0, ct2=0, grid=132):
    """An FfnPlan with these tiles (P3's lanes and the sizes as
    ``ffn_plan`` derives them)."""
    slabs = -(-DI // (ct1 if fused else ks))
    lanes = 1
    while (lanes < 32 and lanes < slabs
           and 2 * lanes * b * (DM // 4) <= grid * kds.FFN_THREADS):
        lanes *= 2
    return kds.FfnPlan(grid, fused, ct1, rg, ks, ct2, slabs, lanes,
                       (0 if fused else b * DI) + slabs * b * DM,
                       4 * kds.ffn_floats(DM, fused, ct1, rg, ks, ct2))


def main():
    if not torch.cuda.is_available():
        print("chip_ffn_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import decode_step as kds

    print(ck.card())
    torch.backends.cuda.matmul.allow_tf32 = False
    tree = _build.lib()
    gen = torch.Generator().manual_seed(0)
    _, ffn = cs._decode_weights(gen)
    weights = [ffn[k] for k in ("ffn_in_w", "ffn_in_b", "ffn_out_w",
                                "ffn_out_b", "ln3_scale", "ln3_bias")]

    def call(lib, x, plan):
        b = x.shape[0]
        buf = torch.empty(b * DM + plan.scratch, device="cuda")
        err = lib.ptt_ffn(x.data_ptr(), *(w.data_ptr() for w in weights),
                          buf.data_ptr(), buf.data_ptr() + 4 * b * DM, b, DM,
                          DI, *plan.ints(), 1e-5,
                          torch.cuda.current_stream().cuda_stream)
        _build.check(err, "ffn")
        return buf[:b * DM].view(b, 1, DM)

    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(_build.CSRC_DIR, "ffn.cu")) as f:
            src = f.read()
        libs = ck.build(_build, out_dir,
                        {name: make(src) for name, make in VARIANTS.items()},
                        ["ptt_ffn"])
        libs["tree"] = tree
        for b in BATCHES:
            x = cs.randn(gen, b, 1, DM)
            want = kds.reference_ffn(x, **ffn)
            plan = kds.device_ffn_plan(x.device, b, DM, DI)
            err = (call(tree, x, plan) - want).abs().max().item()
            cs.require(err <= cs.TOL_KERNEL, f"ffn b={b}: max abs err {err}")
            names = ["tree", "no_k_loop", "k_loop_twice", "no_x_copy"]
            device_us = {n: [] for n in names}
            for order in (names, names[::-1]):
                for n in order:
                    device_us[n].append(1e3 * cs.cuda_ms(
                        lambda: call(libs[n], x, plan), hide_host=True))
            print(json.dumps(dict(batch=b, plan=plan._asdict(),
                                  max_abs_err=err, device_us=device_us)))

            rows = min(64, 1 << (b - 1).bit_length())
            others = [forced_plan(kds, b, 1, ct1, rows) for ct1 in (16, 32)]
            others += [forced_plan(kds, b, 0, ct1, min(rg, rows), ks, ct2)
                       for ct1, rg, ks, ct2 in ((16, 64, 128, 64),
                                                (32, 32, 256, 64),
                                                (16, 64, 64, 64))]
            for other in others:
                if other.smem > kds.MEGASTEP_SMEM_CAP or other == plan:
                    continue
                err = (call(tree, x, other) - want).abs().max().item()
                print(json.dumps(dict(
                    batch=b, plan=other._asdict(), max_abs_err=err,
                    device_us=1e3 * cs.cuda_ms(lambda: call(tree, x, other),
                                               hide_host=True))))

            med = ck.phase_ends(libs["stamped"], plan.grid, len(PHASES),
                                lambda: call(libs["stamped"], x, plan))
            split = {p: round(float(v), 3) for p, v in zip(PHASES, med)
                     if plan.fused == 0 or "split" not in p}
            print(json.dumps(dict(batch=b, phase_end_us=split)))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
