#!/usr/bin/env python3
"""Where the decode FFN kernel (#11/#13, ``csrc/ffn.cu``) spends its time,
on one CUDA card, at Transformer-base's widths (d_model 512, d_inner
2048) and the batches 1, 33 and 64.

    python3 chip_ffn_phases.py

Builds temporary copies of ``csrc/ffn.cu`` (the tree is not changed):

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

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DM, DI = 512, 2048
BATCHES = (1, 33, 64)
#: phase ends of the stamped copy, in stamp order
PHASES = ("start spread", "P1 (and fused P2)", "split barrier", "split P2",
          "P3 barrier", "P3 sums", "LN barrier", "LN3")


def _edit(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError(f"chip_ffn_phases: csrc/ffn.cu no longer has "
                           f"{old!r} once")
    return src.replace(old, new)


def stamped(src):
    """csrc/ffn.cu with %globaltimer stamps at its phase ends and an
    entry point that copies them out (``ptt_ffn_stamps``)."""
    src = _edit(src, "__global__ void __launch_bounds__(NT, 1)", """\
__device__ unsigned long long g_stamps[1024 * 8];
__device__ __forceinline__ void stamp(int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[blockIdx.x * 8 + i] = t;
  }
}

__global__ void __launch_bounds__(NT, 1)""")
    for old, new in (
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
             "  layer_norm_rows(P, vec, vec + dm);\n  stamp(7);\n")):
        src = _edit(src, old, new)
    return src + """
extern "C" int ptt_ffn_stamps(unsigned long long* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_stamps, (size_t)n * 8);
}
"""


K_LOOP = "    for (int k = 4 * g; k < K; k += 4 * kg) {"
X_COPY = ("  copy_tile(P.x, P.dm, r0, nr, P.batch, 0, P.dm, P.dm, rows, "
          "ld_of(P.dm));\n")

VARIANTS = {
    "stamped": stamped,
    "no_k_loop": lambda s: _edit(s, K_LOOP, K_LOOP.replace("k < K", "k < 0")),
    "k_loop_twice": lambda s: _edit(
        s, K_LOOP, "    for (int rep = 0; rep < 2; ++rep)\n" + K_LOOP),
    "no_x_copy": lambda s: _edit(s, X_COPY, ""),
}


def build_variants(build, out_dir):
    """{name: ctypes library} of every variant, each built by its own
    nvcc beside the others."""
    with open(os.path.join(build.CSRC_DIR, "ffn.cu")) as f:
        src = f.read()
    jobs = []
    for name, edit in VARIANTS.items():
        path = os.path.join(out_dir, f"ffn_{name}.cu")
        with open(path, "w") as f:
            f.write(edit(src))
        so = os.path.join(out_dir, f"libffn_{name}.so")
        jobs.append((name, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-shared", "-I",
             build.CSRC_DIR, "-o", so, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{log}")
        lib = ctypes.CDLL(so)
        lib.ptt_ffn.restype, lib.ptt_ffn.argtypes = build._SIGNATURES[
            "ptt_ffn"]
        libs[name] = lib
    libs["stamped"].ptt_ffn_stamps.argtypes = [ctypes.c_void_p,
                                               ctypes.c_int]
    return libs


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

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
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
        libs = build_variants(_build, out_dir)
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

            n = plan.grid * 8
            host = (ctypes.c_ulonglong * n)()
            flush = torch.empty(64 * 2 ** 20, device="cuda")
            ends = []
            for _ in range(9):
                flush.zero_()
                torch.cuda._sleep(2_000_000)
                call(libs["stamped"], x, plan)
                torch.cuda.synchronize()
                _build.check(libs["stamped"].ptt_ffn_stamps(
                    ctypes.cast(host, ctypes.c_void_p), n), "stamps")
                st = np.array(host[:], dtype=np.float64).reshape(
                    plan.grid, 8)
                t0 = st[:, 0].min()
                ends.append([st[:, 0].max() - t0]
                            + [st[:, i].max() - t0 for i in range(1, 8)])
            med = np.median(np.array(ends), axis=0) / 1e3
            split = {p: round(float(v), 3) for p, v in zip(PHASES, med)
                     if plan.fused == 0 or "split" not in p}
            print(json.dumps(dict(batch=b, phase_end_us=split)))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
