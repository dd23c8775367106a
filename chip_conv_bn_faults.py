"""Plant a fault in a copy of the conv + BN kernels and read what
chip_smoke.py's checks make of it.

    python3 chip_conv_bn_faults.py [none|sums_21|sums_18_19|residual_bf16|stats_unrounded]

Copies ``paddle_tpu_torch/`` (without its ``_build/``) and ``chip_smoke.py``
into a temporary directory, edits ``csrc/conv_bn.cu`` (and
``csrc/gemm.cuh``) there as the fault says, builds that copy and runs
chip_smoke's phase 2 conv + BN checks in f32 and bf16 (``check_conv_bn``,
``check_conv_bn_bf16``), its phase 3 (g) (``run_resnet``, ResNet-50 at
batch 256) and (l) (``run_resnet_amp``, the same under bf16 amp) with
every failed check printed instead of raised.  The faults:

* ``none``: the copy as it is, the readings of the sound kernels on the
  same data;
* ``sums_21``: #21 (f32 and bf16) leaves its last chunk of rows out of
  sum g' and sum g' x (dx and dres stay right);
* ``sums_18_19``: #18 leaves its last chunk of rows out of s1 and s2, #19
  (f32 and bf16) its last 128-row tile;
* ``residual_bf16``: #20 in bf16 drops its residual (the f32 kernel
  keeps it);
* ``stats_unrounded``: #19 in bf16 sums its columns from the f32
  accumulators instead of the stored, rounded y.

The sums faults drop one chunk of rows, the kind of fault an off-by-one
in a chunk's bounds makes.  Prints the checks that failed, then one JSON
line of readings: each phase 2 record's ``sum_err_of_terms`` and (g)'s and
(l)'s parity, route and running-statistics readings.  Exits 0 whatever
the checks read, 2 without a card.  The tree it was started from is not
changed.
"""

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CU, CUH = "conv_bn.cu", "gemm.cuh"

#: fault -> [(file in csrc/, text in it, its replacement)]
FAULTS = {
    "none": [],
    "sums_21": [(
        CU,
        "          sg[j] += gf;\n"
        "          sgx[j] += gf * lane<T>(xv[u], j);\n",
        "          if (blockIdx.y + 1 < gridDim.y) {\n"
        "          sg[j] += gf;\n"
        "          sgx[j] += gf * lane<T>(xv[u], j);\n"
        "          }\n")],
    "sums_18_19": [(
        CU,
        "            const float f = lane<T>(v[u], j);\n",
        "            const float f = blockIdx.y + 1 < gridDim.y\n"
        "                ? lane<T>(v[u], j) : 0.f;\n"), (
        CU,
        "    part[((size_t)stat * gridDim.y + blockIdx.y) * N + n] = s;\n",
        "    part[((size_t)stat * gridDim.y + blockIdx.y) * N + n] =\n"
        "        blockIdx.y + 1 < gridDim.y ? s : 0.f;\n"), (
        CUH,
        "          red[2 * stat * GT + col] + red[(2 * stat + 1) * GT + col];\n",
        "          (blockIdx.y + 1 < gridDim.y ? 1.f : 0.f) *\n"
        "          (red[2 * stat * GT + col] + red[(2 * stat + 1) * GT + col]);"
        "\n")],
    "residual_bf16": [(
        CU,
        "        if (RES) v = Arith<T>::add(v, rv[u].w[i]);\n",
        "        (void)rv;\n")],
    "stats_unrounded": [(
        CUH,
        "          const float2 v = stored_pair(c, x, y);\n",
        "          const float2 v = make_float2(x, y);\n")],
}


def planted_copy(fault, dest):
    """Copy the package and chip_smoke.py into ``dest`` and plant
    ``fault``; each edited text must occur once in its source."""
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                    os.path.join(dest, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dest)
    for name, old, new in FAULTS[fault]:
        path = os.path.join(dest, "paddle_tpu_torch", "csrc", name)
        with open(path) as f:
            src = f.read()
        if src.count(old) != 1:
            raise SystemExit(f"{fault}: the text to edit is not in {name} "
                             f"once: {old!r}")
        with open(path, "w") as f:
            f.write(src.replace(old, new))


def main():
    fault = sys.argv[1] if len(sys.argv) > 1 else "none"
    if fault not in FAULTS:
        raise SystemExit(f"unknown fault {fault!r}: one of {list(FAULTS)}")
    import torch

    if not torch.cuda.is_available():
        print("chip_conv_bn_faults: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as dest:
        planted_copy(fault, dest)
        sys.path.insert(0, dest)
        import chip_smoke as cs
        import paddle_tpu_torch

        assert paddle_tpu_torch.__file__.startswith(dest)
        failed = []

        def report(cond, msg):
            if not cond:
                failed.append(msg)
                print(f"{fault}: check failed: {msg}", flush=True)

        cs.require = report
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from paddle_tpu_torch.kernels import _build

        _build.lib()
        gen = torch.Generator().manual_seed(0)
        records = cs.check_conv_bn(gen)
        records.update(cs.check_conv_bn_bf16(gen))
        model = paddle_tpu_torch.ResNet(
            cs.RESNET_DEPTH, cs.RESNET_CLASSES).init_params(seed=0)
        run, parity = cs.run_resnet(model)
        amp_model = paddle_tpu_torch.ResNet(cs.RESNET_DEPTH,
                                            cs.RESNET_CLASSES)
        amp_model.load_state_dict(parity["init"])
        paddle_tpu_torch.amp.enable(amp_model)
        amp_run = cs.run_resnet_amp(amp_model, parity, run)
        keys = ("parity_rel_worst", "parity_grad_rel_median", "routes_loss",
                "routes_grad_rel_worst", "routes_grad_rel_median",
                "routes_stats_rel_worst")
        print(json.dumps({
            "fault": fault, "failed_checks": len(failed),
            "sum_err_of_terms": {f"{name} {case}": r["sum_err_of_terms"]
                                 for (name, case), r in records.items()
                                 if "sum_err_of_terms" in r},
            "resnet": {k: run[k] for k in keys},
            "resnet_amp": {k: amp_run[k] for k in keys + (
                "parity_losses", "parity_loss_rel", "parity_state_rel_median",
                "parity_norm_worst", "parity_norm_median", "parity_cos_median",
                "parity_head")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
