"""Plant a fault in a copy of the conv + BN kernels and read what
chip_smoke.py's checks make of it.

    python3 chip_conv_bn_faults.py [none|sums_21|sums_18_19]

Copies ``paddle_tpu_torch/`` (without its ``_build/``) and ``chip_smoke.py``
into a temporary directory, edits ``csrc/conv_bn.cu`` there as the fault
says, builds that copy and runs chip_smoke's phase 2 conv + BN checks
(``check_conv_bn``) and its phase 3 (g) (``run_resnet``, ResNet-50 at
batch 256) with every failed check printed instead of raised.  The
faults leave every output alone and drop one chunk of rows from the
per-channel sums, the kind of fault an off-by-one in a chunk's bounds
makes:

* ``none``: the copy as it is, the readings of the sound kernels on the
  same data;
* ``sums_21``: #21 leaves its last chunk of rows out of sum g' and
  sum g' x (dx and dres stay right);
* ``sums_18_19``: #18 leaves its last chunk of rows out of s1 and s2, #19
  its last 128-row tile.

Prints the checks that failed, then one JSON line of readings: each
phase 2 record's ``sum_err_of_terms`` and (g)'s parity, route and
running-statistics readings.  Exits 0 whatever the checks read, 2 without
a card.  The tree it was started from is not changed.
"""

import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))

#: fault -> [(text in csrc/conv_bn.cu, its replacement)]
FAULTS = {
    "none": [],
    "sums_21": [(
        "      sg[0] += gv.x; sg[1] += gv.y; sg[2] += gv.z; sg[3] += gv.w;\n"
        "      sgx[0] += gv.x * xv.x; sgx[1] += gv.y * xv.y;\n"
        "      sgx[2] += gv.z * xv.z; sgx[3] += gv.w * xv.w;\n",
        "      if (blockIdx.y + 1 < gridDim.y) {\n"
        "      sg[0] += gv.x; sg[1] += gv.y; sg[2] += gv.z; sg[3] += gv.w;\n"
        "      sgx[0] += gv.x * xv.x; sgx[1] += gv.y * xv.y;\n"
        "      sgx[2] += gv.z * xv.z; sgx[3] += gv.w * xv.w;\n"
        "      }\n")],
    "sums_18_19": [(
        "      const float4 v = y4[r * qn + q];\n",
        "      const float4 v = blockIdx.y + 1 < gridDim.y\n"
        "          ? y4[r * qn + q] : make_float4(0.f, 0.f, 0.f, 0.f);\n"), (
        "    part[((size_t)stat * gridDim.y + blockIdx.y) * N + n] = s;\n",
        "    part[((size_t)stat * gridDim.y + blockIdx.y) * N + n] =\n"
        "        blockIdx.y + 1 < gridDim.y ? s : 0.f;\n")],
}


def planted_copy(fault, dest):
    """Copy the package and chip_smoke.py into ``dest`` and plant
    ``fault``; each edited text must occur once in the source."""
    shutil.copytree(os.path.join(ROOT, "paddle_tpu_torch"),
                    os.path.join(dest, "paddle_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dest)
    path = os.path.join(dest, "paddle_tpu_torch", "csrc", "conv_bn.cu")
    with open(path) as f:
        src = f.read()
    for old, new in FAULTS[fault]:
        if src.count(old) != 1:
            raise SystemExit(f"{fault}: the text to edit is not in "
                             f"conv_bn.cu once: {old!r}")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)


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
        records = cs.check_conv_bn(torch.Generator().manual_seed(0))
        model = paddle_tpu_torch.ResNet(
            cs.RESNET_DEPTH, cs.RESNET_CLASSES).init_params(seed=0)
        run = cs.run_resnet(model)
        print(json.dumps({
            "fault": fault, "failed_checks": len(failed),
            "sum_err_of_terms": {f"{name} {case}": r["sum_err_of_terms"]
                                 for (name, case), r in records.items()
                                 if "sum_err_of_terms" in r},
            "resnet": {k: run[k] for k in (
                "parity_rel_worst", "parity_grad_rel_median",
                "routes_loss", "routes_grad_rel_worst",
                "routes_grad_rel_median", "routes_stats_rel_worst")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
