"""Alternate two checkouts of the port on one card: the fused Transformer
training step and #1 at its smallest plan case, each checkout in
processes of its own.

    python3 chip_ab.py OTHER_CHECKOUT [--rounds 4]

OTHER_CHECKOUT is the root of another checkout of this repository (for
example the parent commit, unpacked by ``git archive``).  Each round runs
OTHER, THIS, THIS, OTHER, one process each, so that a drift of the card
or of the host during the call falls on both alike.  Every process
imports ``paddle_tpu_torch`` from its checkout (building its kernels, or
reusing them) and runs this checkout's measuring code from
``chip_smoke.py``:

* the fused training step, ``chip_smoke.py`` phase 3 (e): Transformer-
  base on the default route, batch 32, source and target 256, Adam; 3
  untimed steps, then ``TRAIN_TIMED_STEPS`` steps by the host clock
  (the launch counts and the falling loss checked as there), then one
  step under ``torch.profiler`` for its device-busy time;
* #1 (``qkv_attention_fwd`` with residuals) at t 8, b 4, d_model 512:
  CUDA events after an L2 flush with the host's enqueue counted
  (``cuda_ms``, as phase 2 times it) and hidden (``hide_host``), and
  each of its kernels' device time per call under ``torch.profiler``.

Prints, per checkout, the median and range of each number over its
processes; every process's record goes to ``chiprun_out/chip_ab.json``.
Needs one card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: #1's case: (b, t, d_model, bias), chip_smoke.py's QKV_PLAN_CASES "t 8"
QKV_T8 = (4, 8, 512, "pad")
WARM_STEPS = 3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _per_call_us(cs, prof, calls):
    """{kernel name: device us per call} of a profiled run of ``calls``
    calls."""
    return {name[:80]: us / calls for name, us in cs._device_kernels(prof)}


def measure(root):
    """One process's measurements of the checkout at ``root``."""
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch
    from paddle_tpu_torch import Adam
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import attention as ka

    pkg = os.path.dirname(os.path.abspath(paddle_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"paddle_tpu_torch came from {pkg}, not {root}")
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.lib()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    L = cs.BASE["n_layer"]
    model = paddle_tpu_torch.Transformer(**cs.BASE).init_params(seed=1)
    opt = Adam(model.parameters(), learning_rate=cs.TRAIN_LR)
    feed = cs._to(cs.training_batch(seed=2), "cuda")
    for _ in range(WARM_STEPS):
        opt.minimize(model(**feed)[0])
    torch.cuda.synchronize()
    step = cs._timed_training(model, opt, dict(
        qkv_attention_fwd=2 * L, qkv_bwd_dq=2 * L, qkv_bwd_dkv=2 * L,
        flash_fwd=L, flash_bwd_dq=L, flash_bwd_dkv=L))
    with profile(activities=acts) as prof:
        opt.minimize(model(**feed)[0])
        torch.cuda.synchronize()
    busy_ms = sum(us for _, us in cs._device_kernels(prof)) / 1e3
    del model, opt, feed

    b, t, dm, bias_kind = QKV_T8
    gen = torch.Generator().manual_seed(0)
    x, w_qkv, w_out, _, bias = cs._qkv_inputs(gen, t, bias_kind, b, dm)
    kw = dict(n_head=dm // 64, scale=64 ** -0.5, causal=False)

    def fwd():
        return ka.qkv_attention_fwd(x, w_qkv, w_out, bias, **kw)

    t8_ms = cs.cuda_ms(fwd)
    t8_device_ms = cs.cuda_ms(fwd, hide_host=True)
    calls = 20
    fwd()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        for _ in range(calls):
            fwd()
        torch.cuda.synchronize()
    return dict(root=root, step_ms=step["step_ms_median"],
                step_ms_range=step["step_ms_range"], step_busy_ms=busy_ms,
                t8_ms=t8_ms, t8_device_ms=t8_device_ms,
                t8_kernels_us=_per_call_us(cs, prof, calls))


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return (xs[n // 2] + xs[(n - 1) // 2]) / 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    if args.child:
        print(json.dumps(measure(other)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    labels = {other: "other", HERE: "this"}
    runs = []
    for r in range(args.rounds):
        for root in (other, HERE, HERE, other):
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), root,
                 "--child"], cwd=root, capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:],
                      file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            rec.update(round=r, checkout=labels[root],
                       process_s=time.perf_counter() - t0)
            runs.append(rec)
            print(json.dumps({k: v for k, v in rec.items()
                              if k != "t8_kernels_us"}), flush=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_ab.json"), "w") as f:
        json.dump(runs, f, indent=1)
    for label in ("other", "this"):
        mine = [r for r in runs if r["checkout"] == label]
        summary = {}
        for key in ("step_ms", "step_busy_ms", "t8_ms", "t8_device_ms"):
            xs = [r[key] for r in mine]
            summary[key] = (_median(xs), min(xs), max(xs))
        names = sorted({n for r in mine for n in r["t8_kernels_us"]})
        summary["t8_kernels_us"] = {
            n: _median([r["t8_kernels_us"].get(n, 0.0) for r in mine])
            for n in names}
        print(f"{label} ({len(mine)} processes; median, min, max): "
              f"{json.dumps(summary)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
