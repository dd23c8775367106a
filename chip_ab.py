"""Alternate two checkouts of the port on one card: the Transformer
training step on the flag-off and the fused route, the BERT-base step on
the bhtd route, the ResNet-50 step and #1 at its smallest plan case, each
checkout in processes of its own.

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
  step under ``torch.profiler`` for its device-busy time and the
  backward walks' share of it (``flash_walk.cuh``'s dq and dkv kernels);
* the flag-off training step, phase 3 (d) (``fused_qkv_attention=False``:
  #4, #6, #7 at all 18 sites), measured the same way;
* the BERT-base step on the bhtd route, phase 3 (i) (``attention_fuse``:
  #5, #8, #9 at 12 sites, dropout 0.1), batch 128, seq 128, Adam 1e-4,
  measured the same way;
* the ResNet-50 step, phase 3 (g) (#18-#21 at their 17, 36, 53 and 53
  sites), batch 256 at 224, Momentum 0.1 / 0.9, measured the same way,
  with #19's device time in the profiled step (``dot_stats_ms``);
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

    def profiled(model, opt, feed, **kw):
        """(device busy ms, the backward walks' ms, #19's ms) of one
        step."""
        with profile(activities=acts) as prof:
            opt.minimize(model(**feed, **kw)[0])
            torch.cuda.synchronize()
        rows = cs._device_kernels(prof)
        return (sum(us for _, us in rows) / 1e3, cs._walks_us(rows) / 1e3,
                sum(us for n, us in rows if "dot_stats_kernel" in n) / 1e3)

    L = cs.BASE["n_layer"]
    steps = {}
    for route, fused, per_step in (
            ("fused", True, dict(
                qkv_attention_fwd=2 * L, qkv_bwd_dq=2 * L,
                qkv_bwd_dkv=2 * L, flash_fwd=L, flash_bwd_dq=L,
                flash_bwd_dkv=L)),
            ("flag_off", False, dict(flash_fwd=3 * L, flash_bwd_dq=3 * L,
                                     flash_bwd_dkv=3 * L))):
        model = paddle_tpu_torch.Transformer(
            **cs.BASE, fused_qkv_attention=fused).init_params(seed=1)
        opt = Adam(model.parameters(), learning_rate=cs.TRAIN_LR)
        feed = cs._to(cs.training_batch(seed=2), "cuda")
        for _ in range(WARM_STEPS):
            opt.minimize(model(**feed)[0])
        torch.cuda.synchronize()
        step = cs._timed_training(model, opt, per_step)
        busy_ms, walks_ms, _ = profiled(model, opt, feed)
        steps[route] = dict(step_ms=step["step_ms_median"],
                            step_ms_range=step["step_ms_range"],
                            busy_ms=busy_ms, walks_ms=walks_ms)
        del model, opt, feed

    from paddle_tpu_torch import BertPretrain, attention_fuse

    Lb = cs.BERT["n_layer"]
    bert = BertPretrain(**cs.BERT, dropout_rate=cs.DROPOUT,
                        device="cuda").init_params(0)
    attention_fuse(bert)
    opt = Adam(bert.parameters(), learning_rate=cs.BERT_LR)
    feed = cs._to(cs.bert_batch(cs.BERT_BATCH, seed=2), "cuda")
    gen = torch.Generator().manual_seed(3)
    for _ in range(WARM_STEPS):
        opt.minimize(bert(**feed, generator=gen)[0])
    torch.cuda.synchronize()
    step = cs._bert_timed(bert, opt, dict(
        flash_fwd_bhtd=Lb, flash_bwd_dq_bhtd=Lb, flash_bwd_dkv_bhtd=Lb,
        dropout_add_fwd=2 * Lb + 1, dropout_add_bwd=2 * Lb + 1), seed=4)
    busy_ms, walks_ms, _ = profiled(bert, opt, feed, generator=gen)
    steps["bert_bhtd"] = dict(step_ms=step["step_ms_median"],
                              step_ms_range=step["step_ms_range"],
                              busy_ms=busy_ms, walks_ms=walks_ms)
    del bert, opt, feed
    torch.cuda.empty_cache()

    from paddle_tpu_torch import Momentum, ResNet

    resnet = ResNet(cs.RESNET_DEPTH, cs.RESNET_CLASSES).init_params(seed=0)
    opt = Momentum(resnet.parameters(), cs.RESNET_LR, cs.RESNET_MOMENTUM)
    feed = cs._to(cs.resnet_batch(cs.RESNET_BATCH, seed=2), "cuda")
    for _ in range(WARM_STEPS):
        opt.minimize(resnet(**feed)[0])
    step_ms, _ = cs._resnet_timed(resnet, opt, feed)
    busy_ms, _, dot_ms = profiled(resnet, opt, feed)
    steps["resnet50"] = dict(step_ms=_median(step_ms),
                             step_ms_range=(min(step_ms), max(step_ms)),
                             busy_ms=busy_ms, dot_stats_ms=dot_ms)
    del resnet, opt, feed
    torch.cuda.empty_cache()

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
    return dict(root=root, steps=steps, t8_ms=t8_ms,
                t8_device_ms=t8_device_ms,
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
        for route in mine[0]["steps"]:
            for key in mine[0]["steps"][route]:
                if key == "step_ms_range":
                    continue
                xs = [r["steps"][route][key] for r in mine]
                summary[f"{route} {key}"] = (_median(xs), min(xs), max(xs))
        for key in ("t8_ms", "t8_device_ms"):
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
