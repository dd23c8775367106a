"""Alternate two checkouts of the port on one card: the Transformer
training step on the flag-off and the fused route, the BERT-base step on
the bhtd route, the ResNet-50 step and #1 at its smallest plan case, each
checkout in processes of its own.

    python3 chip_ab.py OTHER_CHECKOUT [--rounds 4] [--what all]

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
  each of its kernels' device time per call under ``torch.profiler``;
* the fused decode step, phase 3's main path and (b): Transformer-base
  greedy generation on ring caches and on paged pools at b=1 and b=64
  (source 256, 64 tokens): the median and 80th percentile of the 64
  steps of ``time_session`` by the host clock, then 16 steps under
  ``torch.profiler`` (``profile_serving``) for the device-busy time a
  step, the megastep's and the FFN's shares of it and the idle share;
* the unfused decode step (``fused_decode_step=False``: #14/#15, 12
  launches a token) on ring caches at b=1 and b=64 and on paged pools at
  b=64, measured the same way, with flash-decode's device time a step;
* the decode kernels alone, on phase 2's draws at b=64, 1, 33 and full
  caches at b=64 (``measure_decode_kernels``): the megastep's (#10, #12)
  outputs and updated caches as a digest, compared across the checkouts,
  and its device time; flash-decode's (#14, #15) device time after the
  L2 flush and with its inputs warm in the L2.

``--what deepfm`` measures, instead of all of those:

* the DeepFM step, phase 3 (h): batch 4096, 26 slots of 1000001 rows,
  lazy Adam; 3 untimed steps, then ``DEEPFM_TIMED_STEPS`` steps by the
  host clock, then one step under ``torch.profiler``: its device-busy
  time, #22's and #23's device time (and any sort kernel's) in it;
* #22 and #23 alone at DeepFM's shapes (``measure_table_kernels``): #23
  in Adam mode on both groups and in SGD and scatter-add modes on the
  width-10 group, at each of ``chip_smoke.APPLY_MIXES``; device time of
  a call (``device_ms``), the call with the host's enqueue
  (``call_ms``), a stable ``torch.sort`` of the same ids alone
  (``sort_ms``), and the updated rows as a digest compared across the
  checkouts; #22 on both groups at hash_dim 1000001 and on the same
  tables with the ids mod 10001;
* where the checkout's #23 sorts in its launch, that launch's phase ends
  at each mix (``apply_phase_ends``: a copy stamped by
  ``chip_kernel_copies``), which split its time into the sort and the
  apply.

``--what decode`` (or ``training``) measures only the decode steps (or
only the rest of the list above).

Prints, per checkout, the median and range of each number over its
processes, and whether every process of both checkouts gave the
megastep the same digest in each case; every process's record goes to
``chiprun_out/chip_ab.json``.
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
#: the decode kernels' cases alone: (case, b, full caches)
KERNEL_CASES = (("b=64", 64, False), ("b=1", 1, False),
                ("b=33", 33, False), ("full b=64", 64, True))


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


def _warm_ms(fn, iters=20):
    """Median device time of one fn() call with its inputs warm in the
    L2: each timed call follows an untimed one on the same inputs, both
    behind a 1 ms device-side spin that hides the host's enqueue."""
    import torch

    fn()
    events = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return _median([s.elapsed_time(e) for s, e in events])


def measure_decode_kernels(cs):
    """The megastep (#10, #12) and flash-decode (#14, #15) alone, on
    phase 2's draws (``_decode_inputs``, ``_paged_inputs``,
    ``_flash_decode_inputs``) in each of KERNEL_CASES, every case on a
    generator of its own: {kernel and case: record}.  The megastep's
    output and updated self cache as a sha256 digest, and its device time
    (``cuda_ms`` with ``hide_host``); flash-decode's device time on both
    sides after the L2 flush (``device_ms``) and warm (:func:`_warm_ms`).
    """
    import hashlib

    import torch

    from paddle_tpu_torch.kernels import decode_attention as kda
    from paddle_tpu_torch.kernels import decode_step as kds

    h, dh = cs.BASE["n_head"], cs.BASE["d_key"]
    scale = dh ** -0.5
    kw = dict(layer=cs.BASE["n_layer"] // 2, n_head=h, scale=scale)
    out = {}
    for case, b, full in KERNEL_CASES:
        for name, draw, fn in (
                ("megastep", cs._decode_inputs, kds.megastep),
                ("megastep_paged", cs._paged_inputs, kds.megastep_paged)):
            gen = torch.Generator().manual_seed(b + full)
            x, w, _, caches, ints = draw(gen, b, full)

            def step():
                return fn(x, **w, **caches, **ints, **kw)

            digest = hashlib.sha256()
            for t in (step(), caches["cache_k"], caches["cache_v"]):
                digest.update(t.cpu().numpy().tobytes())
            out[f"{name} {case}"] = dict(
                digest=digest.hexdigest(),
                device_ms=cs.cuda_ms(step, hide_host=True))
            del x, w, caches, ints
        for side in ("self", "cross"):
            gen = torch.Generator().manual_seed(b + full)
            q, k, v, lens, table, k_pool, v_pool = cs._flash_decode_inputs(
                gen, b, side, full)
            for name, fn in (
                    ("flash_decode",
                     lambda: kda.flash_decode(q, k, v, lens, scale)),
                    ("flash_decode_paged",
                     lambda: kda.flash_decode_paged(q, k_pool, v_pool,
                                                    table, lens, scale))):
                out[f"{name} {side} {case}"] = dict(
                    device_ms=cs.cuda_ms(fn, hide_host=True),
                    warm_ms=_warm_ms(fn))
            del q, k, v, k_pool, v_pool
    torch.cuda.empty_cache()
    return out


def _digest(tensors):
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def measure_table_kernels(cs):
    """#22 and #23 alone at DeepFM's shapes: {kernel, group, mode and
    mix: record} (see the module's note)."""
    import torch

    from paddle_tpu_torch.kernels import embedding as ke

    gen = torch.Generator(device=cs.DEV).manual_seed(22)
    v, s_n, b = cs.DEEPFM_HASH, cs.DEEPFM_SLOTS, cs.DEEPFM_BATCH
    consts = (0.9, 0.999, 1e-8)
    lr_t = torch.tensor([cs.DEEPFM_LR * 0.5], device=cs.DEV)
    out = {}
    for group, d in cs.DEEPFM_GROUPS:
        tables = [cs._randn(gen, v, d, scale=0.01) for _ in range(s_n)]
        m1s = [cs._randn(gen, v, d, scale=0.01) for _ in range(s_n)]
        m2s = [cs._randn(gen, v, d, scale=0.01).square()
               for _ in range(s_n)]
        rows = cs._randn(gen, s_n, b, d, scale=0.1)
        ids = cs._deepfm_ids(b, v, seed=0)
        for span, gids in (("1000001", ids), ("10001", ids % 10001)):
            def gather():
                return ke.multi_table_gather(tables, gids)

            out[f"gather {group} hash {span}"] = dict(
                digest=_digest([gather()]),
                device_ms=cs.cuda_ms(gather, hide_host=True),
                call_ms=cs.cuda_ms(gather))
        for mix, draw in cs.APPLY_MIXES.items():
            ids = draw(b, v, seed=10)
            run_max = max(int(torch.unique(i[(i >= 0) & (i < v)],
                                           return_counts=True)[1].max())
                          for i in ids)
            modes = [("adam", None)]
            if d > 1:
                modes += [("sgd", -cs.DEEPFM_LR), ("scatter_add", 1.0)]
            for mode, scale in modes:
                if mode == "adam":
                    def call(state=(tables, m1s, m2s)):
                        ke.multi_table_sparse_adam(*state, ids, rows, lr_t,
                                                   *consts)
                    kinds = (tables, m1s, m2s)
                else:
                    def call(state=(tables,), scale=scale):
                        ke.multi_table_scatter_add(*state, ids, rows, scale)
                    kinds = (tables,)
                state = tuple([t.clone() for t in kind] for kind in kinds)
                call(state)
                touched = [t[torch.where((i >= 0) & (i < v), i, 0).long()]
                           for kind in state for t, i in zip(kind, ids)]
                digest = _digest(touched)
                del state, touched
                out[f"apply {group} {mode} {mix}"] = dict(
                    digest=digest, run_max=run_max,
                    device_ms=cs.cuda_ms(call, hide_host=True),
                    call_ms=cs.cuda_ms(call),
                    sort_ms=cs.cuda_ms(lambda: torch.sort(
                        ids, dim=1, stable=True), hide_host=True))
        del tables, m1s, m2s, rows
    torch.cuda.empty_cache()
    return out


#: #23's phase ends: the blocks' starts, phase A (the sort blocks' runs
#: listed, the others' prefetch), the grid barrier's release, the end
APPLY_PHASES = ("start spread", "phase A", "barrier", "end")


def apply_phase_ends(cs, root):
    """{mix: phase ends in us} of #23 in Adam mode on the width-10 group,
    from a copy of the checkout's ``csrc/embedding.cu`` whose blocks stamp
    ``%globaltimer`` at APPLY_PHASES (``chip_kernel_copies``); None for a
    checkout whose kernel has no such phases."""
    import tempfile

    import torch

    import chip_kernel_copies as ck
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import embedding as ke

    path = os.path.join(root, "paddle_tpu_torch", "csrc", "embedding.cu")
    with open(path) as f:
        src = f.read()
    if "plan_slot" not in src:
        return None
    src = ck.stamped(src, "csrc/embedding.cu",
                     "template <int MODE, int DT>\n"
                     "__global__ void __launch_bounds__(NT)\n"
                     "    apply_kernel(", (
        ("  const int t = threadIdx.x;\n\n  // phase A",
         "  const int t = threadIdx.x;\n  stamp(0);\n\n  // phase A"),
        ("  cg::this_grid().sync();\n",
         "  stamp(1);\n  cg::this_grid().sync();\n  stamp(2);\n"),
        ("      lane_runs<MODE, DT>(P, runs, x0);\n  }\n",
         "      lane_runs<MODE, DT>(P, runs, x0);\n  }\n  stamp(3);\n")))
    gen = torch.Generator(device="cuda").manual_seed(23)
    v, s_n, b, d = cs.DEEPFM_HASH, cs.DEEPFM_SLOTS, cs.DEEPFM_BATCH, 10
    tables, m1s, m2s = ([cs._randn(gen, v, d, scale=0.01)
                         for _ in range(s_n)] for _ in range(3))
    rows = cs._randn(gen, s_n, b, d, scale=0.1)
    lr_t = torch.tensor([cs.DEEPFM_LR * 0.5], device="cuda")
    out = {}
    with tempfile.TemporaryDirectory() as out_dir:
        lib = ck.build(_build, out_dir, {"apply_stamped": src},
                       ["ptt_table_apply", "ptt_table_apply_occupancy"])[
                           "apply_stamped"]
        saved = _build._lib
        ke._device_apply_plan.cache_clear()
        _build._lib = lib
        try:
            grid = ke.device_apply_plan(tables[0].device, 1, s_n, b, d,
                                        v).grid
            for mix, draw in cs.APPLY_MIXES.items():
                ids = draw(b, v, seed=10)
                ends = ck.phase_ends(lib, grid, len(APPLY_PHASES),
                                     lambda: ke.multi_table_sparse_adam(
                                         tables, m1s, m2s, ids, rows, lr_t,
                                         0.9, 0.999, 1e-8))
                out[mix] = dict(zip(APPLY_PHASES, ends.tolist()))
        finally:
            _build._lib = saved
            ke._device_apply_plan.cache_clear()
    del tables, m1s, m2s, rows
    torch.cuda.empty_cache()
    return out


def measure_deepfm(cs):
    """The DeepFM step (see the module's note): {"deepfm": record}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch

    model = paddle_tpu_torch.DeepFM(hash_dim=cs.DEEPFM_HASH,
                                    device=cs.DEV).init_params(0)
    opt = cs._deepfm_adam(model)
    batches = cs.deepfm_batches(cs.DEEPFM_HASH)
    cs._deepfm_steps(model, opt, batches, WARM_STEPS)
    step_ms = []
    for i in range(1, cs.DEEPFM_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = model(*batches[i % len(batches)])
        opt.minimize(loss)
        loss.item()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        opt.minimize(model(*batches[0])[0])
        torch.cuda.synchronize()
    rows = cs._device_kernels(prof)

    def ms(word):
        return sum(us for n, us in rows if word in n.lower()) / 1e3

    rec = dict(step_ms=_median(step_ms),
               step_ms_range=(min(step_ms), max(step_ms)),
               busy_ms=sum(us for _, us in rows) / 1e3,
               gather_ms=ms("gather_kernel"), apply_ms=ms("apply_kernel"),
               sort_ms=ms("sort"))
    del model, opt, batches
    torch.cuda.empty_cache()
    return {"deepfm": rec}


def measure_decode(cs):
    """The fused decode steps on ring caches and on paged pools at b=1
    and b=64, and the unfused ones (#14/#15) on ring caches at b=1 and
    b=64 and on paged pools at b=64: {route: record}."""
    import paddle_tpu_torch
    from paddle_tpu_torch import GenerationSession

    model = paddle_tpu_torch.Transformer(**cs.BASE).init_params(seed=0)
    unfused = paddle_tpu_torch.Transformer(**cs.BASE,
                                           fused_decode_step=False)
    unfused.load_state_dict(model.state_dict())
    routes = [(model, paged, b, "") for paged in (False, True)
              for b in cs.BATCHES]
    routes += [(unfused, False, b, "_unfused") for b in cs.BATCHES]
    routes += [(unfused, True, max(cs.BATCHES), "_unfused")]
    steps = {}
    for m, paged, b, tag in routes:
        sess = GenerationSession(m, b, cs.SRC_LEN, cs.MAX_OUT, bos_id=0,
                                 eos_id=-1, paged=paged)
        timed = cs.time_session(sess, cs.source_batch(b, seed=b))
        prof = cs.profile_serving(m, b, paged=paged, tag=tag)["decode"]
        steps[f"decode_{'paged' if paged else 'ring'}{tag}_b{b}"] = dict(
            step_ms=timed["step_ms_p50"], step_ms_p80=timed["step_ms_p80"],
            busy_ms=prof["device_busy_ms"], megastep_ms=prof["megastep_ms"],
            ffn_ms=prof["ffn_ms"], flash_decode_ms=prof["flash_decode_ms"],
            idle_share=prof["idle_share"])
        del sess
    return steps


def measure(root, what="all"):
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

    if what == "decode":
        return dict(root=root, steps=measure_decode(cs),
                    kernels=measure_decode_kernels(cs))
    if what == "deepfm":
        return dict(root=root, steps=measure_deepfm(cs),
                    kernels=measure_table_kernels(cs),
                    apply_phases_us=apply_phase_ends(cs, root))
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
    rec = dict(root=root, steps=steps, t8_ms=t8_ms,
               t8_device_ms=t8_device_ms,
               t8_kernels_us=_per_call_us(cs, prof, calls))
    if what == "all":
        steps.update(measure_decode(cs))
        rec["kernels"] = measure_decode_kernels(cs)
    return rec


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return (xs[n // 2] + xs[(n - 1) // 2]) / 2


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--what", choices=("all", "decode", "training",
                                       "deepfm"),
                    default="all")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    if args.child:
        print(json.dumps(measure(other, args.what)))
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
                 "--child", "--what", args.what], cwd=root,
                capture_output=True, text=True)
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:],
                      file=sys.stderr)
                return 1
            rec = json.loads(out.stdout.strip().splitlines()[-1])
            rec.update(round=r, checkout=labels[root],
                       process_s=time.perf_counter() - t0)
            runs.append(rec)
            print(json.dumps({k: v for k, v in rec.items()
                              if k not in ("t8_kernels_us", "kernels")}),
                  flush=True)
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
        if args.what in ("all", "training"):
            for key in ("t8_ms", "t8_device_ms"):
                xs = [r[key] for r in mine]
                summary[key] = (_median(xs), min(xs), max(xs))
            names = sorted({n for r in mine for n in r["t8_kernels_us"]})
            summary["t8_kernels_us"] = {
                n: _median([r["t8_kernels_us"].get(n, 0.0) for r in mine])
                for n in names}
        for key in mine[0].get("kernels", {}):
            for field in ("device_ms", "warm_ms", "call_ms", "sort_ms"):
                if field in mine[0]["kernels"][key]:
                    xs = [r["kernels"][key][field] for r in mine]
                    summary[f"{key} {field}"] = (_median(xs), min(xs),
                                                 max(xs))
        print(f"{label} ({len(mine)} processes; median, min, max): "
              f"{json.dumps(summary)}")
    if "kernels" in runs[0]:
        same = {key: len({r["kernels"][key]["digest"] for r in runs}) == 1
                for key in runs[0]["kernels"]
                if "digest" in runs[0]["kernels"][key]}
        print(f"bits equal in every process of both checkouts: "
              f"{json.dumps(same)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
