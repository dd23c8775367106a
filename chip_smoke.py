#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100 is assumed for
the bounds).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch version on the card, at
   the shapes of the serving path, and time kernel, plain version and
   (where one exists) the one PyTorch call computing the same function;
3. the main path: greedy generation on Transformer-base (6 layers, 8
   heads, d_model 512, d_inner 2048, vocab 32000, source 256, 64 tokens)
   with seeded random weights, at batch 1 and batch 64, through
   ``GenerationSession.prefill`` and 64 ``decode_step`` calls.  The launch
   counters are zeroed just before each run and must read 6 qkv-attention
   launches per prefill and 6 megastep + 6 FFN launches per token.  The
   same model copied to the CPU (the plain path) is then run teacher-forced
   on the card's token stream, and its cross cache and logits at every
   step must agree with the card's;
4. where the time goes: torch.profiler over one prefill and 16 decode
   steps at each batch, device time by kernel beside host wall time.

Prints the card and its power limit, the timings, one JSON line with a
record per kernel, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA card or without the package
beside it.  f32 throughout, TF32 off for matmuls and cuDNN.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

#: kernel-vs-plain tolerance (abs and rel), f32 with TF32 off: the kernels
#: sum in other orders than cuBLAS, and the attention kernel adds heads
#: with atomics
TOL_KERNEL = 2e-4
#: end-to-end logits tolerance (abs and rel): 12 layers deep, card against
#: the CPU's plain path, 64 steps of cache built by each side
TOL_E2E = 2e-4

BASE = dict(src_vocab_size=32000, trg_vocab_size=32000, max_length=258,
            n_layer=6, n_head=8, d_key=64, d_value=64, d_model=512,
            d_inner_hid=2048)
SRC_LEN, MAX_OUT = 256, 64
BATCHES = (1, 64)

#: H100 SXM data-sheet peaks used for the bounds: HBM bytes/s and dense
#: f32 FLOP/s outside the tensor cores (the kernels run f32 FMAs)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
F32 = 4

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of one fn() call, each timed alone with CUDA
    events after writing a 256 MB buffer: the main path finds the L2 cold
    (its 6 layers' weights, 88 MB in the decode step, exceed the 50 MB
    L2), so a kernel timed back to back on the same warm inputs would
    read too fast."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    FLOPs over the f32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, got, want, tol):
    """Max abs error; raises unless |got - want| <= tol + tol*|want|."""
    got, want = got.float(), want.float()
    require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    err = (got - want).abs()
    worst = (err - tol * want.abs()).max().item()
    max_abs = err.max().item()
    require(worst <= tol, f"{name}: max abs err {max_abs} over tol {tol}")
    return max_abs


def randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).cuda()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_qkv_attention(gen, b):
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as ka

    t, dm, h, dh = SRC_LEN, BASE["d_model"], BASE["n_head"], BASE["d_key"]
    hd = h * dh
    x = randn(gen, b, t, dm)
    w_qkv = randn(gen, dm, 3 * hd, scale=dm ** -0.5)
    w_out = randn(gen, hd, dm, scale=hd ** -0.5)
    # padded tails of ragged lengths (row 0 unpadded), as the prefill's
    # key-padding bias
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen)
    lens[0] = t if b > 1 else t - 56
    pad = torch.arange(t)[None, :] >= lens[:, None]
    bias = (-1e9 * pad.float()).reshape(b, 1, 1, t).cuda()
    kw = dict(n_head=h, scale=dh ** -0.5)
    got = ka.flash_qkv_attention(x, w_qkv, w_out, bias, **kw)
    want = ka.reference_qkv_attention(x, w_qkv, w_out, bias, **kw)
    torch.cuda.synchronize()
    err = compare(f"qkv_attention_fwd b={b}", got, want, TOL_KERNEL)

    # one PyTorch call computing the same function (a yardstick only)
    xt = x.transpose(0, 1)
    mask = bias.reshape(b, t)

    def library():
        return F.multi_head_attention_forward(
            xt, xt, xt, dm, h, w_qkv.t(), None, None, None, False, 0.0,
            w_out.t(), None, training=False, key_padding_mask=mask,
            need_weights=False)[0]

    lib_err = (library().transpose(0, 1) - want).abs().max().item()
    flops = b * (2 * t * dm * 3 * hd + 4 * t * t * hd + 2 * t * hd * dm)
    nbytes = F32 * (2 * b * t * dm + dm * 3 * hd + hd * dm + b * t)
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(
        name="qkv_attention_fwd", route="cuda",
        source="paddle_tpu_torch/csrc/qkv_attention.cu",
        replaces="paddle_tpu/kernels/attention.py:1377",
        max_abs_err=err,
        ms=cuda_ms(lambda: ka.flash_qkv_attention(x, w_qkv, w_out, bias,
                                                  **kw)),
        plain_ms=cuda_ms(lambda: ka.reference_qkv_attention(
            x, w_qkv, w_out, bias, **kw)),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=cuda_ms(library),
        library_max_abs_err=lib_err, batch=b)


def _decode_inputs(gen, b):
    dm, h, dh = BASE["d_model"], BASE["n_head"], BASE["d_key"]
    di, L = BASE["d_inner_hid"], BASE["n_layer"]
    hd = h * dh
    w = dict(
        wqkv=randn(gen, dm, 3 * hd, scale=dm ** -0.5),
        wout=randn(gen, hd, dm, scale=hd ** -0.5),
        ln1_scale=1 + randn(gen, dm, scale=0.1), ln1_bias=randn(gen, dm,
                                                                 scale=0.1),
        wcq=randn(gen, dm, hd, scale=dm ** -0.5),
        wcout=randn(gen, hd, dm, scale=hd ** -0.5),
        ln2_scale=1 + randn(gen, dm, scale=0.1), ln2_bias=randn(gen, dm,
                                                                 scale=0.1))
    ffn = dict(
        ffn_in_w=randn(gen, dm, di, scale=dm ** -0.5),
        ffn_in_b=randn(gen, di, scale=0.1),
        ffn_out_w=randn(gen, di, dm, scale=di ** -0.5),
        ffn_out_b=randn(gen, dm, scale=0.1),
        ln3_scale=1 + randn(gen, dm, scale=0.1), ln3_bias=randn(gen, dm,
                                                                 scale=0.1))
    self_rows, cross_rows = 128, SRC_LEN
    caches = dict(
        cache_k=randn(gen, L, b, self_rows, h, dh),
        cache_v=randn(gen, L, b, self_rows, h, dh),
        cross_k=randn(gen, L, b, cross_rows, h, dh),
        cross_v=randn(gen, L, b, cross_rows, h, dh))
    # ragged positions mid-generation; the last lane inactive, lane 0 of a
    # batch > 1 with an empty cross cache
    pos = torch.randint(0, MAX_OUT, (b,), generator=gen)
    active = torch.ones(b, dtype=torch.int64)
    cross_len = torch.randint(1, cross_rows + 1, (b,), generator=gen)
    if b > 1:
        active[-1] = 0
        cross_len[0] = 0
    ints = dict(pos=pos, lengths=pos + active, cross_lengths=cross_len,
                active=active)
    ints = {k: v.to(torch.int32).cuda() for k, v in ints.items()}
    x = randn(gen, b, 1, dm)
    return x, w, ffn, caches, ints


def check_decode_kernels(gen, b):
    from paddle_tpu_torch.kernels import decode_step as kds

    x, w, ffn, caches, ints = _decode_inputs(gen, b)
    dm, h, dh = BASE["d_model"], BASE["n_head"], BASE["d_key"]
    di, hd = BASE["d_inner_hid"], h * dh
    kw = dict(layer=BASE["n_layer"] // 2, n_head=h, scale=dh ** -0.5)
    plain_caches = {k: v.clone() for k, v in caches.items()}
    got = kds.megastep(x, **w, **caches, **ints, **kw)
    want = kds.reference_megastep(x, **w, **plain_caches, **ints, **kw)
    torch.cuda.synchronize()
    err = compare(f"megastep b={b}", got, want, TOL_KERNEL)
    for name in ("cache_k", "cache_v"):
        err = max(err, compare(f"megastep {name} b={b}", caches[name],
                               plain_caches[name], TOL_KERNEL))
    # rows read by the walks, the k/v row written, the weights once
    act = ints["active"].long()
    self_rows = (ints["lengths"].long() - act).sum().item()
    cross_rows = ints["cross_lengths"].long().sum().item()
    n_act = act.sum().item()
    weights = 6 * dm * hd + 4 * dm
    mega_bytes = F32 * (weights + 2 * b * dm
                        + 2 * hd * (self_rows + cross_rows + n_act)) + 16 * b
    mega_flops = (2 * b * weights
                  + 4 * hd * (self_rows + n_act + cross_rows))
    mega_bound, mega_by = bound(mega_flops, mega_bytes)
    mega = dict(
        name="megastep", route="cuda",
        source="paddle_tpu_torch/csrc/megastep.cu",
        replaces="paddle_tpu/kernels/decode_step.py:229",
        max_abs_err=err,
        ms=cuda_ms(lambda: kds.megastep(x, **w, **caches, **ints, **kw)),
        plain_ms=cuda_ms(lambda: kds.reference_megastep(
            x, **w, **plain_caches, **ints, **kw)),
        bound_ms=mega_bound, bound_by=mega_by, library_ms=None, batch=b)

    got = kds.ffn_epilogue(want, **ffn)
    want_ffn = kds.reference_ffn(want, **ffn)
    torch.cuda.synchronize()
    ffn_err = compare(f"ffn b={b}", got, want_ffn, TOL_KERNEL)
    ffn_bytes = F32 * (2 * dm * di + di + 3 * dm + 2 * b * dm)
    ffn_bound, ffn_by = bound(4 * b * dm * di, ffn_bytes)
    ffn_rec = dict(
        name="ffn", route="cuda", source="paddle_tpu_torch/csrc/ffn.cu",
        replaces="paddle_tpu/kernels/decode_step.py:383",
        max_abs_err=ffn_err,
        ms=cuda_ms(lambda: kds.ffn_epilogue(want, **ffn)),
        plain_ms=cuda_ms(lambda: kds.reference_ffn(want, **ffn)),
        bound_ms=ffn_bound, bound_by=ffn_by, library_ms=None, batch=b)
    return mega, ffn_rec


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def source_batch(b, seed):
    """Token ids [b, 256] in [2, vocab) with padded tails (pad id 0); row
    0 of a batch is unpadded."""
    rng = np.random.RandomState(seed)
    src = rng.randint(2, BASE["src_vocab_size"], (b, SRC_LEN))
    lens = rng.randint(SRC_LEN // 2, SRC_LEN + 1, b)
    lens[0] = SRC_LEN if b > 1 else 200
    src[np.arange(SRC_LEN)[None, :] >= lens[:, None]] = 0
    return src.astype(np.int64)


def run_main_path(model, cpu_model, b):
    from paddle_tpu_torch import GenerationSession
    from paddle_tpu_torch import kernels

    L = BASE["n_layer"]
    src = source_batch(b, seed=b)
    # eos outside the vocabulary: every lane generates all 64 tokens, the
    # fixed work bench.py's bench_decode also uses
    sess_kw = dict(batch_size=b, src_seq_len=SRC_LEN, max_out_len=MAX_OUT,
                   bos_id=0, eos_id=-1)

    # -- the counted run --------------------------------------------------
    sess = GenerationSession(model, **sess_kw)
    kernels.reset_launches()
    sess.prefill(src)
    require(kernels.launches == {"qkv_attention_fwd": L, "megastep": 0,
                                 "ffn": 0},
            f"b={b}: prefill launches {kernels.launches}")
    tokens, logits = [], []
    for _ in range(MAX_OUT):
        tokens.append(sess.decode_step())
        logits.append(sess.last_logits.clone())
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == {"qkv_attention_fwd": L, "megastep": L * MAX_OUT,
                       "ffn": L * MAX_OUT},
            f"b={b}: main-path launches {counts}")
    tokens = np.stack(tokens, axis=1)
    require(tokens.shape == (b, MAX_OUT), f"tokens {tokens.shape}")
    require(((tokens >= 0) & (tokens < BASE["trg_vocab_size"])).all(),
            "token out of range")

    # -- the plain path on the CPU, teacher-forced ------------------------
    plain = GenerationSession(cpu_model, **sess_kw)
    plain.prefill(src)
    for name in ("k", "v", "lengths"):
        compare(f"b={b} cross cache {name}",
                getattr(sess.cross_cache, name).cpu(),
                getattr(plain.cross_cache, name), TOL_E2E)
    max_err, decided = 0.0, 0
    prev = np.zeros(b, np.int64)  # BOS
    for step in range(MAX_OUT):
        plain.last_tok.copy_(torch.from_numpy(prev))
        plain.decode_step()
        want = plain.last_logits
        got = logits[step].cpu()
        max_err = max(max_err, compare(f"b={b} step {step} logits", got,
                                       want, TOL_E2E))
        top2 = want.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        clear = gap > 2 * TOL_E2E * (1 + top2[:, 0].abs())
        same = torch.from_numpy(tokens[:, step]) == want.argmax(dim=-1)
        require(bool(same[clear].all()),
                f"b={b} step {step}: argmax differs on a clear margin")
        decided += int(clear.sum())
        prev = tokens[:, step]

    # -- timing run ---------------------------------------------------------
    timed = GenerationSession(model, **sess_kw)
    timed.prefill(src)  # set-up: the allocator grows to this batch
    prefill_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.prefill(src)  # returns lengths on the host: synchronous
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = []
    t1 = time.perf_counter()
    for _ in range(MAX_OUT):
        t = time.perf_counter()
        timed.decode_step()  # returns the tokens on the host: synchronous
        step_ms.append((time.perf_counter() - t) * 1e3)
    decode_s = time.perf_counter() - t1
    return dict(batch=b, launches=counts,
                prefill_ms=float(np.median(prefill_ms)),
                prefill_ms_range=(min(prefill_ms), max(prefill_ms)),
                decode_tokens_per_s=b * MAX_OUT / decode_s,
                decode_ms_per_step=decode_s / MAX_OUT * 1e3,
                # 64 steps: the 80th percentile has 12 samples beyond it
                step_ms_p50=float(np.percentile(step_ms, 50)),
                step_ms_p80=float(np.percentile(step_ms, 80)),
                logits_max_abs_err=max_err, argmax_checked=decided,
                argmax_total=b * MAX_OUT)


# ---------------------------------------------------------------------------
# phase 4: where the time goes (torch.profiler)
# ---------------------------------------------------------------------------


def _device_kernels(prof):
    """[(name, device us)] of the device-side events, largest first."""
    from torch.autograd import DeviceType

    rows = [(e.key, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def profile_serving(model, b, steps=16):
    """Device time by kernel over one prefill and `steps` decode steps,
    beside host wall time: the device's idle share of each phase."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import GenerationSession

    sess = GenerationSession(model, b, SRC_LEN, MAX_OUT, bos_id=0,
                             eos_id=-1)
    src = source_batch(b, seed=b)
    sess.prefill(src)  # warm
    for _ in range(4):
        sess.decode_step()
    sess = GenerationSession(model, b, SRC_LEN, MAX_OUT, bos_id=0,
                             eos_id=-1)
    out = {}
    for phase in ("prefill", "decode"):
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if phase == "prefill":
                sess.prefill(src)
            else:
                for _ in range(steps):
                    sess.decode_step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        per = 1 if phase == "prefill" else steps
        rows = _device_kernels(prof)
        busy_us = sum(us for _, us in rows)
        out[phase] = dict(wall_ms=wall_us / per / 1e3,
                          device_busy_ms=busy_us / per / 1e3,
                          idle_share=(1 - busy_us / wall_us
                                      if busy_us else None),
                          top=[(name[:60], us / per / 1e3)
                               for name, us in rows[:8]])
        with open(os.path.join(OUT_DIR, f"profile_b{b}_{phase}.txt"),
                  "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=40))
    return out


# ---------------------------------------------------------------------------


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import paddle_tpu_torch
        from paddle_tpu_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: paddle_tpu_torch not found beside the script "
              f"({exc})", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.lib()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_build.build_log())
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "== " in line:
            print("  " + line.strip())

    gen = torch.Generator().manual_seed(0)
    records = {}
    for b in BATCHES:
        rec = check_qkv_attention(gen, b)
        mega, ffn = check_decode_kernels(gen, b)
        torch.cuda.synchronize()
        for r in (rec, mega, ffn):
            print(f"phase 2: {r['name']} b={b}: max_abs_err "
                  f"{r['max_abs_err']:.3e} ms {r['ms']} plain_ms "
                  f"{r['plain_ms']} bound_ms {r['bound_ms']} "
                  f"({r['bound_by']}) library_ms {r['library_ms']}"
                  + (f" (library max_abs_err {r['library_max_abs_err']:.3e})"
                     if "library_max_abs_err" in r else ""))
            records[(r["name"], b)] = r

    model = paddle_tpu_torch.Transformer(**BASE).init_params(seed=0)
    cpu_model = paddle_tpu_torch.Transformer(**BASE, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    runs = []
    for b in BATCHES:
        run = run_main_path(model, cpu_model, b)
        torch.cuda.synchronize()
        print(f"phase 3: b={b}: prefill {run['prefill_ms']} ms (median "
              f"of 5, range {run['prefill_ms_range']}), decode "
              f"{run['decode_tokens_per_s']} tokens/s "
              f"({run['decode_ms_per_step']} ms/step mean, p50 "
              f"{run['step_ms_p50']}, p80 {run['step_ms_p80']} of "
              f"{MAX_OUT}), launches "
              f"{run['launches']}, logits max_abs_err "
              f"{run['logits_max_abs_err']:.3e}, argmax held on "
              f"{run['argmax_checked']}/{run['argmax_total']} clear steps")
        runs.append(run)

    for b in BATCHES:
        prof = profile_serving(model, b)
        for phase, r in prof.items():
            if not r["device_busy_ms"]:
                print(f"phase 4: b={b} {phase}: device time not measured "
                      f"(the profiler saw no device events)")
                continue
            print(f"phase 4: b={b} {phase} per "
                  f"{'prefill' if phase == 'prefill' else 'step'}: wall "
                  f"{r['wall_ms']} ms, device busy {r['device_busy_ms']} "
                  f"ms, idle share {r['idle_share']}")
            for name, ms in r["top"]:
                print(f"    {ms:.4f} ms  {name}")

    total = {name: sum(r["launches"][name] for r in runs)
             for name in runs[0]["launches"]}
    kernels_line = []
    for name in ("qkv_attention_fwd", "megastep", "ffn"):
        r = dict(records[(name, max(BATCHES))])
        r.pop("batch")
        r.pop("library_max_abs_err", None)
        r["launches"] = total[name]
        kernels_line.append(r)
    print(json.dumps({"main_path": runs, "power": smi}))
    print(json.dumps({"kernels": kernels_line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
