#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100 is assumed for
the bounds).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch version on the card, at
   the shapes of the serving path, and time kernel, plain version and
   (where one exists) the one PyTorch call computing the same function;
3. the main paths on Transformer-base (6 layers, 8 heads, d_model 512,
   d_inner 2048, vocab 32000, source 256, 64 tokens) with seeded random
   weights.  The launch counters are zeroed just before each path and read
   just after it.
   (main) greedy generation on the ring cache, fused route, at batch 1 and
   64 through ``GenerationSession.prefill`` and 64 ``decode_step`` calls:
   6 qkv-attention launches per prefill, 6 megastep + 6 FFN launches per
   token.  The same model copied to the CPU (the plain path) is run
   teacher-forced on the card's token stream, and its cross cache and
   logits at every step must agree with the card's;
   (a) the unfused route on ring and on paged caches (static tables), at
   batch 1 and 64: 2 flash-decode launches per layer and token, no
   megastep or FFN launch; (b) the fused route on paged caches at batch
   64: 6 paged-megastep + 6 FFN launches per token.  Both are
   teacher-forced on the main path's tokens and their logits held against
   its logits on the card;
   (c) serving: ``GenerationServingModel`` + ``ContinuousBatcher`` with 64
   slots on the ring cache and on paged pools (256 blocks each side),
   160 requests from 16 client threads with staggered arrivals, 32 of them
   on 4 shared prompts.  Every request must get exactly its max_tokens
   tokens, the paged run must prefill once per prefix-registry leader,
   and the pools and the registry must drain; 16 sampled requests are
   replayed on a batch-1 session on the card, teacher-forced;
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
BLOCK_T = 16

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
    rec = timed_record(
        "qkv_attention_fwd", "paddle_tpu_torch/csrc/qkv_attention.cu",
        "paddle_tpu/kernels/attention.py:1377", err,
        lambda: ka.flash_qkv_attention(x, w_qkv, w_out, bias, **kw),
        lambda: ka.reference_qkv_attention(x, w_qkv, w_out, bias, **kw),
        flops, nbytes, library, b)
    rec["library_max_abs_err"] = lib_err
    return rec


def _decode_weights(gen):
    dm, h, dh = BASE["d_model"], BASE["n_head"], BASE["d_key"]
    di = BASE["d_inner_hid"]
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
    return w, ffn


def _decode_inputs(gen, b):
    h, dh, L = BASE["n_head"], BASE["d_key"], BASE["n_layer"]
    w, ffn = _decode_weights(gen)
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
    x = randn(gen, b, 1, BASE["d_model"])
    return x, w, ffn, caches, ints


def check_decode_kernels(gen, b):
    from paddle_tpu_torch.kernels import decode_step as kds

    x, w, ffn, caches, ints = _decode_inputs(gen, b)
    dm, h, dh = BASE["d_model"], BASE["n_head"], BASE["d_key"]
    hd = h * dh
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
    mega = timed_record(
        "megastep", "paddle_tpu_torch/csrc/megastep.cu",
        "paddle_tpu/kernels/decode_step.py:229", err,
        lambda: kds.megastep(x, **w, **caches, **ints, **kw),
        lambda: kds.reference_megastep(x, **w, **plain_caches, **ints,
                                       **kw), mega_flops, mega_bytes, None,
        b)
    return mega, check_ffn(want, ffn, b, "ffn",
                           "paddle_tpu/kernels/decode_step.py:383")


def check_ffn(x, ffn, b, name, replaces):
    """#11 (and #13, the same kernel after the paged megastep) on the
    megastep's plain output x."""
    from paddle_tpu_torch.kernels import decode_step as kds

    dm, di = BASE["d_model"], BASE["d_inner_hid"]
    got = kds.ffn_epilogue(x, **ffn)
    want = kds.reference_ffn(x, **ffn)
    torch.cuda.synchronize()
    err = compare(f"{name} b={b}", got, want, TOL_KERNEL)
    return timed_record(
        name, "paddle_tpu_torch/csrc/ffn.cu", replaces, err,
        lambda: kds.ffn_epilogue(x, **ffn),
        lambda: kds.reference_ffn(x, **ffn), 4 * b * dm * di,
        F32 * (2 * dm * di + di + 3 * dm + 2 * b * dm), None, b)


def timed_record(name, source, replaces, err, fn, plain, flops, nbytes,
                 library, b):
    """A kernel record: fn and plain timed alone after an L2 flush, the
    bound from flops and nbytes, library timed where there is one."""
    bound_ms, bound_by = bound(flops, nbytes)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=cuda_ms(fn), plain_ms=cuda_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=cuda_ms(library) if library else None, batch=b)


def _spread_lengths(gen, b, lo, hi):
    """[b] int32 lengths uniform in [lo, hi]; lane 0 of a batch > 1 is
    empty."""
    lens = torch.randint(lo, hi + 1, (b,), generator=gen)
    if b > 1:
        lens[0] = 0
    return lens.to(torch.int32).cuda()


def _shuffled_table(gen, b, max_blocks, holes=8):
    """A [b, max_blocks] int32 table over a pool of b*max_blocks + holes
    blocks, every id used at most once, in shuffled order."""
    n = b * max_blocks + holes
    perm = torch.randperm(n, generator=gen)[:b * max_blocks]
    return perm.reshape(b, max_blocks).to(torch.int32).cuda(), n


def _library_decode(q, k, v, lens, scale):
    """One PyTorch call for single-query attention over a length-masked
    [b, t, h, dh] cache (a yardstick only)."""
    import torch.nn.functional as F

    t = k.shape[1]
    mask = (torch.arange(t, device=q.device)[None, :]
            < lens.long()[:, None])[:, None, None, :]
    return F.scaled_dot_product_attention(
        q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, scale=scale)[:, :, 0, :]


def check_flash_decode(gen, b):
    """#14 and #15 at the unfused route's shapes: the self side (128 rows,
    lengths 1-128) and the cross side (256 rows, lengths 8-256), lane 0
    empty; the paged walk over a shuffled table with holes.  Returns
    {(kernel, side): record}."""
    from paddle_tpu_torch.kernels import decode_attention as kda

    h, dh, bt = BASE["n_head"], BASE["d_key"], BLOCK_T
    scale = dh ** -0.5
    out = {}
    for side, rows, lo in (("self", 128, 1), ("cross", SRC_LEN, 8)):
        q = randn(gen, b, h, dh)
        k, v = randn(gen, b, rows, h, dh), randn(gen, b, rows, h, dh)
        lens = _spread_lengths(gen, b, lo, rows)
        n_rows = lens.long().sum().item()
        flops = 4 * h * dh * n_rows
        io = F32 * (2 * b * h * dh + 2 * h * dh * n_rows) + 4 * b
        got = kda.flash_decode(q, k, v, lens, scale)
        want = kda.reference_decode(q, k, v, lens, scale)
        torch.cuda.synchronize()
        err = compare(f"flash_decode {side} b={b}", got, want, TOL_KERNEL)
        live = lens > 0
        lib_err = (_library_decode(q, k, v, lens, scale)[live]
                   - want[live]).abs().max().item()
        rec = timed_record(
            "flash_decode", "paddle_tpu_torch/csrc/decode_attention.cu",
            "paddle_tpu/kernels/decode_attention.py:61", err,
            lambda: kda.flash_decode(q, k, v, lens, scale),
            lambda: kda.reference_decode(q, k, v, lens, scale), flops, io,
            lambda: _library_decode(q, k, v, lens, scale), b)
        rec["library_max_abs_err"] = lib_err
        out[("flash_decode", side)] = rec

        # the same rows scattered over a pool through a shuffled table
        mb = rows // bt
        table, nb = _shuffled_table(gen, b, mb)
        k_pool = torch.empty((nb, bt, h, dh), device=k.device)
        v_pool = torch.empty_like(k_pool)
        k_pool[table.long()] = k.reshape(b, mb, bt, h, dh)
        v_pool[table.long()] = v.reshape(b, mb, bt, h, dh)
        got = kda.flash_decode_paged(q, k_pool, v_pool, table, lens, scale)
        want_p = kda.reference_decode_paged(q, k_pool, v_pool, table, lens,
                                            scale)
        torch.cuda.synchronize()
        err = max(compare(f"flash_decode_paged {side} b={b}", got, want_p,
                          TOL_KERNEL),
                  compare(f"flash_decode_paged {side} b={b} vs ring", got,
                          want, TOL_KERNEL))

        def library():
            gk = k_pool[table.long()].reshape(b, rows, h, dh)
            gv = v_pool[table.long()].reshape(b, rows, h, dh)
            return _library_decode(q, gk, gv, lens, scale)

        rec = timed_record(
            "flash_decode_paged", "paddle_tpu_torch/csrc/decode_attention.cu",
            "paddle_tpu/kernels/decode_attention.py:282", err,
            lambda: kda.flash_decode_paged(q, k_pool, v_pool, table, lens,
                                           scale),
            lambda: kda.reference_decode_paged(q, k_pool, v_pool, table,
                                               lens, scale),
            flops, io + 4 * b * mb, library, b)
        rec["library_max_abs_err"] = (library()[live]
                                      - want[live]).abs().max().item()
        out[("flash_decode_paged", side)] = rec
    return out


def check_paged_decode_kernels(gen, b):
    """#12 and #13 at the paged main path's shapes: pools of 16-row blocks
    behind shuffled tables with holes, self lengths 1-128 and cross
    lengths 8-256, the last lane inactive at row 0 (self length 0) and
    lane 0 with an empty cross cache when b > 1."""
    from paddle_tpu_torch.kernels import decode_step as kds

    h, dh, L, bt = BASE["n_head"], BASE["d_key"], BASE["n_layer"], BLOCK_T
    dm, hd = BASE["d_model"], h * dh
    w, ffn = _decode_weights(gen)
    stab, snb = _shuffled_table(gen, b, 128 // bt)
    ctab, cnb = _shuffled_table(gen, b, SRC_LEN // bt)
    pools = dict(cache_k=randn(gen, L, snb, bt, h, dh),
                 cache_v=randn(gen, L, snb, bt, h, dh),
                 cross_k=randn(gen, L, cnb, bt, h, dh),
                 cross_v=randn(gen, L, cnb, bt, h, dh))
    pos = torch.randint(0, 128, (b,), generator=gen)
    active = torch.ones(b, dtype=torch.int64)
    if b > 1:
        active[-1], pos[-1] = 0, 0
    ints = dict(pos=pos, lengths=pos + active)
    ints = {k: v.to(torch.int32).cuda() for k, v in ints.items()}
    ints.update(cross_lengths=_spread_lengths(gen, b, 8, SRC_LEN),
                self_table=stab, cross_table=ctab,
                active=active.to(torch.int32).cuda())
    x = randn(gen, b, 1, dm)
    kw = dict(layer=L // 2, n_head=h, scale=dh ** -0.5)
    plain_pools = {k: v.clone() for k, v in pools.items()}
    got = kds.megastep_paged(x, **w, **pools, **ints, **kw)
    want = kds.reference_megastep_paged(x, **w, **plain_pools, **ints, **kw)
    torch.cuda.synchronize()
    err = compare(f"megastep_paged b={b}", got, want, TOL_KERNEL)
    for name in ("cache_k", "cache_v"):
        err = max(err, compare(f"megastep_paged {name} b={b}", pools[name],
                               plain_pools[name], TOL_KERNEL))
    act = ints["active"].long()
    self_rows = (ints["lengths"].long() - act).sum().item()
    cross_rows = ints["cross_lengths"].long().sum().item()
    n_act = act.sum().item()
    weights = 6 * dm * hd + 4 * dm
    nbytes = (F32 * (weights + 2 * b * dm
                     + 2 * hd * (self_rows + cross_rows + n_act))
              + 16 * b + 4 * b * (stab.shape[1] + ctab.shape[1]))
    flops = 2 * b * weights + 4 * hd * (self_rows + n_act + cross_rows)
    mega = timed_record(
        "megastep_paged", "paddle_tpu_torch/csrc/megastep.cu",
        "paddle_tpu/kernels/decode_step.py:642", err,
        lambda: kds.megastep_paged(x, **w, **pools, **ints, **kw),
        lambda: kds.reference_megastep_paged(x, **w, **plain_pools, **ints,
                                             **kw), flops, nbytes, None, b)
    return mega, check_ffn(
        want, ffn, b, "ffn_paged",
        "paddle_tpu/kernels/decode_step.py:383 (launch :889)")


# ---------------------------------------------------------------------------
# phase 3: the main paths
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


def expected(**counts):
    """The launch counters as a path must leave them: ``counts``, every
    other kernel 0."""
    from paddle_tpu_torch import kernels

    return {name: counts.get(name, 0) for name in kernels.launches}


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
    require(kernels.launches == expected(qkv_attention_fwd=L),
            f"b={b}: prefill launches {kernels.launches}")
    tokens, logits = [], []
    for _ in range(MAX_OUT):
        tokens.append(sess.decode_step())
        logits.append(sess.last_logits.clone())
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expected(qkv_attention_fwd=L, megastep=L * MAX_OUT,
                               ffn=L * MAX_OUT),
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
        decided += argmax_held(b, step, tokens[:, step], want)
        prev = tokens[:, step]

    run = dict(batch=b, route="ring fused", launches=counts,
               logits_max_abs_err=max_err, argmax_checked=decided,
               argmax_total=b * MAX_OUT)
    run.update(time_session(GenerationSession(model, **sess_kw), src))
    return run, tokens, logits


def time_session(timed, src):
    """Prefill time (median of 5 after an untimed one) and the decode
    rate and step times over MAX_OUT steps, host clock; every call returns
    to the host, so each is synchronous."""
    timed.prefill(src)  # set-up: the allocator grows to this batch
    prefill_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed.prefill(src)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = []
    t1 = time.perf_counter()
    for _ in range(MAX_OUT):
        t = time.perf_counter()
        timed.decode_step()
        step_ms.append((time.perf_counter() - t) * 1e3)
    decode_s = time.perf_counter() - t1
    b = timed.batch_size
    return dict(prefill_ms=float(np.median(prefill_ms)),
                prefill_ms_range=(min(prefill_ms), max(prefill_ms)),
                decode_tokens_per_s=b * MAX_OUT / decode_s,
                decode_ms_per_step=decode_s / MAX_OUT * 1e3,
                # 64 steps: the 80th percentile has 12 samples beyond it
                step_ms_p50=float(np.percentile(step_ms, 50)),
                step_ms_p80=float(np.percentile(step_ms, 80)))


def argmax_held(b, step, tokens, logits):
    """Raise unless tokens [b] (host) are the argmax of logits [b, V]
    wherever the top-2 gap clears twice TOL_E2E; returns how many lanes
    cleared it."""
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    clear = (gap > 2 * TOL_E2E * (1 + top2[:, 0].abs())).cpu()
    same = torch.from_numpy(np.asarray(tokens)) == logits.argmax(-1).cpu()
    require(bool(same[clear].all()),
            f"b={b} step {step}: argmax differs on a clear margin")
    return int(clear.sum())


def run_route(model, b, src, ref_tokens, ref_logits, expect, route,
              **sess_kw):
    """Phase 3 (a)/(b): one route teacher-forced on the main path's tokens
    (ref_tokens [b, MAX_OUT] host, ref_logits per step on the card); its
    logits must agree with the main path's within TOL_E2E and its launch
    counts must read ``expect``.  Then timed free-running."""
    from paddle_tpu_torch import GenerationSession
    from paddle_tpu_torch import kernels

    kw = dict(batch_size=b, src_seq_len=SRC_LEN, max_out_len=MAX_OUT,
              bos_id=0, eos_id=-1, **sess_kw)
    sess = GenerationSession(model, **kw)
    forced = torch.from_numpy(ref_tokens).cuda()
    kernels.reset_launches()
    sess.prefill(src)
    max_err, decided = 0.0, 0
    for step in range(MAX_OUT):
        if step:
            sess.last_tok.copy_(forced[:, step - 1])
        sess.decode_step()
        max_err = max(max_err, compare(
            f"{route} b={b} step {step} logits", sess.last_logits,
            ref_logits[step], TOL_E2E))
        decided += argmax_held(b, step, ref_tokens[:, step],
                               sess.last_logits)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expect, f"{route} b={b}: launches {counts}")
    run = dict(batch=b, route=route, launches=counts,
               logits_max_abs_err=max_err, argmax_checked=decided,
               argmax_total=b * MAX_OUT)
    run.update(time_session(GenerationSession(model, **kw), src))
    return run


#: phase 3 (c): 64 slots; 160 requests from 16 client threads, one every
#: 5 ms; paged pools of 256 blocks a side (393,216 B each, 100 MB a pool:
#: half the self pool's ring-equivalent 512 blocks and a quarter of the
#: cross pool's 1024, so the cross budget binds and holds requests back)
SERVE_SLOTS, SERVE_REQUESTS, SERVE_CLIENTS = 64, 160, 16
SERVE_BLOCKS, ARRIVAL_GAP_S, SERVE_WAIT_S = 256, 0.005, 300.0


def serving_traffic(seed=0):
    """(prompts, max_tokens): prompt lengths uniform in 8-256 with ids in
    [2, vocab), max_tokens uniform in 8-64; requests 0, 5, 10, ... (32 of
    them) carry 4 shared prompts, 8 consecutive ones each (requests 0-35
    the first, 40-75 the second, ...)."""
    rng = np.random.RandomState(seed)
    vocab = BASE["src_vocab_size"]

    def prompt():
        return rng.randint(2, vocab, rng.randint(8, SRC_LEN + 1)).tolist()

    prompts = [prompt() for _ in range(SERVE_REQUESTS)]
    max_tokens = rng.randint(8, MAX_OUT + 1, SERVE_REQUESTS).tolist()
    shared = [prompt() for _ in range(4)]
    for j, n in enumerate(range(0, SERVE_REQUESTS, 5)):
        prompts[n] = shared[j // 8 % 4]
    return prompts, max_tokens


def run_serving(model, paged):
    """Phase 3 (c): the batcher on one cache layout under the traffic
    above.  Returns (stats, results, prompts)."""
    import threading

    from paddle_tpu_torch import GenerationSession, kernels
    from paddle_tpu_torch.serving import (ContinuousBatcher,
                                          GenerationConfig,
                                          GenerationServingModel)

    name = "paged" if paged else "ring"
    L = BASE["n_layer"]
    sess = GenerationSession(model, SERVE_SLOTS, SRC_LEN, MAX_OUT, bos_id=0,
                             eos_id=-1, paged=paged,
                             num_blocks=SERVE_BLOCKS if paged else 0)
    served = GenerationServingModel(
        GenerationConfig(name, slots=SERVE_SLOTS, max_tokens=MAX_OUT),
        session=sess)
    served.warmup()
    batcher = ContinuousBatcher(served)
    prompts, max_tokens = serving_traffic()
    results = [None] * SERVE_REQUESTS
    errors = []

    def one(n):
        try:
            results[n] = batcher.submit(prompts[n], max_tokens=max_tokens[n],
                                        timeout=SERVE_WAIT_S)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append((n, repr(exc)))

    def client(c, t0):
        # open-loop arrivals: request n is submitted at t0 + n * gap
        workers = []
        for n in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
            delay = t0 + n * ARRIVAL_GAP_S - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            workers.append(threading.Thread(target=one, args=(n,)))
            workers[-1].start()
        for w in workers:
            w.join(timeout=SERVE_WAIT_S)

    kernels.reset_launches()
    batcher.start()
    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(c, t0))
                   for c in range(SERVE_CLIENTS)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=SERVE_WAIT_S)
        wall_s = time.perf_counter() - t0
        drained = batcher.drain(timeout=60.0)
    finally:
        batcher.stop(timeout=60.0)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(not errors, f"serving {name}: failed requests {errors[:4]}")
    require(drained, f"serving {name}: batcher did not drain")
    for n, res in enumerate(results):
        require(res is not None and len(res[0]) == max_tokens[n],
                f"serving {name}: request {n} got "
                f"{None if res is None else len(res[0])} of "
                f"{max_tokens[n]} tokens")
    c = batcher.counters
    prefills = c[f"serving.gen.{name}.prefills"]
    hits = c[f"generation.{name}.prefix_hits_total"]
    steps = c[f"serving.gen.{name}.decode_steps"]
    tokens = sum(max_tokens)
    require(c[f"serving.gen.{name}.tokens"] == tokens,
            f"serving {name}: token counter {c[f'serving.gen.{name}.tokens']}")
    if paged:
        # every request either led its prompt's registry entry (one
        # prefill) or shared a registered one (no prefill)
        require(prefills + hits == SERVE_REQUESTS and hits > 0,
                f"serving paged: prefills {prefills} + hits {hits}")
        require(c[f"generation.{name}.admission_holds_total"] > 0,
                "serving paged: the block budget never held a request")
        require(sess.self_cache.allocator.used_count == 0
                and sess.cross_cache.allocator.used_count == 0
                and not batcher._prefix_map,
                "serving paged: pools or prefix registry not drained")
        mega = dict(megastep_paged=L * steps)
    else:
        require(prefills == SERVE_REQUESTS and hits == 0,
                f"serving ring: prefills {prefills}, hits {hits}")
        mega = dict(megastep=L * steps)
    qkv = counts["qkv_attention_fwd"]
    require(qkv > 0 and qkv % L == 0
            and counts == expected(qkv_attention_fwd=qkv, ffn=L * steps,
                                   **mega),
            f"serving {name}: launches {counts}")
    ttft = [res[1]["ttft_ms"] for res in results]
    stats = dict(
        route=f"serving {name}", launches=counts, wall_s=wall_s,
        requests_per_s=SERVE_REQUESTS / wall_s,
        generated_tokens_per_s=tokens / wall_s, tokens=tokens,
        ttft_ms_p50=float(np.percentile(ttft, 50)),
        ttft_ms_p90=float(np.percentile(ttft, 90)),
        occupancy_peak=c[f"serving.gen.{name}.occupancy_peak"],
        decode_steps=steps, prefills=prefills, prefix_hits=hits,
        blocks_used_peak=(c[f"generation.{name}.blocks_used_peak"]
                          if paged else None),
        admission_holds=(c[f"generation.{name}.admission_holds_total"]
                         if paged else None),
        blocks_total=(2 * (SERVE_BLOCKS - 1) if paged else None),
        kv_cache_bytes=served.kv_cache_bytes)
    return stats, results, prompts


def check_sampled(model, prompts, results):
    """16 served requests (one whole sharer group and 8 others) replayed on
    a batch-1 ring session on the card, teacher-forced on the batcher's
    tokens: the argmax must agree wherever the top-2 gap is clear.
    Returns (steps cleared, steps checked)."""
    from paddle_tpu_torch import GenerationSession

    group = list(range(0, 40, 5))
    others = [n for n in range(SERVE_REQUESTS) if n % 5][::16][:8]
    sess = GenerationSession(model, 1, SRC_LEN, MAX_OUT, bos_id=0,
                             eos_id=-1)
    decided = total = 0
    for n in group + others:
        tokens = results[n][0]
        src = np.zeros((1, SRC_LEN), np.int64)
        src[0, :len(prompts[n])] = prompts[n]
        sess.prefill(src)
        for step, tok in enumerate(tokens):
            if step:
                sess.last_tok.fill_(tokens[step - 1])
            sess.decode_step()
            decided += argmax_held(1, step, [tok], sess.last_logits)
            total += 1
    return decided, total


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
        mega_paged, ffn_paged = check_paged_decode_kernels(gen, b)
        decode = check_flash_decode(gen, b)
        torch.cuda.synchronize()
        checked = [(None, r) for r in (rec, mega, ffn, mega_paged,
                                        ffn_paged)]
        checked += [(side, r) for (_, side), r in decode.items()]
        for side, r in checked:
            print(f"phase 2: {r['name']}{' ' + side if side else ''} b={b}: "
                  f"max_abs_err "
                  f"{r['max_abs_err']:.3e} ms {r['ms']} plain_ms "
                  f"{r['plain_ms']} bound_ms {r['bound_ms']} "
                  f"({r['bound_by']}) library_ms {r['library_ms']}"
                  + (f" (library max_abs_err {r['library_max_abs_err']:.3e})"
                     if "library_max_abs_err" in r else ""))
            # the JSON line carries the cross side of the flash-decode pair
            if side in (None, "cross"):
                records[(r["name"], b)] = r

    model = paddle_tpu_torch.Transformer(**BASE).init_params(seed=0)
    cpu_model = paddle_tpu_torch.Transformer(**BASE, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    unfused = paddle_tpu_torch.Transformer(**BASE, fused_decode_step=False)
    unfused.load_state_dict(model.state_dict())
    L = BASE["n_layer"]
    runs = []
    for b in BATCHES:
        run, tokens, logits = run_main_path(model, cpu_model, b)
        runs.append(run)
        src = source_batch(b, seed=b)
        for paged in (False, True):
            walk = "flash_decode_paged" if paged else "flash_decode"
            runs.append(run_route(
                unfused, b, src, tokens, logits,
                expected(qkv_attention_fwd=L, **{walk: 2 * L * MAX_OUT}),
                f"{'paged' if paged else 'ring'} unfused", paged=paged))
        if b == max(BATCHES):
            runs.append(run_route(
                model, b, src, tokens, logits,
                expected(qkv_attention_fwd=L, megastep_paged=L * MAX_OUT,
                         ffn=L * MAX_OUT), "paged fused", paged=True))
        del logits
        torch.cuda.synchronize()
    for run in runs:
        print(f"phase 3: {run['route']} b={run['batch']}: prefill "
              f"{run['prefill_ms']} ms (median of 5, range "
              f"{run['prefill_ms_range']}), decode "
              f"{run['decode_tokens_per_s']} tokens/s "
              f"({run['decode_ms_per_step']} ms/step mean, p50 "
              f"{run['step_ms_p50']}, p80 {run['step_ms_p80']} of "
              f"{MAX_OUT}), launches {run['launches']}, logits max_abs_err "
              f"{run['logits_max_abs_err']:.3e}, argmax held on "
              f"{run['argmax_checked']}/{run['argmax_total']} clear steps")

    serving = []
    for paged in (False, True):
        stats, results, prompts = run_serving(model, paged)
        stats["sampled_argmax"] = check_sampled(model, prompts, results)
        print(f"phase 3: {stats['route']}: " + ", ".join(
            f"{k} {v}" for k, v in stats.items() if k != "route"))
        serving.append(stats)

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

    # launches over every counted path; the FFN counter is split between
    # the ring paths (#11) and the paged ones (#13)
    paths = runs + serving
    total = {name: sum(r["launches"][name] for r in paths)
             for name in paths[0]["launches"]}
    paged_ffn = sum(r["launches"]["ffn"] for r in paths
                    if r["launches"]["megastep_paged"])
    total["ffn_paged"] = paged_ffn
    total["ffn"] -= paged_ffn
    kernels_line = []
    for name in ("qkv_attention_fwd", "megastep", "ffn", "megastep_paged",
                 "ffn_paged", "flash_decode", "flash_decode_paged"):
        r = dict(records[(name, max(BATCHES))])
        r.pop("batch")
        r.pop("library_max_abs_err", None)
        r["launches"] = total[name]
        require(r["launches"] > 0, f"{name}: no launch on the main paths")
        kernels_line.append(r)
    print(json.dumps({"main_path": runs, "serving": serving, "power": smi}))
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
