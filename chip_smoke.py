#!/usr/bin/env python3
"""Smoke run of paddle_tpu_torch on one CUDA card (an H100 is assumed for
the bounds).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch version on the card, at
   the shapes of the serving and training paths, and time kernel, plain
   version and (where one exists) the one PyTorch call computing the same
   function.  The bthd flash kernels (#4, #6, #7) are checked on the
   encoder self-attention (key-padding bias [32, 1, 1, 256]), the decoder
   self-attention ([32, 1, 256, 256]), a cross case with target 128 and
   source 256, a ``causal=True`` case, a causal case with tq > tk and
   a row masked to -1e30, and three ragged cases (tq = tk = 200 under the
   decoder bias; causal tq 136 > tk 72 with a masked row; causal tq = tk
   = 129, one row past the forward's 128-row block), each kernel called
   twice for equal bits.  The bhtd flash kernels (#5, #8, #9) are
   checked at BERT-base's self-attention (q, k, v [128, 12, 128, 64],
   key-padding bias [128, 1, 1, 128] with -1e9 tails), with a per-head
   bias [128, 12, 128, 128] that requires grad (also through
   ``flash_attention(fmt="bhtd")``'s autograd: dq, dk, dv and dbias
   against autograd through the forward twin), ``causal=True``, causal
   with tq 128 > tk 64 and a row masked to -1e30, a cross case tq 64,
   tk 128, and three ragged cases (tq 72, tk 200; causal tq 200 > tk 136;
   tq 129, tk 72),
   each at rate 0 and 0.1 and each call repeated for equal bits, and
   timed beside masked ``F.scaled_dot_product_attention`` and its
   backward.  Each layout's two backward walks are also timed in one
   call sequence beside that backward (``flash_bwd``), and phase 1
   prints each walk instantiation's registers, spills and shared memory
   (``walk_builds``), and those of #19, ``gemm.cuh``'s GEMM and the flash
   forward (``tile_builds``).  The fused-projection training kernels (#1 with
   its residuals ctx and lse, #2 and #3) are checked at batch 32, 8 heads,
   d_model 512 on the encoder self-attention (t 256, bias [32, 1, 1,
   256]), the decoder self-attention (t 256, [32, 1, 256, 256]), a
   ``causal=True`` case and a ragged t = 200 with one row masked to -1e30
   (ctx 0, lse +inf, zero dx_q); #1 (in both modes), #2 and #3 are each
   called twice on the same inputs and must give equal bits.  So is the
   pair #2 + #3 (``qkv_bwd``: one ``ptt_qkv_bwd`` call with both walks,
   as the autograd backward makes it), held against its twin on the same
   cases and at BERT-base's self-attention (b 128, t 128, d_model 768),
   at rates 0 and 0.1; on a masked row its dx must equal #3's dx_kv bit
   for bit.  At BERT-base's case it is held against float64 (dW normwise)
   and elementwise against the f32 twin, and the f32 twin's own error
   against float64 is printed beside its.
   ``gemm.cuh``'s tile alone (``kernels.gemm``) is held against
   ``torch.matmul`` and timed beside it at the pair's three product
   shapes (GEMM_CASES) and at BERT-base's dW_qkv (M 768, N 2304, K 16384),
   where both products are also held against float64 and the depth of the
   slab it sums in one f32 sum is printed.  Each of
   #1-#4, #6 and #7 is checked again at weights-dropout rate 0.1 on every
   case against its twin (same seed, the same hash mask), and timed at
   rate 0.1 beside its rate-0 time.  #1 is checked on every route of its
   plan (``qkv_fwd_plan``: clusters of 1 to 8 blocks of 32 or 64 rows,
   and the tiles route at t > 512) on QKV_PLAN_CASES (t 8, BERT-base's
   self-attention, a ragged t 200, the b=1 prefill at t 256, the b=64
   decoder, t 512 and t 640; causal and not, each bias kind, rates 0 and
   0.1), each call repeated for equal bits, masked rows with ctx 0 and
   lse +inf, each timed with and without the host's enqueue, and the
   cluster occupancy of 8-block clusters printed;
   ``flash_qkv_attention`` and ``flash_attention(fmt="bthd")`` at head
   width 128 must raise before any launch (no kernel at that width).
   The dropout-add kernels (#16, #17) are checked at [32*256, 512] f32:
   with x = 1 and residual 0, #16 must give the twin's keep pattern
   exactly, with a keep share within a chi-square bound of 0.9; #17 must
   equal its twin bit for bit.  The conv + batch-norm kernels (#18-#21) are checked at ResNet-50's shapes
   at batch 256 (CBN_*_CASES: the stem, stage-1 and stage-4 sites, #19 at
   a strided shortcut, the stage-1 conv1 and a ragged M 1000, K 72, N 100
   too, #20/#21 with and without residual and ReLU),
   each called twice for equal bits; their sums are held to TOL_SUM of
   the summed magnitudes against the same sums in float64.  cuDNN's output of the NHWC convolution must
   come back NHWC-contiguous.  The multi-table embedding kernels (#22,
   #23) are checked at DeepFM's shapes (26 tables of 1000001 rows, widths
   10 and 1, ids [26, 4096]): #22 on both groups for the twin's bits; #23
   in Adam mode on both groups and in SGD and scatter-add modes on the
   first, on ids with planted runs of 5 and 50 equal ids and a sentinel
   tail, within 1e-6 relative of the twin and equal bits on a repeat;
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
   on 4 shared prompts; a request the batcher sheds (``Overloaded``) is
   resubmitted after its ``retry_after_s``, at most 3 times, and the shed
   and retry counts are printed.  Every request must get exactly its
   max_tokens tokens, the paged run must prefill once per prefix-registry
   leader, and the pools and the registry must drain; 16 sampled requests are
   replayed on a batch-1 session on the card, teacher-forced;
   (d) training: ``Transformer(fused_qkv_attention=False)`` with Paddle's
   ``Adam(1e-4)`` at batch 32, source and target 256 with seeded padded
   tails (label weight 0 on the pads): 18 ``flash_fwd``, 18
   ``flash_bwd_dq`` and 18 ``flash_bwd_dkv`` launches per step and no
   ``qkv_attention_fwd``.  The same model copied to the CPU takes the same
   first 2 steps through the plain path, at the full batch (about a
   minute): each step's loss within 1e-4 relative.  A float64 copy on the
   CPU gives step 1's exact gradient; the card's must be within 1e-4
   relative of it per parameter tensor (norm), or no further than twice
   the CPU's f32 gradient is (f32 alone is off by more than 1e-4 at this
   depth and length; see TOL_TRAIN_GRAD).  Then 10 timed steps on the card
   on one repeated batch (median step ms, target tokens/s, share of the
   f32 peak), whose loss must fall;
   (e) training on the default route (``fused_qkv_attention=True``) from
   (d)'s initial weights and on (d)'s batch: 12 ``qkv_attention_fwd``, 12
   ``qkv_bwd_dq`` and 12 ``qkv_bwd_dkv`` launches per step (the self-
   attention sites) and 6 each of the bthd kernels (the cross sites).
   Step 1, run twice, must give equal gradient bits; its loss and
   gradients are held against (d)'s float64 evaluation under (d)'s
   criterion, step 2's loss against (d)'s CPU f32 step 2; then 10 timed
   steps as in (d), printed beside (d)'s;
   (f) dropout training: the default route at ``dropout_rate=0.1`` from
   (d)'s initial weights on (d)'s batch: per step 32 ``dropout_add_fwd``
   and 32 ``dropout_add_bwd`` launches (30 residual sites and 2 embedding
   sites), 12 each of #1-#3 and 6 each of #4, #6, #7.  Step 1 runs under
   fixed seeds, twice, for equal gradient bits; float64 and f32 CPU
   copies take the same step under the same seeds, and the card is held
   to (d)'s criterion against them.  The
   flag-off route on the card under the same seeds must give step 1's
   loss within 1e-5 relative (the same masks).  Then 10 timed steps, each
   with fresh seeds, whose loss must fall, printed beside (e)'s rate-0
   step of the same run;
   (g) ResNet-50 training as the reference's ``bench_resnet50`` (224,
   1000 classes, NHWC, Momentum 0.1 / 0.9, f32 where the bench runs bf16)
   from ``init_params(0)``: 17 ``channel_stats``, 36 ``dot_col_stats``,
   53 ``ssa_fwd`` and 53 ``ssa_bwd`` launches per step.  Step 1 at batch
   16 against float64 and f32 CPU copies under (d)'s criterion
   (gradients, running statistics, updated parameters); step 1 at batch
   256 run twice for equal bits (``cudnn.deterministic``) and held against
   the card's plain route (the twins of #18-#21 on the card); then 10
   timed steps at batch 256 on one repeated batch (median step ms,
   images/s, f32 peak share, peak memory), whose first update must lower
   the loss.  The NCHW route (``data_format="NCHW"``: the reference's
   unfused conv2d + batch_norm composition, no kernel) takes step 1 at
   batch 16 from the same state, held to float64 under the same
   criterion;
   (h) DeepFM training as the reference's ``bench_deepfm`` (batch 4096,
   26 slots, hash_dim 1000001, embedding 10, lazy Adam 1e-3,
   FLAGS_fused_embedding on) from ``init_params(0)``: 2 ``multi_table_
   gather`` and 2 ``multi_table_apply`` launches per step; step 1 twice
   for equal bits; 3 steps against the per-table composition on the card
   (losses, tables and moments within rtol 2e-4, atol 2e-5, and each
   tensor within 2e-4 of its largest magnitude); 10 timed
   steps after a warm-up, cycling 8 ``make_batch`` batches (median step
   ms, examples/s, the analytic sparse-bytes share), whose loss must
   fall; one step at hash_dim 10001 against float64 under (d)'s
   criterion.  Then the reference demo's widths (head width 16), served
   through the batcher on the card: no attention or decode kernel
   launches, the composition counter counts, and the CPU plain path's
   tokens;
   (i) BERT-base pretraining as the reference's ``bench_bert`` (12
   layers, 12 heads of 64, d_model 768, d_ff 3072, vocab 30522, seq 128,
   batch 128, dropout 0.1, Adam 1e-4; f32 where the bench runs amp) from
   ``init_params(0)`` on ``make_batch`` batches with padded tails: the
   reference's default build after ``attention_fuse`` (every site
   ``fused_attention(fmt="bhtd")``) launches 12 each of #5, #8, #9 and 25
   each of #16, #17 (24 residual sites and the embedding's) per step and
   nothing else.  Step 1 under fixed per-site seeds runs twice for equal
   gradient bits; at batch 4 it is held against float64 and f32 CPU
   copies under the same seeds by (d)'s criterion.  The ``use_flash=True``
   route (12 each of #1-#3) gives step 1's loss within 1e-5 under the
   same seeds (the same masks), and the unfused composition (no pass, no
   kernel) the fused route's rate-0 loss within 1e-5.  Then 10 timed
   steps with fresh seeds on each kernel route (median step ms, tokens/s,
   f32 peak share by ``bench.py``'s ``bert_train_flops_per_token``, peak
   memory), whose loss must fall;
4. where the time goes: torch.profiler over one prefill and 16 decode
   steps at each batch, and over one training step on each route, on
   the dropout route, of ResNet-50, of DeepFM and of BERT-base on both
   kernel routes: device time by kernel beside host wall time, and for
   ResNet-50 any layout-conversion kernel and #19's time a step beside the
   summed bound of its 36 sites.
   Every phase prints its seconds.

Prints the card and its power limit, the timings, one JSON line with a
record per kernel, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, without a CUDA card or without the package
beside it.  f32 throughout, TF32 off for matmuls and cuDNN.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

#: kernel-vs-plain tolerance (abs and rel), f32 with TF32 off: the kernels
#: sum in other orders than cuBLAS
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
#: int32 operations/s outside the tensor cores: half the f32 FMA lanes
#: (64 of 128 per SM and clock on compute capability 9.0), one operation
#: each, on 132 SMs at 1.98 GHz
PEAK_INT32_OPS = 16.7e12
#: thread-instruction slots per second (4 schedulers of 32 lanes per SM
#: and clock, as many as the f32 FMA lanes): an f32 FMA (2 FLOPs) and an
#: int32 operation take one slot each, the int32 units beside the f32 ones
PEAK_SLOTS = 2 * PEAK_INT32_OPS
F32 = 4
#: the training dropout rate (the reference's ``transformer()`` default)
DROPOUT = 0.1
#: integer operations of one keep bit: the dropout-add hash (index times
#: GOLDEN plus seed, lowbias32's 3 xor-shifts and 2 multiplies, compare)
#: and the attention one (the plane index q * tk + k, times GOLDEN plus the
#: head seed, mix32_fast's 2 xor-shifts and 1 multiply, compare)
HASH_OPS, ATTN_HASH_OPS = 11, 9

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "chiprun_out")


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters=20, warmup=3, hide_host=False):
    """Median device time of one fn() call, each timed alone with CUDA
    events after writing a 256 MB buffer: the main path finds the L2 cold
    (its 6 layers' weights, 88 MB in the decode step, exceed the 50 MB
    L2), so a kernel timed back to back on the same warm inputs would
    read too fast.  The events also count any wait of the device for the
    host to enqueue fn's launches; ``hide_host`` puts a 1 ms device-side
    spin before the start event, so that the host has enqueued all of fn
    (a sync-free fn) before the device reaches it and only device time
    is counted."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(2_000_000)   # ~1 ms at the H100's clock
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(flops, nbytes, int_ops=0):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    operations: the larger of their slot time (f32 FLOPs at the f32 peak
    plus int32 operations at PEAK_SLOTS) and the int32 units' own time
    (at PEAK_INT32_OPS)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOPS + int_ops / PEAK_SLOTS,
                int_ops / PEAK_INT32_OPS) * 1e3
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
    again = ka.flash_qkv_attention(x, w_qkv, w_out, bias, **kw)
    want = ka.reference_qkv_attention(x, w_qkv, w_out, bias, **kw)
    torch.cuda.synchronize()
    require(torch.equal(got, again),
            f"qkv_attention_fwd b={b}: two calls on the same inputs differ")
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
    rec["plan"] = list(ka.qkv_fwd_plan(b, t, h, ka.sm_count(x.device)))
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
                 library, b, int_ops=0):
    """A kernel record: fn and plain timed alone after an L2 flush, the
    bound from flops, int_ops and nbytes, library timed where there is
    one."""
    bound_ms, bound_by = bound(flops, nbytes, int_ops)
    ms = cuda_ms(fn)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=ms, plain_ms=cuda_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by,
                bound_share=bound_ms / ms,
                library_ms=cuda_ms(library) if library else None, batch=b)


def flash_bwd_record(replaces, err, fn, plain, flops, nbytes, library, b):
    """A layout's two backward walks as the autograd backward calls them:
    dq, then dk and dv, in one timed call sequence beside the library's
    backward (dq, dk, dv) in the same run.  ``flops`` is b * h * 64 per
    visible (q, k) pair, the MACs of one t x t product: the bound counts
    the function's least work, five such products (s, dp, dq, dk, dv);
    the two walks compute seven (s and dp in both), ``walks_bound_ms``."""
    r = timed_record("flash_bwd", "paddle_tpu_torch/csrc/flash_walk.cuh",
                     replaces, err, fn, plain, 10 * flops, nbytes, library,
                     b)
    r.update(walks_bound_ms=bound(14 * flops, nbytes)[0],
             library_factor=r["ms"] / r["library_ms"])
    return r


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


#: phase 2's bthd flash-attention cases at the training path's shapes:
#: (name, tq, tk, bias, causal).  "pad" is the key-padding bias [b, 1, 1,
#: tk], "decoder" the causal-plus-padding bias [b, 1, tq, tk] (both -1e9),
#: "masked" the decoder bias with one row at -1e30; the ragged cases take
#: lengths that are multiples of neither 64 nor 128 (129 crosses the
#: forward's 128-row block by one)
FLASH_CASES = (("encoder self", 256, 256, "pad", False),
               ("decoder self", 256, 256, "decoder", False),
               ("cross trg 128 src 256", 128, 256, "pad", False),
               ("causal", 256, 256, "pad", True),
               ("causal tq>tk, -1e30 row", 256, 128, "masked", True),
               ("ragged decoder tq 200 tk 200", 200, 200, "decoder", False),
               ("ragged causal tq 136 tk 72, -1e30 row", 136, 72, "masked",
                True),
               ("ragged causal tq 129 tk 129", 129, 129, "decoder", True))
#: the case whose records go into the JSON line (the heaviest bias)
FLASH_RECORD_CASE = "decoder self"
TRAIN_BATCH, TRAIN_LEN = 32, 256


def _flash_inputs(gen, tq, tk, bias_kind, causal):
    """q, k, v, dO [b, t, 8, 64] and the case's bias; padded key tails of
    ragged lengths (row 0 unpadded)."""
    b, h, dh = TRAIN_BATCH, BASE["n_head"], BASE["d_key"]
    q, do = randn(gen, b, tq, h, dh), randn(gen, b, tq, h, dh)
    k, v = randn(gen, b, tk, h, dh), randn(gen, b, tk, h, dh)
    lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen)
    lens[0] = tk
    pad = (torch.arange(tk)[None, :] >= lens[:, None]).float() * -1e9
    bias = pad.reshape(b, 1, 1, tk)
    if bias_kind in ("decoder", "masked"):
        future = torch.ones(tq, tk).triu(1 + tk - tq) * -1e9
        bias = bias + future.reshape(1, 1, tq, tk)
    if bias_kind == "masked":
        bias[-1, 0, tq - 5, :] = -1e30
    return q, k, v, do, bias.cuda()


def _visible_pairs(tq, tk, causal):
    """(q, k) pairs a head computes: all, or the causally visible ones."""
    if not causal:
        return tq * tk
    return int(torch.ones(tq, tk).tril(tk - tq).sum().item())


def check_flash_attention(gen):
    """#4, #6 and #7 against their plain twins on FLASH_CASES (the
    backward kernels from the forward kernel's out and lse), each called
    twice for equal bits, at rate 0 and at DROPOUT; then each
    timed beside its twin and the library yardstick: masked
    ``F.scaled_dot_product_attention`` for #4, its backward (dq, dk and
    dv together) for #6 and #7, and for both walks in one call sequence
    (``flash_bwd``).  Returns {(kernel, case): record}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh = TRAIN_BATCH, BASE["n_head"], BASE["d_key"]
    scale = dh ** -0.5
    out = {}
    for name, tq, tk, bias_kind, causal in FLASH_CASES:
        q, k, v, do, bias = _flash_inputs(gen, tq, tk, bias_kind, causal)
        kw = dict(scale=scale, causal=causal)
        o, lse = ka.flash_fwd(q, k, v, bias, **kw)
        _require_same_bits(f"flash_fwd {name}", (o, lse),
                           ka.flash_fwd(q, k, v, bias, **kw))
        want_o, want_lse = ka.reference_flash_fwd(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        err_fwd = compare(f"flash_fwd {name}", o, want_o, TOL_KERNEL)
        hidden = torch.isinf(want_lse)
        require(torch.equal(hidden, torch.isinf(lse)),
                f"flash_fwd {name}: masked rows differ")
        require((bias_kind == "masked") == bool(hidden.any()),
                f"flash_fwd {name}: {int(hidden.sum())} masked rows")
        err_fwd = max(err_fwd, compare(f"flash_fwd {name} lse",
                                       lse[~hidden], want_lse[~hidden],
                                       TOL_KERNEL))
        delta = (do * o).sum(-1).transpose(1, 2).contiguous()
        bw = (q, k, v, bias, do, lse, delta)
        dq = ka.flash_bwd_dq(*bw, **kw)
        _require_same_bits(f"flash_bwd_dq {name}", (dq,),
                           (ka.flash_bwd_dq(*bw, **kw),))
        dk, dv = ka.flash_bwd_dkv(*bw, **kw)
        _require_same_bits(f"flash_bwd_dkv {name}", (dk, dv),
                           ka.flash_bwd_dkv(*bw, **kw))
        want_dq = ka.reference_flash_bwd_dq(*bw, **kw)
        want_dk, want_dv = ka.reference_flash_bwd_dkv(*bw, **kw)
        torch.cuda.synchronize()
        err_dq = compare(f"flash_bwd_dq {name}", dq, want_dq, TOL_KERNEL)
        err_dkv = max(compare(f"flash_bwd_dkv {name} dk", dk, want_dk,
                              TOL_KERNEL),
                      compare(f"flash_bwd_dkv {name} dv", dv, want_dv,
                              TOL_KERNEL))

        # the library yardstick: one SDPA call with the same additive mask
        mask = bias
        if causal:
            keep = torch.ones(tq, tk, dtype=torch.bool,
                              device=q.device).tril(tk - tq)
            mask = bias.masked_fill(~keep, -1e30)
        lq, lk, lv = (a.transpose(1, 2).detach().requires_grad_()
                      for a in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                 scale=scale)
        lib_do = do.transpose(1, 2)
        live = ~hidden.transpose(1, 2)[..., None].expand_as(o)
        lib_err = (lib_out.detach().transpose(1, 2)[live]
                   - want_o[live]).abs().max().item()

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    lq, lk, lv, attn_mask=mask, scale=scale)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lq, lk, lv), lib_do,
                                       retain_graph=True)

        pairs = _visible_pairs(tq, tk, causal)
        rows = F32 * b * h * (tq * dh)  # one [b, tq, h, dh] tensor
        keys = F32 * b * h * (tk * dh)
        bias_bytes = F32 * bias.numel()
        stats = F32 * 2 * b * h * tq  # lse and delta
        src = "paddle_tpu_torch/csrc/flash_attention.cu"
        flops = b * h * pairs * dh
        out[("flash_fwd", name)] = timed_record(
            "flash_fwd", src, "paddle_tpu/kernels/attention.py:550",
            err_fwd, lambda: ka.flash_fwd(q, k, v, bias, **kw),
            lambda: ka.reference_flash_fwd(q, k, v, bias, **kw), 4 * flops,
            2 * rows + 2 * keys + bias_bytes + stats // 2, lib_fwd, b)
        out[("flash_fwd", name)]["library_max_abs_err"] = lib_err
        out[("flash_bwd_dq", name)] = timed_record(
            "flash_bwd_dq", src, "paddle_tpu/kernels/attention.py:618",
            err_dq, lambda: ka.flash_bwd_dq(*bw, **kw),
            lambda: ka.reference_flash_bwd_dq(*bw, **kw), 6 * flops,
            3 * rows + 2 * keys + bias_bytes + stats, lib_bwd, b)
        out[("flash_bwd_dkv", name)] = timed_record(
            "flash_bwd_dkv", src, "paddle_tpu/kernels/attention.py:678",
            err_dkv, lambda: ka.flash_bwd_dkv(*bw, **kw),
            lambda: ka.reference_flash_bwd_dkv(*bw, **kw), 8 * flops,
            2 * rows + 4 * keys + bias_bytes + stats, lib_bwd, b)
        out[("flash_bwd", name)] = flash_bwd_record(
            "paddle_tpu/kernels/attention.py:618, :678",
            max(err_dq, err_dkv), lambda: (ka.flash_bwd_dq(*bw, **kw),
                                           ka.flash_bwd_dkv(*bw, **kw)),
            lambda: (ka.reference_flash_bwd_dq(*bw, **kw),
                     ka.reference_flash_bwd_dkv(*bw, **kw)), flops,
            3 * rows + 4 * keys + bias_bytes + stats, lib_bwd, b)
        del lib_out

        # weights dropout at DROPOUT under one seed: the same checks, the
        # backward from the dropped output, then each kernel timed
        dkw = dict(kw, dropout_rate=DROPOUT, dropout_seed=int(
            torch.randint(0, 2 ** 32, (1,), generator=gen)))
        o_d, lse_d = ka.flash_fwd(q, k, v, bias, **dkw)
        _require_same_bits(f"flash_fwd {name} dropout", (o_d, lse_d),
                           ka.flash_fwd(q, k, v, bias, **dkw))
        want_od, want_lsed = ka.reference_flash_fwd(q, k, v, bias, **dkw)
        torch.cuda.synchronize()
        require(torch.equal(torch.isinf(lse_d), hidden),
                f"flash_fwd {name} dropout: masked rows differ")
        require(not torch.allclose(o_d, o, atol=1e-3),
                f"flash_fwd {name}: dropout changed nothing")
        errs = [max(compare(f"flash_fwd {name} dropout", o_d, want_od,
                            TOL_KERNEL),
                    compare(f"flash_fwd {name} dropout lse", lse_d[~hidden],
                            want_lsed[~hidden], TOL_KERNEL))]
        delta_d = (do * o_d).sum(-1).transpose(1, 2).contiguous()
        bw_d = (q, k, v, bias, do, lse_d, delta_d)
        dq_d = ka.flash_bwd_dq(*bw_d, **dkw)
        _require_same_bits(f"flash_bwd_dq {name} dropout", (dq_d,),
                           (ka.flash_bwd_dq(*bw_d, **dkw),))
        dk_d, dv_d = ka.flash_bwd_dkv(*bw_d, **dkw)
        _require_same_bits(f"flash_bwd_dkv {name} dropout", (dk_d, dv_d),
                           ka.flash_bwd_dkv(*bw_d, **dkw))
        want_dk, want_dv = ka.reference_flash_bwd_dkv(*bw_d, **dkw)
        errs.append(compare(f"flash_bwd_dq {name} dropout", dq_d,
                            ka.reference_flash_bwd_dq(*bw_d, **dkw),
                            TOL_KERNEL))
        errs.append(max(compare(f"flash_bwd_dkv {name} dropout dk", dk_d,
                                want_dk, TOL_KERNEL),
                        compare(f"flash_bwd_dkv {name} dropout dv", dv_d,
                                want_dv, TOL_KERNEL)))
        del want_dk, want_dv
        hashes = ATTN_HASH_OPS * b * h * pairs
        for kernel, err, fn, mult, nbytes in (
                ("flash_fwd", errs[0],
                 lambda: ka.flash_fwd(q, k, v, bias, **dkw), 4,
                 2 * rows + 2 * keys + bias_bytes + stats // 2),
                ("flash_bwd_dq", errs[1],
                 lambda: ka.flash_bwd_dq(*bw_d, **dkw), 6,
                 3 * rows + 2 * keys + bias_bytes + stats),
                ("flash_bwd_dkv", errs[2],
                 lambda: ka.flash_bwd_dkv(*bw_d, **dkw), 8,
                 2 * rows + 4 * keys + bias_bytes + stats)):
            out[(kernel, name)].update(
                dropout_max_abs_err=err, dropout_ms=cuda_ms(fn),
                dropout_bound_ms=bound(mult * flops, nbytes, hashes)[0])
    return out


#: BERT-base as the reference's ``bench_bert`` runs it (``run_bert``):
#: 12 layers, 12 heads of 64, d_model 768, d_ff 3072, vocab 30522, seq 128,
#: batch 128, dropout 0.1, Adam 1e-4; f32 where the bench runs amp
BERT = dict(vocab_size=30522, seq_len=128, n_layer=12, n_head=12,
            d_model=768, d_ff=3072)
BERT_BATCH, BERT_LR, BERT_TIMED_STEPS = 128, 1e-4, 10
#: (i): the batch of step 1's CPU copies (float64 and f32)
BERT_PARITY_BATCH = 4
#: phase 2's bhtd flash-attention cases (#5, #8, #9) at BERT-base's
#: self-attention shapes, q, k, v [128, 12, t, 64]: (name, tq, tk, bias,
#: causal).  "pad" is BERT's key-padding bias [b, 1, 1, tk] (-1e9 on
#: ragged tails), "head" that plus a per-head bias [b, h, tq, tk] that
#: requires grad (the dbias path), "masked" the padding bias as [b, 1, tq,
#: tk] with one row at -1e30; the ragged cases take lengths that are
#: multiples of neither 64 nor 128 (129 crosses the forward's 128-row block
#: by one)
BHTD_CASES = (("bert self", 128, 128, "pad", False),
              ("per-head trainable bias", 128, 128, "head", False),
              ("causal", 128, 128, "pad", True),
              ("causal tq>tk, -1e30 row", 128, 64, "masked", True),
              ("cross tq 64 tk 128", 64, 128, "pad", False),
              ("ragged tq 72 tk 200", 72, 200, "pad", False),
              ("ragged causal tq 200 tk 136", 200, 136, "pad", True),
              ("ragged tq 129 tk 72", 129, 72, "pad", False))
#: the case whose records go into the JSON line (the main path's)
BHTD_RECORD_CASE = "bert self"


def _bhtd_inputs(gen, tq, tk, bias_kind):
    """q, dO [b, h, tq, 64], k, v [b, h, tk, 64] and the case's bias; padded
    key tails of ragged lengths (row 0 unpadded)."""
    b, h, dh = BERT_BATCH, BERT["n_head"], 64
    q, do = randn(gen, b, h, tq, dh), randn(gen, b, h, tq, dh)
    k, v = randn(gen, b, h, tk, dh), randn(gen, b, h, tk, dh)
    lens = torch.randint(tk // 2, tk + 1, (b,), generator=gen)
    lens[0] = tk
    pad = (torch.arange(tk)[None, :] >= lens[:, None]).float() * -1e9
    bias = pad.reshape(b, 1, 1, tk)
    if bias_kind == "head":
        bias = bias + torch.randn(b, h, tq, tk, generator=gen) * 0.5
    if bias_kind == "masked":
        bias = bias.expand(b, 1, tq, tk).clone()
        bias[-1, 0, tq - 5, :] = -1e30
    return q, k, v, do, bias.cuda()


def check_flash_attention_bhtd(gen):
    """#5, #8 and #9 against their plain twins on BHTD_CASES, at rate 0 and
    at DROPOUT under one seed, each kernel called twice for equal bits
    (the backward kernels from the forward kernel's out and lse); the
    trainable per-head bias also through ``flash_attention(fmt="bhtd")``'s
    autograd against autograd through the forward twin (dq, dk, dv and
    dbias).  Each kernel is then timed beside its twin and the library
    yardstick: ``F.scaled_dot_product_attention`` on the same [b, h, t, d]
    tensors with the bias (and the causal mask) as a float ``attn_mask``
    for #5, its backward (dq, dk and dv together) for #8 and #9, and for
    both walks in one call sequence (``flash_bwd_bhtd``).  Returns
    {(kernel, case): record}."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh = BERT_BATCH, BERT["n_head"], 64
    scale = dh ** -0.5
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    replaces = {"flash_fwd_bhtd": "paddle_tpu/kernels/attention.py:176",
                "flash_bwd_dq_bhtd": "paddle_tpu/kernels/attention.py:247",
                "flash_bwd_dkv_bhtd": "paddle_tpu/kernels/attention.py:303"}
    out = {}
    for name, tq, tk, bias_kind, causal in BHTD_CASES:
        q, k, v, do, bias = _bhtd_inputs(gen, tq, tk, bias_kind)
        kw = dict(scale=scale, causal=causal)
        seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen))
        errs, calls, o_rate0 = {}, {}, None
        for rate in (0.0, DROPOUT):
            rkw = dict(kw, dropout_rate=rate, dropout_seed=seed if rate else 0)
            tag = f"{name} rate {rate}"
            o, lse = ka.flash_fwd_bhtd(q, k, v, bias, **rkw)
            _require_same_bits(f"flash_fwd_bhtd {tag}", (o, lse),
                               ka.flash_fwd_bhtd(q, k, v, bias, **rkw))
            want_o, want_lse = ka.reference_flash_fwd_bhtd(q, k, v, bias,
                                                           **rkw)
            torch.cuda.synchronize()
            hidden = torch.isinf(want_lse)
            require(torch.equal(hidden, torch.isinf(lse)),
                    f"flash_fwd_bhtd {tag}: masked rows differ")
            require(bool(hidden.any()) == (causal and tq > tk),
                    f"flash_fwd_bhtd {tag}: {int(hidden.sum())} masked rows")
            err_fwd = max(compare(f"flash_fwd_bhtd {tag}", o, want_o,
                                  TOL_KERNEL),
                          compare(f"flash_fwd_bhtd {tag} lse", lse[~hidden],
                                  want_lse[~hidden], TOL_KERNEL))
            if rate:
                require(not torch.allclose(o, o_rate0, atol=1e-3),
                        f"flash_fwd_bhtd {name}: dropout changed nothing")
            o_rate0 = o
            delta = (do * o).sum(-1).contiguous()
            bw = (q, k, v, bias, do, lse, delta)
            dq = ka.flash_bwd_dq_bhtd(*bw, **rkw)
            _require_same_bits(f"flash_bwd_dq_bhtd {tag}", (dq,),
                               (ka.flash_bwd_dq_bhtd(*bw, **rkw),))
            dk, dv = ka.flash_bwd_dkv_bhtd(*bw, **rkw)
            _require_same_bits(f"flash_bwd_dkv_bhtd {tag}", (dk, dv),
                               ka.flash_bwd_dkv_bhtd(*bw, **rkw))
            err_dq = compare(f"flash_bwd_dq_bhtd {tag}", dq,
                             ka.reference_flash_bwd_dq_bhtd(*bw, **rkw),
                             TOL_KERNEL)
            want_dk, want_dv = ka.reference_flash_bwd_dkv_bhtd(*bw, **rkw)
            err_dkv = max(compare(f"flash_bwd_dkv_bhtd {tag} dk", dk,
                                  want_dk, TOL_KERNEL),
                          compare(f"flash_bwd_dkv_bhtd {tag} dv", dv,
                                  want_dv, TOL_KERNEL))
            del want_o, want_dk, want_dv
            errs[rate] = dict(flash_fwd_bhtd=err_fwd, flash_bwd_dq_bhtd=err_dq,
                              flash_bwd_dkv_bhtd=err_dkv)
            calls[rate] = dict(
                flash_fwd_bhtd=lambda rkw=rkw: ka.flash_fwd_bhtd(
                    q, k, v, bias, **rkw),
                flash_bwd_dq_bhtd=lambda bw=bw, rkw=rkw: ka.flash_bwd_dq_bhtd(
                    *bw, **rkw),
                flash_bwd_dkv_bhtd=lambda bw=bw, rkw=rkw: ka.
                flash_bwd_dkv_bhtd(*bw, **rkw))
            if bias_kind == "head":
                # the Function: dbias by the plain recompute, the rest by
                # the kernels, against autograd through the forward twin
                grads = []
                for fn in (lambda *a: ka.flash_attention(*a, fmt="bhtd",
                                                         **rkw),
                           lambda *a: ka.reference_flash_fwd_bhtd(
                               *a, **rkw)[0]):
                    args = [a.detach().clone().requires_grad_()
                            for a in (q, k, v, bias)]
                    fn(*args).backward(do)
                    grads.append([a.grad for a in args])
                for what, got, want in zip(("dq", "dk", "dv", "dbias"),
                                           *grads):
                    compare(f"flash_attention bhtd {tag} autograd {what}",
                            got, want, TOL_KERNEL)
                del grads

        # the library yardstick: SDPA on the same tensors and mask
        mask = bias
        if causal:
            keep = torch.ones(tq, tk, dtype=torch.bool,
                              device=q.device).tril(tk - tq)
            mask = bias.masked_fill(~keep, -1e30)
        lq, lk, lv = (a.detach().requires_grad_() for a in (q, k, v))
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask,
                                                 scale=scale)
        want_o0, want_lse0 = ka.reference_flash_fwd_bhtd(q, k, v, bias, **kw)
        lib_err = (lib_out.detach() - want_o0)[
            ~torch.isinf(want_lse0)].abs().max().item()
        del want_o0, want_lse0

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    lq, lk, lv, attn_mask=mask, scale=scale)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lq, lk, lv), do,
                                       retain_graph=True)

        pairs = _visible_pairs(tq, tk, causal)
        rows = F32 * b * h * tq * dh  # one [b, h, tq, dh] tensor
        keys = F32 * b * h * tk * dh
        bias_bytes = F32 * bias.numel()
        stats = F32 * 2 * b * h * tq  # lse and delta
        flops = b * h * pairs * dh
        hashes = ATTN_HASH_OPS * b * h * pairs
        o0, lse0 = ka.flash_fwd_bhtd(q, k, v, bias, **kw)
        bw0 = (q, k, v, bias, do, lse0, (do * o0).sum(-1).contiguous())
        plain = dict(
            flash_fwd_bhtd=lambda: ka.reference_flash_fwd_bhtd(q, k, v, bias,
                                                               **kw),
            flash_bwd_dq_bhtd=lambda: ka.reference_flash_bwd_dq_bhtd(
                *bw0, **kw),
            flash_bwd_dkv_bhtd=lambda: ka.reference_flash_bwd_dkv_bhtd(
                *bw0, **kw))
        for kernel, mult, nbytes, lib in (
                ("flash_fwd_bhtd", 4,
                 2 * rows + 2 * keys + bias_bytes + stats // 2, lib_fwd),
                ("flash_bwd_dq_bhtd", 6,
                 3 * rows + 2 * keys + bias_bytes + stats, lib_bwd),
                ("flash_bwd_dkv_bhtd", 8,
                 2 * rows + 4 * keys + bias_bytes + stats, lib_bwd)):
            r = timed_record(kernel, src, replaces[kernel], errs[0.0][kernel],
                             calls[0.0][kernel], plain[kernel], mult * flops,
                             nbytes, lib, b)
            r.update(dropout_max_abs_err=errs[DROPOUT][kernel],
                     dropout_ms=cuda_ms(calls[DROPOUT][kernel]),
                     dropout_bound_ms=bound(mult * flops, nbytes,
                                            hashes)[0])
            if kernel == "flash_fwd_bhtd":
                r["library_max_abs_err"] = lib_err
            out[(kernel, name)] = r
        out[("flash_bwd_bhtd", name)] = flash_bwd_record(
            "paddle_tpu/kernels/attention.py:247, :303",
            max(errs[0.0]["flash_bwd_dq_bhtd"],
                errs[0.0]["flash_bwd_dkv_bhtd"]),
            lambda: (calls[0.0]["flash_bwd_dq_bhtd"](),
                     calls[0.0]["flash_bwd_dkv_bhtd"]()),
            lambda: (plain["flash_bwd_dq_bhtd"](),
                     plain["flash_bwd_dkv_bhtd"]()), flops,
            3 * rows + 4 * keys + bias_bytes + stats, lib_bwd, b)
        del lib_out, calls, bw0
    return out


#: phase 2's fused-projection training cases (#1 with residuals, #2, #3)
#: at the training path's shapes: (name, t, bias, causal).  "pad" is the
#: key-padding bias [b, 1, 1, t], "decoder" the causal-plus-padding bias
#: [b, 1, t, t] (both -1e9), "masked" the decoder bias with one row at
#: -1e30 on every key
QKV_CASES = (("encoder self", 256, "pad", False),
             ("decoder self", 256, "decoder", False),
             ("causal", 256, None, True),
             ("ragged t 200, -1e30 row", 200, "masked", False))
QKV_RECORD_CASE = "decoder self"


def _qkv_inputs(gen, t, bias_kind, b=None, dm=None):
    """x, g = dL/dy [b, t, d_model], the packed weights and the case's
    bias; padded key tails of ragged lengths (row 0 unpadded).  b and
    d_model default to the training step's (TRAIN_BATCH, BASE), the heads
    to d_model / 64 of width 64."""
    b, dm = b or TRAIN_BATCH, dm or BASE["d_model"]
    hd = dm
    x, g = randn(gen, b, t, dm), randn(gen, b, t, dm)
    w_qkv = randn(gen, dm, 3 * hd, scale=dm ** -0.5)
    w_out = randn(gen, hd, dm, scale=hd ** -0.5)
    if bias_kind is None:
        return x, w_qkv, w_out, g, None
    lens = torch.randint(t // 2, t + 1, (b,), generator=gen)
    lens[0] = t
    bias = ((torch.arange(t)[None, :] >= lens[:, None]).float()
            * -1e9).reshape(b, 1, 1, t)
    if bias_kind in ("decoder", "masked"):
        bias = bias + (torch.ones(t, t).triu(1) * -1e9).reshape(1, 1, t, t)
    if bias_kind == "masked":
        bias[-1, 0, t - 5, :] = -1e30
    return x, w_qkv, w_out, g, bias.cuda()


def _library_mha(x, w_qkv, w_out, bias, g, n_head, causal):
    """One ``F.multi_head_attention_forward`` call on the same weights and
    additive mask (a yardstick only): (its y [b, t, dm], the no-grad
    forward, the backward giving dx, dW_in and dW_out together)."""
    import torch.nn.functional as F

    b, t, dm = x.shape
    mask = torch.zeros(1, 1, t, t, device=x.device)
    if bias is not None:
        mask = mask + bias
    if causal:
        mask = mask.masked_fill(torch.ones(t, t, dtype=torch.bool,
                                           device=x.device).triu(1), -1e30)
    mask = mask.expand(b, n_head, t, t).reshape(b * n_head, t, t)
    lx = x.transpose(0, 1).detach().requires_grad_()
    w_in = w_qkv.t().contiguous().requires_grad_()
    w_o = w_out.t().contiguous().requires_grad_()

    def call():
        return F.multi_head_attention_forward(
            lx, lx, lx, dm, n_head, w_in, None, None, None, False, 0.0, w_o,
            None, training=False, attn_mask=mask, need_weights=False)[0]

    out = call()
    lg = g.transpose(0, 1)

    def fwd():
        with torch.no_grad():
            return call()

    def bwd():
        return torch.autograd.grad(out, (lx, w_in, w_o), lg,
                                   retain_graph=True)

    return out.detach().transpose(0, 1), fwd, bwd


def _held_qkv_fwd(what, fw, kw, masked):
    """#1 in residual mode on ``fw`` under ``kw``, called twice: equal
    bits, the twin's masked rows (some exactly when ``masked``) with ctx 0
    and lse +inf, and y, ctx and the other rows' lse within TOL_KERNEL of
    the twin.  Returns ((y, ctx, lse), the twin's, the masked rows [b, h,
    t], the max abs error)."""
    from paddle_tpu_torch.kernels import attention as ka

    got = ka.qkv_attention_fwd(*fw, **kw)
    again = ka.qkv_attention_fwd(*fw, **kw)
    want = ka.reference_qkv_fwd(*fw, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            f"{what}: two calls on the same inputs differ")
    (y, ctx, lse), (want_y, want_ctx, want_lse) = got, want
    hidden = torch.isinf(want_lse)
    require(torch.equal(hidden, torch.isinf(lse)),
            f"{what}: masked rows differ")
    require(masked == bool(hidden.any()),
            f"{what}: {int(hidden.sum())} masked rows")
    require(not ctx[hidden.transpose(1, 2)].any().item(),
            f"{what}: a masked row's ctx is not 0")
    err = max(compare(f"{what} y", y, want_y, TOL_KERNEL),
              compare(f"{what} ctx", ctx, want_ctx, TOL_KERNEL),
              compare(f"{what} lse", lse[~hidden], want_lse[~hidden],
                      TOL_KERNEL))
    return got, want, hidden, err


def _qkv_bwd_bytes(b, t, dm, h, bias):
    """Bytes the pair #2 + #3 must move: x, g and dx [b, t, dm], ctx [b,
    t, hd], lse, the bias, w_qkv and w_out in, dW_qkv and dW_out out."""
    hd = h * 64
    return F32 * (3 * b * t * dm + b * t * hd + b * h * t
                  + 2 * (dm * 3 * hd + hd * dm)
                  + (bias.numel() if bias is not None else 0))


def _qkv_pair_flops(proj, attn):
    """f32 FLOPs the pair #2 + #3 must do, from one projection-sized
    product ``proj`` and one t x t product of every head ``attn``: 11 of
    the first (q|k|v, dctx, dx over 3hd, dW_qkv, dW_out) and 5 of the
    second (s and dp once, dq, dk, dv).  The kernel's dkv walk computes s
    and dp again: that is its layout's overhead, not the function's
    work."""
    return 11 * proj + 5 * attn


def _held_qkv_pair(what, bw, kw, rows, dx_kv=None):
    """The pair #2 + #3 (``qkv_bwd``) on ``bw`` under ``kw``, called twice:
    equal bits, and dx, dW_qkv and dW_out within TOL_KERNEL of
    ``reference_qkv_bwd``.  On the masked rows ``rows`` [b, t] (query rows
    the forward masked) the dq walk contributes exact zeros, so dx there
    must equal #3's ``dx_kv`` bit for bit where it is given.  Returns the
    max abs error."""
    from paddle_tpu_torch.kernels import attention as ka

    got = ka.qkv_bwd(*bw, **kw)
    again = ka.qkv_bwd(*bw, **kw)
    want = ka.reference_qkv_bwd(*bw, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            f"{what}: two calls on the same inputs differ")
    err = max(compare(f"{what} {part}", a, w, TOL_KERNEL)
              for part, a, w in zip(("dx", "dW_qkv", "dW_out"), got, want))
    if dx_kv is not None and rows.any():
        require(torch.equal(got[0][rows], dx_kv[rows]),
                f"{what}: a masked row's dx is not #3's dx_kv (the dq walk "
                f"gave it a nonzero part)")
    return err


#: the pair's BERT-base case: (name, b, t, d_model, bias, causal), the
#: self-attention of phase 3 (i)'s ``use_flash`` route
QKV_PAIR_BERT = ("bert self", 128, 128, 768, "pad", False)


def _normwise(name, got, exact, tol):
    """Max abs error of ``got`` against the float64 ``exact``; raises
    unless it is within ``tol`` of exact's largest magnitude."""
    require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    err = (got.double() - exact).abs().max().item()
    scale = exact.abs().max().item()
    require(err <= tol * scale, f"{name}: max abs err {err} over {tol} of "
                                f"its largest magnitude {scale}")
    return err


def _held_qkv_pair_f64(what, bw, kw):
    """The pair on ``bw`` under ``kw``, twice for equal bits, against the
    twin in float64 on the same inputs (#1's f32 residuals included): dx
    within TOL_KERNEL elementwise, dW_qkv and dW_out (sums over all b*t
    rows) within TOL_KERNEL of their largest magnitude, and each part
    within TOL_KERNEL elementwise of the f32 twin on the card.  The dW's
    hold elementwise against the twin because ``gemm.cuh`` sums BERT-base's
    16384 rows in slabs of at most 1024 (C13); in one f32 sum per 8192 rows
    their near-zero elements would not.  Returns the max abs error and
    {part: (the kernel's max abs error, the f32 twin's on the card, the
    kernel's largest excess over TOL_KERNEL against the twin
    elementwise)}, the first two against float64: the twin's is the
    library's own at this shape."""
    from paddle_tpu_torch.kernels import attention as ka

    got = ka.qkv_bwd(*bw, **kw)
    again = ka.qkv_bwd(*bw, **kw)
    torch.cuda.synchronize()
    require(all(torch.equal(a, c) for a, c in zip(got, again)),
            f"{what}: two calls on the same inputs differ")
    del again
    exact = ka.reference_qkv_bwd(
        *(None if a is None else a.double() for a in bw), **kw)
    twin = ka.reference_qkv_bwd(*bw, **kw)
    parts = {}
    for part, a, w, f in zip(("dx", "dW_qkv", "dW_out"), got, exact, twin):
        err = (compare(f"{what} dx", a, w, TOL_KERNEL) if part == "dx"
               else _normwise(f"{what} {part}", a, w, TOL_KERNEL))
        # the kernel against the f32 twin elementwise: the largest of
        # |got - twin| - TOL_KERNEL * |twin|, within TOL_KERNEL
        off = ((a - f).abs() - TOL_KERNEL * f.abs()).max().item()
        compare(f"{what} {part} against the f32 twin", a, f, TOL_KERNEL)
        parts[part] = (err, (f.double() - w).abs().max().item(), off)
    return max(p[0] for p in parts.values()), parts


def check_qkv_pair_bert(gen):
    """The pair #2 + #3 at BERT-base's self-attention (QKV_PAIR_BERT)
    against its float64 twin at rates 0 and DROPOUT
    (``_held_qkv_pair_f64``), each called twice for equal bits, and timed
    beside its f32 twin, its bound and the library backward.  Returns the
    record."""
    from paddle_tpu_torch.kernels import attention as ka

    name, b, t, dm, bias_kind, causal = QKV_PAIR_BERT
    h, dh = dm // 64, 64
    x, w_qkv, w_out, g, bias = _qkv_inputs(gen, t, bias_kind, b, dm)
    kw = dict(n_head=h, scale=dh ** -0.5, causal=causal)
    fw = (x, w_qkv, w_out, bias)
    errs, bws, vs_f64 = {}, {}, {}
    for rate in (0.0, DROPOUT):
        rkw = dict(kw, dropout_rate=rate, dropout_seed=int(torch.randint(
            0, 2 ** 32, (1,), generator=gen)))
        _, ctx, lse = ka.qkv_attention_fwd(*fw, **rkw)
        bws[rate] = ((x, w_qkv, w_out, bias, g, ctx, lse), rkw)
        errs[rate], vs_f64[rate] = _held_qkv_pair_f64(
            f"qkv_bwd {name} rate {rate}", bws[rate][0], rkw)
    _, _, lib_bwd = _library_mha(x, w_qkv, w_out, bias, g, h, causal)
    pairs = _visible_pairs(t, t, causal)
    flops = _qkv_pair_flops(2 * b * t * dm * dm, 2 * b * h * pairs * dh)
    nbytes = _qkv_bwd_bytes(b, t, dm, h, bias)
    bw, rkw = bws[0.0]
    rec = timed_record(
        "qkv_bwd", "paddle_tpu_torch/csrc/qkv_attention_bwd.cu",
        "paddle_tpu/kernels/attention.py:1454 + :1546", errs[0.0],
        lambda: ka.qkv_bwd(*bw, **rkw),
        lambda: ka.reference_qkv_bwd(*bw, **rkw), flops, nbytes, lib_bwd, b)
    bw_d, dkw = bws[DROPOUT]
    rec.update(case=name, t=t, d_model=dm, dropout_max_abs_err=errs[DROPOUT],
               # {rate: {part: (kernel, f32 twin, kernel - twin excess)}}:
               # max abs against float64, then the elementwise excess
               vs_float64=vs_f64,
               dropout_ms=cuda_ms(lambda: ka.qkv_bwd(*bw_d, **dkw)),
               dropout_bound_ms=bound(flops, nbytes,
                                      ATTN_HASH_OPS * b * h * pairs)[0])
    return rec


def check_gemm(gen):
    """``gemm.cuh``'s tile alone (``kernels.gemm.gemm``, ``csrc/gemm.cu``)
    at the pair's record-case products (GEMM_CASES, in the layouts the
    pair gives them) and at BERT-base's dW_qkv (GEMM_BERT_DW): within
    TOL_KERNEL of ``torch.matmul`` (TF32 off), equal bits on a repeat,
    timed beside it.  Returns the records, each with its TFLOP/s and share
    of the f32 peak beside ``torch.matmul``'s and the depth of the slab it
    sums in one running f32 sum (C13's bound); the BERT case also with
    both products' max abs error against the product in float64."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import gemm as kg
    from paddle_tpu_torch.kernels.attention import sm_count

    out = []
    for name, m, n, k, a_t, b_t, split in GEMM_CASES + (GEMM_BERT_DW,):
        # a scaled by K^-1/2, as the weights are: c of unit size
        a = (randn(gen, k, m, scale=k ** -0.5).t() if a_t
             else randn(gen, m, k, scale=k ** -0.5))
        b = randn(gen, n, k).t() if b_t else randn(gen, k, n)
        got, again = kg.gemm(a, b, split), kg.gemm(a, b, split)
        want = torch.matmul(a, b)
        torch.cuda.synchronize()
        require(torch.equal(got, again), f"gemm {name}: two calls differ")
        err = compare(f"gemm {name}", got, want, TOL_KERNEL)
        f64 = None
        if (name, m, n, k, a_t, b_t, split) == GEMM_BERT_DW:
            exact = torch.matmul(a.double(), b.double())
            f64 = dict(kernel=(got.double() - exact).abs().max().item(),
                       matmul=(want.double() - exact).abs().max().item())
            del exact
        flops = 2 * m * n * k
        rec = timed_record(
            "gemm", "paddle_tpu_torch/csrc/gemm.cuh",
            "none: the f32 tile inside #1's y, #2 + #3 and #19", err,
            lambda: kg.gemm(a, b, split), lambda: kg.reference_gemm(a, b),
            flops, F32 * (m * k + k * n + m * n), lambda: torch.matmul(a, b),
            m)
        rec.update(case=name, m=m, n=n, k=k, a_kmajor=a_t, b_kmajor=not b_t,
                   slab=_build.lib().ptt_gemm_slab(m, n, k, sm_count(
                       a.device)) if split else k,
                   tflops=flops / rec["ms"] / 1e9,
                   peak_share=flops / rec["ms"] / 1e9 / PEAK_F32_FLOPS
                   * 1e12,
                   matmul_tflops=flops / rec["library_ms"] / 1e9)
        if f64 is not None:
            rec["vs_float64"] = f64
        out.append(rec)
        del a, b, got, again, want
    return out


#: gemm.cuh at the pair's record case (b 32, t 256, d_model 512, 8 heads):
#: (name, M, N, K, a given transposed, b given transposed, split), the
#: operand layouts of qkv_attention_bwd.cu's products and whether it splits
#: them over K (its dW products only)
GEMM_CASES = (("dx = dqkv w_qkv^T", 8192, 512, 1536, False, True, False),
              ("dW_qkv = x^T dqkv", 512, 1536, 8192, True, False, True),
              ("q|k|v = x w_qkv", 8192, 1536, 512, False, False, False))
#: the pair's dW_qkv at BERT-base (b 128, t 128, d_model 768, 12 heads),
#: where C13's slab depth decides the sum's error
GEMM_BERT_DW = ("BERT dW_qkv = x^T dqkv", 768, 2304, 16384, True, False,
                True)


def check_qkv_training(gen):
    """#1 in residual mode (y, ctx, lse), #2 and #3 alone and the pair #2
    + #3 (``qkv_bwd``, the autograd backward's one call) against their
    plain twins on QKV_CASES (the backward kernels from the forward
    kernel's residuals), at rates 0 and DROPOUT, each called twice on the
    same inputs for equal bits; a masked row must give ctx 0, lse +inf,
    zero dx_q, and in the pair #3's dx_kv bit for bit.  Then each timed
    beside its twin and the library yardstick: the no-grad forward of one
    ``F.multi_head_attention_forward`` for #1, its backward (dx, dW_in,
    dW_out together: the whole of #2 + #3's work) for #2, #3 and the pair.
    Returns {(kernel, case): record}; the pair's record at BERT-base's
    self-attention (``check_qkv_pair_bert``) under ("qkv_bwd", its
    case)."""
    from paddle_tpu_torch.kernels import attention as ka

    b, h, dh, dm = (TRAIN_BATCH, BASE["n_head"], BASE["d_key"],
                    BASE["d_model"])
    hd = h * dh
    out = {}
    for name, t, bias_kind, causal in QKV_CASES:
        x, w_qkv, w_out, g, bias = _qkv_inputs(gen, t, bias_kind)
        kw = dict(n_head=h, scale=dh ** -0.5, causal=causal)
        fw = (x, w_qkv, w_out, bias)
        (y, ctx, lse), (want_y, _, want_lse), hidden, err_fwd = \
            _held_qkv_fwd(f"qkv_attention_fwd {name}", fw, kw,
                          bias_kind == "masked")
        rows = hidden.transpose(1, 2)  # [b, t, h]

        bw = (x, w_qkv, w_out, bias, g, ctx, lse)
        got_dq, got_dkv = ka.qkv_bwd_dq(*bw, **kw), ka.qkv_bwd_dkv(*bw, **kw)
        want_dq = ka.reference_qkv_bwd_dq(*bw, **kw)
        want_dkv = ka.reference_qkv_bwd_dkv(*bw, **kw)
        again = ka.qkv_bwd_dq(*bw, **kw) + ka.qkv_bwd_dkv(*bw, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(got_dq + got_dkv,
                                                      again)),
                f"qkv_bwd {name}: two calls on the same inputs differ")
        errs = []
        for kernel, parts, got, want in (
                ("qkv_bwd_dq", ("dx_q", "dW_q", "dW_out"), got_dq, want_dq),
                ("qkv_bwd_dkv", ("dx_kv", "dW_k", "dW_v"), got_dkv,
                 want_dkv)):
            errs.append(max(compare(f"{kernel} {name} {part}", a, w,
                                    TOL_KERNEL)
                            for part, a, w in zip(parts, got, want)))
        require(not got_dq[0][rows.any(-1)].any().item(),
                f"qkv_bwd_dq {name}: a masked row's dx_q is not 0")
        err_pair = _held_qkv_pair(f"qkv_bwd {name}", bw, kw, rows.any(-1),
                                  got_dkv[0])
        del got_dq, got_dkv, again

        lib_y, lib_fwd, lib_bwd = _library_mha(x, w_qkv, w_out, bias, g, h,
                                               causal)
        live = ~rows.any(-1)
        lib_err = (lib_y[live] - want_y[live]).abs().max().item()
        pairs = _visible_pairs(t, t, causal)
        proj = 2 * b * t * dm * hd  # one projection-sized product
        attn = 2 * b * h * pairs * dh  # one t x t product of every head
        io = F32 * (b * t * hd + b * h * t + dm * 3 * hd + hd * dm
                    + (bias.numel() if bias is not None else 0))
        act = F32 * b * t * dm  # one [b, t, d_model] tensor
        src = "paddle_tpu_torch/csrc/qkv_attention_bwd.cu"
        out[("qkv_attention_fwd", name)] = timed_record(
            "qkv_attention_fwd", "paddle_tpu_torch/csrc/qkv_attention.cu",
            "paddle_tpu/kernels/attention.py:1377", err_fwd,
            lambda: ka.qkv_attention_fwd(*fw, **kw),
            lambda: ka.reference_qkv_fwd(*fw, **kw), 4 * proj + 2 * attn,
            2 * act + io, lib_fwd, b)
        out[("qkv_attention_fwd", name)].update(
            library_max_abs_err=lib_err,
            plan=list(ka.qkv_fwd_plan(b, t, h, ka.sm_count(x.device))))
        out[("qkv_bwd_dq", name)] = timed_record(
            "qkv_bwd_dq", src, "paddle_tpu/kernels/attention.py:1454",
            errs[0], lambda: ka.qkv_bwd_dq(*bw, **kw),
            lambda: ka.reference_qkv_bwd_dq(*bw, **kw),
            7 * proj + 3 * attn, 3 * act + io + F32 * 2 * dm * hd, lib_bwd,
            b)
        out[("qkv_bwd_dkv", name)] = timed_record(
            "qkv_bwd_dkv", src, "paddle_tpu/kernels/attention.py:1546",
            errs[1], lambda: ka.qkv_bwd_dkv(*bw, **kw),
            lambda: ka.reference_qkv_bwd_dkv(*bw, **kw),
            8 * proj + 4 * attn, 3 * act + io + F32 * 2 * dm * hd, lib_bwd,
            b)
        out[("qkv_bwd", name)] = timed_record(
            "qkv_bwd", src, "paddle_tpu/kernels/attention.py:1454 + :1546",
            err_pair, lambda: ka.qkv_bwd(*bw, **kw),
            lambda: ka.reference_qkv_bwd(*bw, **kw),
            _qkv_pair_flops(proj, attn),
            _qkv_bwd_bytes(b, t, dm, h, bias), lib_bwd, b)
        del lib_fwd, lib_bwd

        # weights dropout at DROPOUT under one seed: #1's residuals, then
        # #2 and #3 from them (twice, for equal bits), each timed
        dkw = dict(kw, dropout_rate=DROPOUT, dropout_seed=int(
            torch.randint(0, 2 ** 32, (1,), generator=gen)))
        y_d, ctx_d, lse_d = ka.qkv_attention_fwd(*fw, **dkw)
        want_yd, want_ctxd, _ = ka.reference_qkv_fwd(*fw, **dkw)
        torch.cuda.synchronize()
        require(not torch.allclose(y_d, y, atol=1e-3),
                f"qkv_attention_fwd {name}: dropout changed nothing")
        errs = [max(compare(f"qkv_attention_fwd {name} dropout y", y_d,
                            want_yd, TOL_KERNEL),
                    compare(f"qkv_attention_fwd {name} dropout ctx", ctx_d,
                            want_ctxd, TOL_KERNEL))]
        errs[0] = max(errs[0], compare(
            f"qkv_attention_fwd {name} dropout lse", lse_d[~hidden],
            want_lse[~hidden], TOL_KERNEL))
        bw_d = (x, w_qkv, w_out, bias, g, ctx_d, lse_d)
        got_d = ka.qkv_bwd_dq(*bw_d, **dkw) + ka.qkv_bwd_dkv(*bw_d, **dkw)
        again = ka.qkv_bwd_dq(*bw_d, **dkw) + ka.qkv_bwd_dkv(*bw_d, **dkw)
        want_d = (ka.reference_qkv_bwd_dq(*bw_d, **dkw)
                  + ka.reference_qkv_bwd_dkv(*bw_d, **dkw))
        torch.cuda.synchronize()
        require(all(torch.equal(a, c) for a, c in zip(got_d, again)),
                f"qkv_bwd {name} dropout: two calls differ")
        parts = ("dx_q", "dW_q", "dW_out", "dx_kv", "dW_k", "dW_v")
        cmp = [compare(f"qkv_bwd {name} dropout {part}", a, w, TOL_KERNEL)
               for part, a, w in zip(parts, got_d, want_d)]
        errs += [max(cmp[:3]), max(cmp[3:])]
        errs.append(_held_qkv_pair(f"qkv_bwd {name} dropout", bw_d, dkw,
                                   rows.any(-1), got_d[3]))
        del got_d, again, want_d
        hashes = ATTN_HASH_OPS * b * h * pairs
        for kernel, err, fn, flops, nbytes in (
                ("qkv_attention_fwd", errs[0],
                 lambda: ka.qkv_attention_fwd(*fw, **dkw),
                 4 * proj + 2 * attn, 2 * act + io),
                ("qkv_bwd_dq", errs[1], lambda: ka.qkv_bwd_dq(*bw_d, **dkw),
                 7 * proj + 3 * attn, 3 * act + io + F32 * 2 * dm * hd),
                ("qkv_bwd_dkv", errs[2],
                 lambda: ka.qkv_bwd_dkv(*bw_d, **dkw), 8 * proj + 4 * attn,
                 3 * act + io + F32 * 2 * dm * hd),
                ("qkv_bwd", errs[3], lambda: ka.qkv_bwd(*bw_d, **dkw),
                 _qkv_pair_flops(proj, attn),
                 _qkv_bwd_bytes(b, t, dm, h, bias))):
            out[(kernel, name)].update(
                dropout_max_abs_err=err, dropout_ms=cuda_ms(fn),
                dropout_bound_ms=bound(flops, nbytes, hashes)[0])
    out[("qkv_bwd", QKV_PAIR_BERT[0])] = check_qkv_pair_bert(gen)
    return out


#: phase 2's cases of #1's routes (``kernels.attention.qkv_fwd_plan``):
#: (name, b, t, d_model, bias, causal), heads of 64, each run at rates 0
#: and DROPOUT.  Between them they reach a one-block cluster (t 8), BERT-
#: base's self-attention (C 2), a ragged last block of 8 rows in 32 (t
#: 200, R 32, C 7), the b=1 prefill's 32-row blocks (C 8), the b=64
#: decoder (C 4, R 64), the largest cluster (t 512: C 8, R 64) and the
#: long-sequence "tiles" route (t 640); b stays small at t 512 and 640.
QKV_PLAN_CASES = (("t 8", 4, 8, 512, "pad", False),
                  ("bert self", 128, 128, 768, "pad", False),
                  ("ragged t 200, -1e30 row", 4, 200, 512, "masked", False),
                  ("b 1 t 256 causal", 1, 256, 512, None, True),
                  ("b 64 decoder", 64, 256, 512, "decoder", False),
                  ("t 512 causal, -1e30 row", 2, 512, 512, "masked", True),
                  ("tiles t 640", 2, 640, 512, "pad", False))


def check_qkv_plans(gen):
    """#1 in residual mode on every route of ``qkv_fwd_plan``
    (QKV_PLAN_CASES): y, ctx and lse against the twin within TOL_KERNEL at
    rates 0 and DROPOUT, each call repeated for equal bits, masked rows
    with ctx 0 and lse +inf; each case timed beside its twin and one
    ``F.multi_head_attention_forward``.  Returns {case: record}, each with
    its plan; the cluster occupancy (``cudaOccupancyMaxActiveClusters``)
    of 8-block clusters at R = 32 and 64 is printed."""
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import attention as ka

    lib = _build.lib()
    for rows in (32, 64):
        n = lib.ptt_qkv_cluster_occupancy(rows, ka.CLUSTER_MAX)
        require(n > 0, f"qkv cluster occupancy R={rows}: {n}")
        print(f"phase 2: qkv_attention_fwd clusters of {ka.CLUSTER_MAX} "
              f"blocks of {rows} rows resident at once: {n}")
    out = {}
    for name, b, t, dm, bias_kind, causal in QKV_PLAN_CASES:
        h, dh = dm // 64, 64
        x, w_qkv, w_out, g, bias = _qkv_inputs(gen, t, bias_kind, b, dm)
        plan = ka.qkv_fwd_plan(b, t, h, ka.sm_count(x.device))
        fw = (x, w_qkv, w_out, bias)
        errs = {}
        for rate in (0.0, DROPOUT):
            kw = dict(n_head=h, scale=dh ** -0.5, causal=causal,
                      dropout_rate=rate, dropout_seed=int(torch.randint(
                          0, 2 ** 32, (1,), generator=gen)))
            errs[rate] = _held_qkv_fwd(
                f"qkv_attention_fwd {name} rate {rate}", fw, kw,
                bias_kind == "masked")[3]
        _, lib_fwd, _ = _library_mha(x, w_qkv, w_out, bias, g, h, causal)
        pairs = _visible_pairs(t, t, causal)
        proj = 2 * b * t * dm * dm
        attn = 2 * b * h * pairs * dh
        io = F32 * (b * t * dm + b * h * t + dm * 3 * dm + dm * dm
                    + (bias.numel() if bias is not None else 0))
        kw = dict(n_head=h, scale=dh ** -0.5, causal=causal)
        rec = timed_record(
            "qkv_attention_fwd", "paddle_tpu_torch/csrc/qkv_attention.cu",
            "paddle_tpu/kernels/attention.py:1377", errs[0.0],
            lambda: ka.qkv_attention_fwd(*fw, **kw),
            lambda: ka.reference_qkv_fwd(*fw, **kw), 4 * proj + 2 * attn,
            2 * F32 * b * t * dm + io, lib_fwd, b)
        dkw = dict(kw, dropout_rate=DROPOUT, dropout_seed=1)
        # at t 8 the call is shorter than the host's enqueue of it: ms
        # counts the host, device_ms hides it
        rec.update(plan=list(plan), t=t, d_model=dm, causal=causal,
                   bias=bias_kind, dropout_max_abs_err=errs[DROPOUT],
                   device_ms=cuda_ms(lambda: ka.qkv_attention_fwd(*fw, **kw),
                                     hide_host=True),
                   dropout_ms=cuda_ms(
                       lambda: ka.qkv_attention_fwd(*fw, **dkw)),
                   dropout_bound_ms=bound(
                       4 * proj + 2 * attn, 2 * F32 * b * t * dm + io,
                       ATTN_HASH_OPS * b * h * pairs)[0])
        out[name] = rec
        del lib_fwd, x, w_qkv, w_out, g, bias
    return out


#: phase 2's head-width-128 shape (C2): b, t, heads, head width
HEAD128 = (2, 64, 2, 128)


def check_head_width_128(gen):
    """C2 on the card: ``flash_qkv_attention`` and ``flash_attention(
    fmt="bthd")`` at head width 128, where the reference launches its
    kernels and the port's are compiled for 64 only, raise before any
    launch: no kernel launched, nothing composed.  Returns the error
    messages."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import attention as ka

    b, t, h, dh = HEAD128
    dm = h * dh
    x = randn(gen, b, t, dm)
    w_qkv = randn(gen, dm, 3 * dm, scale=dm ** -0.5)
    w_out = randn(gen, dm, dm, scale=dm ** -0.5)
    q, k, v = (randn(gen, b, t, h, dh) for _ in range(3))
    out = {}
    for what, call in (
            ("qkv_attention_fwd",
             lambda: ka.flash_qkv_attention(x, w_qkv, w_out, n_head=h,
                                            scale=dh ** -0.5)),
            ("flash_fwd",
             lambda: ka.flash_attention(q, k, v, scale=dh ** -0.5,
                                        fmt="bthd"))):
        kernels.reset_launches()
        try:
            call()
        except ValueError as exc:
            out[what] = str(exc)
        torch.cuda.synchronize()
        require(what in out and "head width 128" in out[what],
                f"head width 128 {what}: no error ({out.get(what)})")
        launches, composed = dict(kernels.launches), dict(kernels.composed)
        require(launches == expected(),
                f"head width 128 {what}: launched {launches}")
        require(not any(composed.values()),
                f"head width 128 {what}: composition counts {composed}")
    kernels.reset_launches()
    return out


#: phase 2's dropout-add shape: the training step's residual sites at
#: batch 32, length 256, d_model 512
DROPOUT_ROWS = 32 * 256
#: chi-square (1 degree of freedom) bound on the keep count of #16's
#: pattern check: exceeded with probability 0.001 by a fair coin of 0.9
CHI2_BOUND = 10.83


def check_dropout_add(gen):
    """#16 and #17 at [32*256, 512] f32 against their plain twins: the
    keep pattern of x = 1, residual = 0 exactly (and its keep share within
    CHI2_BOUND of 0.9), #16 on random x and residual within TOL_KERNEL,
    #16 without a residual (the embedding sites) and #17 bit for bit.
    Returns (#16's record, #17's record)."""
    from paddle_tpu_torch.kernels import dropout_epilogue as kde
    from paddle_tpu_torch.kernels import hash_rng

    shape = (DROPOUT_ROWS, BASE["d_model"])
    n = DROPOUT_ROWS * BASE["d_model"]
    seed = int(torch.randint(0, 2 ** 32, (1,), generator=gen))
    ones, zeros = torch.ones(shape).cuda(), torch.zeros(shape).cuda()
    pattern = kde.dropout_add_fwd(ones, zeros, DROPOUT, seed)
    want = kde.reference_dropout_add(ones, zeros, DROPOUT, seed)
    torch.cuda.synchronize()
    require(torch.equal(pattern, want),
            "dropout_add_fwd: keep pattern differs from the twin's")
    kept = int((pattern != 0).sum().item())
    p = 1 - DROPOUT
    chi2 = (kept - n * p) ** 2 / (n * p * (1 - p))
    require(chi2 <= CHI2_BOUND, f"dropout_add_fwd: kept {kept} of {n} "
            f"(chi-square {chi2:.2f} over {CHI2_BOUND})")
    require(torch.equal(pattern != 0, hash_rng.keep_mask(
        seed, shape, DROPOUT, device=pattern.device)),
            "dropout_add_fwd: keep pattern is not keep_mask's")

    x, res, g = (randn(gen, *shape) for _ in range(3))
    got = kde.dropout_add_fwd(x, res, DROPOUT, seed)
    want = kde.reference_dropout_add(x, res, DROPOUT, seed)
    plain_drop = kde.dropout_add_fwd(x, None, DROPOUT, seed)
    dx = kde.dropout_add_bwd(g, DROPOUT, seed)
    torch.cuda.synchronize()
    err = max(compare("dropout_add_fwd", got, want, TOL_KERNEL),
              compare("dropout_add_fwd no residual", plain_drop,
                      kde.reference_dropout_add(x, None, DROPOUT, seed),
                      TOL_KERNEL))
    want_dx = kde.reference_dropout_add_bwd(g, DROPOUT, seed)
    require(torch.equal(dx, want_dx), "dropout_add_bwd: differs from twin")
    src = "paddle_tpu_torch/csrc/dropout_add.cu"
    fwd = timed_record(
        "dropout_add_fwd", src, "paddle_tpu/kernels/dropout_epilogue.py:62",
        err, lambda: kde.dropout_add_fwd(x, res, DROPOUT, seed),
        lambda: kde.reference_dropout_add(x, res, DROPOUT, seed), 0,
        3 * F32 * n, None, TRAIN_BATCH, int_ops=HASH_OPS * n)
    fwd.update(keep_share=kept / n, keep_chi2=chi2,
               no_residual_ms=cuda_ms(
                   lambda: kde.dropout_add_fwd(x, None, DROPOUT, seed)),
               no_residual_bound_ms=bound(0, 2 * F32 * n,
                                          HASH_OPS * n)[0])
    bwd = timed_record(
        "dropout_add_bwd", src, "paddle_tpu/kernels/dropout_epilogue.py:76",
        0.0, lambda: kde.dropout_add_bwd(g, DROPOUT, seed),
        lambda: kde.reference_dropout_add_bwd(g, DROPOUT, seed), 0,
        2 * F32 * n, None, TRAIN_BATCH, int_ops=HASH_OPS * n)
    return fwd, bwd


#: ResNet-50 training as the reference's ``bench_resnet50``
#: (``bench.py:425-456``): batch 256 at 224, 1000 classes, NHWC, Momentum
#: 0.1 / 0.9, ``rand`` images and ``randint(0, 1000)`` labels.  f32 with
#: TF32 off: amp (bf16) is the one cut against the bench (ROADMAP A1)
RESNET_DEPTH, RESNET_CLASSES, RESNET_SIZE = 50, 1000, 224
RESNET_BATCH, RESNET_PARITY_BATCH = 256, 16
RESNET_LR, RESNET_MOMENTUM, RESNET_TIMED_STEPS = 0.1, 0.9, 10
#: training FLOPs per image, the reference's count
#: (``bench.py`` RESNET50_TRAIN_FLOPS_PER_IMG)
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.089e9
#: launches of one ResNet-50 step: #19 at the 32 1x1 sites of the 16
#: bottlenecks and the 4 shortcuts, #18 at the stem and the 16 3x3 sites,
#: #20 and #21 at all 53 conv + batch-norm sites
RESNET_LAUNCHES = dict(dot_col_stats=36, channel_stats=17, ssa_fwd=53,
                       ssa_bwd=53)
#: phase 2's conv + BN sites at batch 256: (label, NHWC shape) of #18's
#: input, (label, M, K, N, stride of the rows x[:, ::s, ::s, :]) of #19,
#: and (label, rows, C, residual, relu) of #20 and #21; the first of each
#: is the record in the JSON line
#: ResNet-50's bottleneck stages: (blocks, mid width, output width,
#: stride of the first block's conv1 and shortcut)
RESNET50_STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
                   (3, 512, 2048, 2))


def resnet_dot_sites(batch):
    """(M, K, N) of the 36 sites #19 runs in one ResNet-50 forward at
    ``batch`` images of RESNET_SIZE: each stage's first shortcut and every
    bottleneck's conv1 (both 1x1 at the stage's stride) and conv3 (1x1)."""
    sites, side, ch = [], RESNET_SIZE // 4, 64
    for blocks, mid, out, stride in RESNET50_STAGES:
        for blk in range(blocks):
            side_out = side // (stride if blk == 0 else 1)
            m = batch * side_out ** 2
            if blk == 0:
                sites.append((m, ch, out))
            sites += [(m, ch, mid), (m, mid, out)]
            ch, side = out, side_out
    return sites


def dot_stats_bound_ms(m, k, n):
    """#19's bound at one site, as phase 2's records count it."""
    return bound(2 * m * n * k + 3 * m * n,
                 F32 * (m * k + n * k + m * n + 2 * n))[0]


CBN_STATS_CASES = (("stem 7x7", (256, 112, 112, 64)),
                   ("stage-1 3x3", (256, 56, 56, 64)),
                   ("stage-4 3x3", (256, 7, 7, 512)))
CBN_DOT_CASES = (("stage-1 conv3", 256 * 56 * 56, 64, 256, 1),
                 ("stage-4 conv3", 256 * 7 * 7, 512, 2048, 1),
                 ("stage-2 shortcut (stride 2)", 256 * 28 * 28, 256, 512,
                  2),
                 ("stage-1 conv1", 256 * 56 * 56, 64, 64, 1),
                 ("ragged M 1000 K 72 N 100", 1000, 72, 100, 1))
CBN_SSA_CASES = (("stage-1 conv3 residual relu", 256 * 56 * 56, 256, True,
                  True),
                 ("stage-1 conv1 relu", 256 * 56 * 56, 64, False, True),
                 ("stage-1 shortcut", 256 * 56 * 56, 256, False, False),
                 ("stage-4 conv3 residual relu", 256 * 7 * 7, 2048, True,
                  True))


#: phase 2's per-channel sums of #18, #19 and #21 against the same sums in
#: float64: |got - exact| <= TOL_SUM * sum of the |terms| behind each (a
#: float sum's error scales with its terms, not with its value, which a
#: zero-mean input brings near 0).  An f32 sum of k terms in a fixed order
#: strays about u * sqrt(k) / 3 of its terms' magnitude (u = 2^-24),
#: under 6e-7 for the longest serial runs here (784 partials a lane in
#: #19's stage-1 reduction); dropping one chunk of rows moves a sum by
#: about sqrt(rows in the chunk) terms (zero-mean) or by the chunk's share
#: (positive terms).  On an H100 the sound kernels read at most 4.4e-7,
#: and a dropped last chunk 2.3e-4 or more at every site
#: (chip_conv_bn_faults.py)
TOL_SUM = 2e-6


def compare_sums(name, got, exact, terms, failures):
    """Per-channel f32 sums against their float64 values: (max abs error,
    worst error over TOL_SUM's measure).  A sum out of bounds or not
    finite adds a line to ``failures``."""
    err = (got.double() - exact).abs()
    worst = (err / terms.clamp_min(1e-30)).max().item()
    if not torch.isfinite(got).all().item():
        failures.append(f"{name}: non-finite sums")
    elif worst > TOL_SUM:
        failures.append(f"{name}: error {worst} of the summed magnitudes "
                        f"over {TOL_SUM}")
    return err.max().item(), worst


def _require_same_bits(name, first, again):
    require(all(torch.equal(a, b) for a, b in zip(first, again)
                if a is not None),
            f"{name}: a repeated call gave other bits")


def randn_card(gen, *shape, scale=1.0):
    """Normal f32 numbers drawn on the card (``gen`` a CUDA generator):
    phase 2's conv + BN inputs are too large to draw on the host."""
    return torch.randn(shape, generator=gen, device="cuda") * scale


def check_conv_bn(gen):
    """#18-#21 at ResNet-50's shapes at batch 256 (CBN_*_CASES) against
    their plain twins on the card: outputs within TOL_KERNEL of the f32
    twin, per-channel sums within TOL_SUM of the twin in float64 (every
    sum is read before a sum out of bounds fails the phase); each kernel
    called twice for equal bits.  Also checks that ``conv2d_nhwc``'s
    output at the stem is NHWC-contiguous with no copy.  Returns {(name,
    case): record}; a record's ``sum_err_of_terms`` is its sums' worst
    reading against TOL_SUM."""
    from paddle_tpu_torch.kernels import conv_bn as kc

    src = "paddle_tpu_torch/csrc/conv_bn.cu"
    records, failures = {}, []
    cgen = torch.Generator(device="cuda").manual_seed(
        int(torch.randint(0, 2 ** 31, (1,), generator=gen)))
    x = randn_card(cgen, 256, 224, 224, 3)
    w = randn_card(cgen, 64, 3, 7, 7, scale=0.1)
    y = kc.conv2d_nhwc(x, w, 2, 3)
    require(tuple(y.shape) == (256, 112, 112, 64) and y.is_contiguous(),
            f"conv2d_nhwc: {tuple(y.shape)} contiguous {y.is_contiguous()}"
            " (cuDNN did not keep the channels-last layout)")
    del x, w, y

    for case, shape in CBN_STATS_CASES:
        y = randn_card(cgen, *shape)
        rows, c = y.numel() // shape[-1], shape[-1]
        got = kc.channel_stats_fwd(y)
        _require_same_bits("channel_stats", got, kc.channel_stats_fwd(y))
        y64 = y.double()
        exact = kc.reference_channel_stats(y64)
        sums = [compare_sums(f"channel_stats s1 {case}", got[0], exact[0],
                             y64.abs().sum((0, 1, 2)), failures),
                compare_sums(f"channel_stats s2 {case}", got[1], exact[1],
                             exact[1], failures)]
        del y64, exact
        rec = timed_record(
            "channel_stats", src, "paddle_tpu/kernels/conv_bn.py:146",
            max(e for e, _ in sums), lambda: kc.channel_stats_fwd(y),
            lambda: kc.reference_channel_stats(y), 3 * rows * c,
            F32 * (rows * c + 2 * c),
            lambda: torch.var_mean(y, dim=(0, 1, 2)), RESNET_BATCH)
        rec["sum_err_of_terms"] = max(w for _, w in sums)
        records[("channel_stats", case)] = rec
        del y

    for case, m, k, n, stride in CBN_DOT_CASES:
        if stride > 1:
            side = int(round((m // RESNET_BATCH) ** 0.5))
            full = randn_card(cgen, RESNET_BATCH, side * stride,
                              side * stride, k)
            x2 = full[:, ::stride, ::stride, :].reshape(m, k)
            copy_ms = cuda_ms(lambda: full[:, ::stride, ::stride, :]
                              .reshape(m, k))
            del full
        else:
            x2, copy_ms = randn_card(cgen, m, k), None
        w2 = randn_card(cgen, n, k, scale=k ** -0.5)
        got = kc.dot_col_stats_fwd(x2, w2)
        _require_same_bits("dot_col_stats", got, kc.dot_col_stats_fwd(x2, w2))
        want = kc.reference_dot_col_stats(x2, w2)[0]
        err = compare(f"dot_col_stats y {case}", got[0], want, TOL_KERNEL)
        del want
        # the statistics are of the stored y: the kernel's own, in float64
        y64 = got[0].double()
        exact = kc.reference_channel_stats(y64)
        sums = [compare_sums(f"dot_col_stats s1 {case}", got[1], exact[0],
                             y64.abs().sum(0), failures),
                compare_sums(f"dot_col_stats s2 {case}", got[2], exact[1],
                             exact[1], failures)]
        del got, y64, exact
        rec = timed_record(
            "dot_col_stats", src, "paddle_tpu/kernels/conv_bn.py:225",
            max([err] + [e for e, _ in sums]),
            lambda: kc.dot_col_stats_fwd(x2, w2),
            lambda: kc.reference_dot_col_stats(x2, w2),
            2 * m * n * k + 3 * m * n, F32 * (m * k + n * k + m * n + 2 * n),
            None, RESNET_BATCH)
        rec["matmul_ms"] = cuda_ms(lambda: x2 @ w2.t())
        rec["sum_err_of_terms"] = max(w for _, w in sums)
        if copy_ms is not None:
            rec["strided_copy_ms"] = copy_ms
        records[("dot_col_stats", case)] = rec
        del x2, w2

    for case, rows, c, residual, relu in CBN_SSA_CASES:
        x, g = randn_card(cgen, rows, c), randn_card(cgen, rows, c)
        wv, bv = randn_card(cgen, c) + 1.0, randn_card(cgen, c)
        res = randn_card(cgen, rows, c) if residual else None
        out = kc.ssa_fwd(x, wv, bv, res, relu)
        _require_same_bits("ssa_fwd", [out], [kc.ssa_fwd(x, wv, bv, res,
                                                         relu)])
        err_fwd = compare(f"ssa_fwd {case}", out,
                          kc.reference_ssa_fwd(x, wv, bv, res, relu),
                          TOL_KERNEL)
        got = kc.ssa_bwd(g, x, out, wv, residual, relu)
        _require_same_bits("ssa_bwd", got, kc.ssa_bwd(g, x, out, wv,
                                                      residual, relu))
        want = kc.reference_ssa_bwd(g, x, out, wv, residual, relu)
        err_bwd = max(
            compare(f"ssa_bwd dx {case}", got[0], want[0], TOL_KERNEL),
            compare(f"ssa_bwd dres {case}", got[1], want[1], TOL_KERNEL)
            if residual else 0.0)
        del want
        gm = (torch.where(out > 0, g, 0.0) if relu else g).double()  # g'
        x64 = x.double()
        sums = [compare_sums(f"ssa_bwd sg {case}", got[2], gm.sum(0),
                             gm.abs().sum(0), failures)]
        gm *= x64
        sums.append(compare_sums(f"ssa_bwd sgx {case}", got[3], gm.sum(0),
                                 gm.abs().sum(0), failures))
        del got, gm, x64
        err_bwd = max([err_bwd] + [e for e, _ in sums])
        n = rows * c
        streams = 2 + residual
        records[("ssa_fwd", case)] = timed_record(
            "ssa_fwd", src, "paddle_tpu/kernels/conv_bn.py:409", err_fwd,
            lambda: kc.ssa_fwd(x, wv, bv, res, relu),
            lambda: kc.reference_ssa_fwd(x, wv, bv, res, relu),
            (2 + residual + relu) * n, F32 * (streams * n + 2 * c), None,
            RESNET_BATCH)
        records[("ssa_bwd", case)] = timed_record(
            "ssa_bwd", src, "paddle_tpu/kernels/conv_bn.py:429", err_bwd,
            lambda: kc.ssa_bwd(g, x, out, wv, residual, relu),
            lambda: kc.reference_ssa_bwd(g, x, out, wv, residual, relu),
            (4 + relu) * n, F32 * ((3 + relu + residual) * n + 3 * c), None,
            RESNET_BATCH)
        records[("ssa_bwd", case)]["sum_err_of_terms"] = max(
            w for _, w in sums)
        del x, g, res, out
    require(not failures, "conv + BN sums out of bounds: "
            + "; ".join(failures))
    return records


# -- #22 and #23: the multi-table embedding kernels of DeepFM ---------------

#: the device of phase 2's embedding checks and phase 3 (h) (a rehearsal
#: on the CPU sets it to "cpu")
DEV = "cuda"


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device=DEV) * scale

#: DeepFM at ``bench_deepfm``'s defaults (``paddle_tpu/models/deepfm.py``,
#: ``bench.py``): 26 slots, tables of 1000001 rows, embedding width 10
#: (and the first-order width 1), batch 4096, lazy Adam at 1e-3
DEEPFM_HASH, DEEPFM_BATCH, DEEPFM_EMB, DEEPFM_LR = 1000001, 4096, 10, 1e-3
DEEPFM_SLOTS = 26
#: the two table groups: (name, width)
DEEPFM_GROUPS = (("emb", DEEPFM_EMB), ("w1", 1))
#: #23 against its twin, relative per element: both sum each id's rows in
#: the stable order and round every product and sum on its own, so they
#: should agree to the bit; 1e-6 leaves room for one rounding apart
TOL_APPLY = 1e-6
#: ids of phase 2's apply checks: rows 100-104 repeat row 0's id (a run of
#: 5), rows 200-249 row 1's (50), the last 64 rows hold the sentinel V
APPLY_RUNS, APPLY_SENTINELS = ((0, 100, 5), (1, 200, 50)), 64


def _deepfm_ids(b, hash_dim, seed):
    """[26, b] int32 ids on the card, uniform in [0, hash_dim) as
    ``make_batch`` draws them (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(0, hash_dim, (DEEPFM_SLOTS, b))
                            .astype(np.int32)).to(DEV)


def _apply_ids(b, hash_dim, seed):
    """:func:`_deepfm_ids` with APPLY_RUNS of equal ids planted in every
    slot and the APPLY_SENTINELS last ids set to the sentinel hash_dim."""
    ids = _deepfm_ids(b, hash_dim, seed)
    for src, at, n in APPLY_RUNS:
        ids[:, at:at + n] = ids[:, src:src + 1]
    ids[:, b - APPLY_SENTINELS:] = hash_dim
    return ids


def touched_sectors(ids, d, height):
    """32-byte sectors of the [height, d] f32 tables that the rows at ids
    [S, K] span, counted once per table (a row two ids share is read
    once); ids outside [0, height) touch none."""
    s_n = ids.shape[0]
    ok = (ids >= 0) & (ids < height)
    first = ids.long() * d * F32 // 32
    last = (ids.long() * d * F32 + d * F32 - 1) // 32
    per_table = (height * d * F32) // 32 + 2
    slot = torch.arange(s_n, device=ids.device)[:, None] * per_table
    keys = torch.cat([(first + slot)[ok], (last + slot)[ok]])
    return int(torch.unique(keys).numel())


def unique_rows(ids, height):
    """Distinct (slot, id) pairs of ids [S, K] inside [0, height)."""
    ok = (ids >= 0) & (ids < height)
    slot = torch.arange(ids.shape[0], device=ids.device)[:, None] * height
    return int(torch.unique((ids.long() + slot)[ok]).numel())


def _rel_close(name, got, want, tol):
    """max |got - want| / |want| over the elements; raises above tol
    (elements equal on both sides, zeros included, pass)."""
    err = (got - want).abs()
    worst = (err / want.abs().clamp_min(1e-30)).masked_fill(err == 0, 0.0)
    worst = worst.max().item()
    require(torch.isfinite(got).all().item() and worst <= tol,
            f"{name}: relative error {worst} over {tol}")
    return worst


def _device_only(r, fn):
    """A small kernel's record: ``ms`` becomes the device time of one
    wrapper call (``cuda_ms(hide_host=True)``: the wrapper's stable sort
    and the kernel, for #23), and ``call_ms`` keeps the time with the
    device's wait for the host's enqueue in it, which at these sizes is
    most of a call."""
    r["call_ms"] = r["ms"]
    r["ms"] = cuda_ms(fn, hide_host=True)


#: torch.optim.SparseAdam (#23's library yardstick) against the twin, each
#: tensor's largest difference over its largest magnitude: the same lazy
#: Adam, with the rate on the host and duplicates summed by coalesce()
TOL_LIBRARY_ADAM = 1e-5


def library_sparse_adam(tables, ids, rows, consts):
    """#23's library yardstick: one ``torch.optim.SparseAdam.step()`` over
    copies of the group's tables, with each table's rows at its ids (those
    inside [0, V)) as an uncoalesced sparse gradient.  Its first step from
    zero moments is held against the twin's with lr_t = lr sqrt(1 - b2) /
    (1 - b1): each tensor's difference beyond one rounding of its value
    within TOL_LIBRARY_ADAM of its largest change.  Then one step() is
    timed.  The port never calls it.  Returns (ms, the worst relative
    difference)."""
    from paddle_tpu_torch.kernels import embedding as ke

    b1, b2, eps = consts
    v, d = tables[0].shape
    params = [torch.nn.Parameter(t.clone()) for t in tables]
    for p, i, r in zip(params, ids, rows):
        ok = (i >= 0) & (i < v)
        p.grad = torch.sparse_coo_tensor(i[ok].long()[None], r[ok], (v, d),
                                         check_invariants=True)
    opt = torch.optim.SparseAdam(params, lr=DEEPFM_LR, betas=(b1, b2),
                                 eps=eps)
    opt.step()
    twin = [[t.clone() for t in tables],
            [torch.zeros_like(t) for t in tables],
            [torch.zeros_like(t) for t in tables]]
    lr_t = torch.tensor([DEEPFM_LR * (1 - b2) ** 0.5 / (1 - b1)], device=DEV)
    ke.reference_sparse_adam(*twin, ids, rows, lr_t, *consts)
    worst = (0.0, "")
    with torch.no_grad():
        for k, (p, t0) in enumerate(zip(params, tables)):
            st = opt.state[p]
            for kind, got, want, base in (
                    ("param", p, twin[0][k], t0),
                    ("m1", st["exp_avg"], twin[1][k], 0.0),
                    ("m2", st["exp_avg_sq"], twin[2][k], 0.0)):
                # beyond the one rounding of the sum base + change
                mag = want.abs()
                ulp = torch.nextafter(mag, torch.full_like(mag, math.inf))
                ulp -= mag
                off = ((got - want).abs() - ulp).clamp_min(0).max().item()
                scale = (want - base).abs().max().item()
                worst = max(worst, (off / max(scale, 1e-30), f"{kind} {k}"))
    require(worst[0] <= TOL_LIBRARY_ADAM, f"torch.optim.SparseAdam: table "
            f"{worst[1]} off the twin by {worst[0]} of its largest change")
    del twin
    return cuda_ms(opt.step), worst[0]


def check_embedding():
    """#22 and #23 at DeepFM's shapes against their twins on the card.
    #22 on both groups: equal bits.  #23 in Adam mode on both groups and in
    SGD and scatter-add modes on the first, on duplicate-heavy ids
    (APPLY_RUNS, the sentinel tail): params and moments within TOL_APPLY
    relative, and a repeat on the same inputs equal to the bit.  Each is
    timed after an L2 flush beside its plain twin; #22 also beside 26
    ``F.embedding`` calls (no one library call does a group), #23's Adam
    on the width-10 group beside ``torch.optim.SparseAdam``
    (:func:`library_sparse_adam`).  Returns [(record, label)]."""
    import torch.nn.functional as Fn

    from paddle_tpu_torch.kernels import embedding as ke

    gen = torch.Generator(device=DEV).manual_seed(22)
    out = []
    v, s_n, b = DEEPFM_HASH, DEEPFM_SLOTS, DEEPFM_BATCH
    for group, d in DEEPFM_GROUPS:
        tables = [_randn(gen, v, d, scale=0.01) for _ in range(s_n)]
        ids = _deepfm_ids(b, v, seed=len(out))
        got = ke.multi_table_gather(tables, ids)
        want = ke.reference_multi_table_gather(tables, ids)
        torch.cuda.synchronize()
        require(torch.equal(got, want),
                f"multi_table_gather {group}: not the twin's bits")
        long_ids = [i.long() for i in ids]
        nbytes = (F32 * s_n * b * (1 + d)
                  + 32 * touched_sectors(ids, d, v))
        r = timed_record(
            "multi_table_gather", "paddle_tpu_torch/csrc/embedding.cu",
            "paddle_tpu/kernels/embedding.py:229", 0.0,
            lambda: ke.multi_table_gather(tables, ids),
            lambda: ke.reference_multi_table_gather(tables, ids), 0, nbytes,
            None, b)
        r["embedding_x26_ms"] = cuda_ms(lambda: [
            Fn.embedding(i, t) for i, t in zip(long_ids, tables)],
            hide_host=True)
        _device_only(r, lambda: ke.multi_table_gather(tables, ids))
        r["group"] = f"{group} [{s_n} x {v} x {d}]"
        out.append((r, f" {r['group']} b={b}"))

        # #23, lazy Adam on this group
        ids = _apply_ids(b, v, seed=10 + len(out))
        rows = _randn(gen, s_n, b, d, scale=0.1)
        m1s = [_randn(gen, v, d, scale=0.01) for _ in range(s_n)]
        m2s = [_randn(gen, v, d, scale=0.01).square() for _ in range(s_n)]
        lr_t = torch.tensor([DEEPFM_LR * 0.5], device=DEV)
        consts = (0.9, 0.999, 1e-8)

        def clones():
            return [[t.clone() for t in kind] for kind in (tables, m1s, m2s)]

        runs = []
        for _ in range(2):
            state = clones()
            ke.multi_table_sparse_adam(*state, ids, rows, lr_t, *consts)
            runs.append(state)
        twin = clones()
        ke.reference_sparse_adam(*twin, ids, rows, lr_t, *consts)
        torch.cuda.synchronize()
        err = max(_rel_close(f"multi_table_apply adam {group} {kind}", g, w,
                             TOL_APPLY)
                  for kind, gk, wk in zip(("param", "m1", "m2"), runs[0],
                                          twin)
                  for g, w in zip(gk, wk))
        _require_same_bits(f"multi_table_apply adam {group}",
                           [t for kind in runs[0] for t in kind],
                           [t for kind in runs[1] for t in kind])
        bit_equal = all(torch.equal(g, w) for gk, wk in zip(runs[0], twin)
                        for g, w in zip(gk, wk))
        del runs, twin
        sectors = touched_sectors(ids, d, v)
        nbytes = F32 * s_n * b * (1 + d) + 32 * sectors * 6
        r = timed_record(
            "multi_table_apply", "paddle_tpu_torch/csrc/embedding.cu",
            "paddle_tpu/kernels/embedding.py:343", err,
            lambda: ke.multi_table_sparse_adam(tables, m1s, m2s, ids, rows,
                                               lr_t, *consts),
            lambda: ke.reference_sparse_adam(tables, m1s, m2s, ids, rows,
                                             lr_t, *consts),
            12 * unique_rows(ids, v) * d, nbytes, None, b)
        _device_only(r, lambda: ke.multi_table_sparse_adam(
            tables, m1s, m2s, ids, rows, lr_t, *consts))
        r.update(mode="adam", group=f"{group} [{s_n} x {v} x {d}]",
                 twin_bit_equal=bit_equal)
        if d > 1:
            r["library_ms"], r["library_max_abs_err"] = library_sparse_adam(
                tables, ids, rows, consts)
        out.append((r, f" adam {r['group']} b={b}"))
        if d == 1:
            continue
        for mode, scale in (("sgd", -DEEPFM_LR), ("scatter_add", 1.0)):
            runs = []
            for _ in range(2):
                state = [t.clone() for t in tables]
                ke.multi_table_scatter_add(state, ids, rows, scale)
                runs.append(state)
            twin = [t.clone() for t in tables]
            ke.reference_scatter_add(twin, ids, rows, scale)
            torch.cuda.synchronize()
            err = max(_rel_close(f"multi_table_apply {mode}", g, w,
                                 TOL_APPLY) for g, w in zip(runs[0], twin))
            _require_same_bits(f"multi_table_apply {mode}", runs[0],
                               runs[1])
            bit_equal = all(torch.equal(g, w) for g, w in zip(runs[0], twin))
            del runs, twin
            r = timed_record(
                "multi_table_apply", "paddle_tpu_torch/csrc/embedding.cu",
                "paddle_tpu/kernels/embedding.py:343", err,
                lambda: ke.multi_table_scatter_add(tables, ids, rows, scale),
                lambda: ke.reference_scatter_add(tables, ids, rows, scale),
                2 * unique_rows(ids, v) * d,
                F32 * s_n * b * (1 + d) + 32 * sectors * 2,
                None, b)
            _device_only(r, lambda: ke.multi_table_scatter_add(
                tables, ids, rows, scale))
            r.update(mode=mode, group=f"{group} [{s_n} x {v} x {d}]",
                     twin_bit_equal=bit_equal)
            out.append((r, f" {mode} {r['group']} b={b}"))
        del m1s, m2s
    return out


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
#: resubmissions of a shed request (after its retry_after_s)
SERVE_RETRIES = 3


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
                                          GenerationServingModel,
                                          Overloaded)

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
    errors, shed = [], []

    def one(n):
        # a shed request (Overloaded) waits its retry_after_s and is
        # submitted again, at most SERVE_RETRIES times
        for attempt in range(SERVE_RETRIES + 1):
            try:
                results[n] = batcher.submit(
                    prompts[n], max_tokens=max_tokens[n],
                    timeout=SERVE_WAIT_S)
                return
            except Overloaded as exc:
                shed.append(n)
                if attempt == SERVE_RETRIES:
                    errors.append((n, repr(exc)))
                    return
                time.sleep(exc.retry_after_s)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append((n, repr(exc)))
                return

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
        shed=len(shed), retries=len(shed) - sum(
            1 for _, e in errors if "Overloaded" in e),
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


#: phase 3 (d): per-step loss of the card against the CPU's plain path
#: (f32, TF32 off), relative
TOL_TRAIN_LOSS = 1e-4
#: step 1's gradient, per parameter tensor, ||g - g64|| / ||g64|| against a
#: float64 evaluation of the same step on the CPU: the card must be within
#: 1e-4 of it, or no further than twice the CPU's own f32 gradient is.  At
#: length 256, 12 layers deep, f32 itself is off float64 by more than 1e-4
#: for most tensors (this phase prints both): the softmax backward's
#: dp - delta and the layer norms' backward cancel, so two f32 orders of
#: summation differ by that much and 1e-4 between them is out of reach.
TOL_TRAIN_GRAD = 1e-4
TRAIN_LR, TRAIN_PARITY_STEPS, TRAIN_TIMED_STEPS = 1e-4, 2, 10
#: f32 FLOPs per step per launch site: 6 encoder self, 6 decoder self and
#: 6 cross-attention calls of each bthd kernel
TRAIN_SITES = 3 * BASE["n_layer"]


def transformer_train_flops_per_token(n_layer, d_model, d_ff, n_head, d_key,
                                      seq_len, vocab):
    """Analytic matmul FLOPs per token, fwd, for the enc+dec transformer
    (matmuls only; 2 FLOPs per MAC).  Train = 3x fwd (bwd ~= 2x fwd).
    Copied from the reference's ``bench.py``."""
    dh = n_head * d_key
    attn = 4 * d_model * dh + 2 * seq_len * dh
    ffn = 2 * d_model * d_ff
    enc = n_layer * (attn + ffn)
    dec = n_layer * (2 * attn + ffn)
    fwd_macs = enc + dec + d_model * vocab
    return 3 * 2 * fwd_macs


def training_batch(seed):
    """The reference's make_batch at batch 32, source and target 256, with
    padded tails (pad id 0) of lengths uniform in 128-256 on both sides
    (row 0 unpadded) and label weight 0 on the target pads (numpy)."""
    from paddle_tpu_torch import make_batch

    vocab = BASE["src_vocab_size"]
    rng = np.random.RandomState(seed)
    batch = make_batch(TRAIN_BATCH, TRAIN_LEN, TRAIN_LEN, BASE["n_head"],
                       vocab, vocab, rng)
    for side in ("src_word", "trg_word"):
        lens = rng.randint(TRAIN_LEN // 2, TRAIN_LEN + 1, TRAIN_BATCH)
        lens[0] = TRAIN_LEN
        pad = np.arange(TRAIN_LEN)[None, :] >= lens[:, None]
        batch[side][pad] = 0
        if side == "trg_word":
            batch["lbl_weight"][pad] = 0.0
    return batch


def _to(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _step_grads(model, feed, **kw):
    """{name: gradient} of one forward and backward of ``model``, with no
    update: step 1 repeated, which must give the counted step 1's bits."""
    loss, _ = model(**feed, **kw)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    for p in model.parameters():
        p.grad = None
    return grads


def _require_repeat(grads, repeat, what):
    require(grads.keys() == repeat.keys() and all(
        torch.equal(g, repeat[n]) for n, g in grads.items()),
        f"{what}: step 1's gradients differ from a repeat of the step")


def _grad_rel(got, want):
    return ((got.double() - want.double()).norm()
            / want.double().norm().clamp_min(1e-300)).item()


def run_training(model, cpu_model, cpu64):
    """Phase 3 (d).  The card's model and its f32 CPU copy (same weights)
    take TRAIN_PARITY_STEPS Adam steps on one batch, and a float64 CPU
    copy gives step 1's exact gradient; then the card times
    TRAIN_TIMED_STEPS steps on another batch, repeated.  Returns (the
    run's record, what (e) is held against: the float64 loss and
    gradients, the CPU's f32 gradient error per tensor and its losses);
    every check is fatal."""
    from paddle_tpu_torch import Adam, kernels

    sites = TRAIN_SITES
    batch = training_batch(seed=1)
    opt = Adam(model.parameters(), learning_rate=TRAIN_LR)
    cpu_opt = Adam(cpu_model.parameters(), learning_rate=TRAIN_LR)
    names = {p: n for n, p in model.named_parameters()}
    cpu_names = {p: n for n, p in cpu_model.named_parameters()}
    feed, cpu_feed = _to(batch, "cuda"), _to(batch, "cpu")

    t0 = time.perf_counter()
    loss64, _ = cpu64(**cpu_feed)
    loss64.backward()
    exact = {n: p.grad for n, p in cpu64.named_parameters()
             if p.grad is not None}
    cpu_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, worst_grad, cpu_rel = [], [], {}
    for step in range(TRAIN_PARITY_STEPS):
        loss, _ = model(**feed)
        grads = {names[p]: g for p, g in opt.minimize(loss)}
        torch.cuda.synchronize()
        require(kernels.launches == expected(
            flash_fwd=sites * (step + 1), flash_bwd_dq=sites * (step + 1),
            flash_bwd_dkv=sites * (step + 1)),
            f"training step {step}: launches {kernels.launches}")
        t0 = time.perf_counter()
        cpu_loss, _ = cpu_model(**cpu_feed)
        cpu_grads = {cpu_names[p]: g for p, g in cpu_opt.minimize(cpu_loss)}
        cpu_s += time.perf_counter() - t0
        got, want = loss.item(), cpu_loss.item()
        require(np.isfinite(got) and abs(got - want) <= TOL_TRAIN_LOSS
                * abs(want), f"training step {step}: loss {got} on the "
                f"card, {want} on the CPU")
        losses.append((got, want))
        if step == 0:
            require(np.isfinite(loss64.item()) and abs(got - loss64.item())
                    <= TOL_TRAIN_LOSS * abs(loss64.item()),
                    f"training: loss {got} on the card, {loss64.item()} in "
                    f"float64")
            require(grads.keys() == cpu_grads.keys() == exact.keys(),
                    "training: the card and the CPU trained other params")
            for n, g in grads.items():
                card = _grad_rel(g.cpu(), exact[n])
                cpu_rel[n] = _grad_rel(cpu_grads[n], exact[n])
                require(card <= max(TOL_TRAIN_GRAD, 2 * cpu_rel[n]),
                        f"training step 0: gradient of {n} off float64 by "
                        f"{card} on the card, {cpu_rel[n]} on the CPU in "
                        f"f32")
                worst_grad.append((card, cpu_rel[n], _grad_rel(
                    g.cpu(), cpu_grads[n]), n))
        del grads, cpu_grads
    counts = dict(kernels.launches)
    del cpu_feed

    timed = _timed_training(model, opt, dict(
        flash_fwd=sites, flash_bwd_dq=sites, flash_bwd_dkv=sites))
    for name, c in timed.pop("launches").items():
        counts[name] += c
    worst_grad.sort(reverse=True)
    record = dict(route="training", batch=TRAIN_BATCH, launches=counts,
                  parity_losses=losses, parity_loss_f64=loss64.item(),
                  # (card vs f64, cpu f32 vs f64, card vs cpu f32, name)
                  parity_grad_rel_worst=worst_grad[:4],
                  parity_grad_rel_median=[float(np.median(
                      [w[i] for w in worst_grad])) for i in range(3)],
                  cpu_parity_s=cpu_s, **timed,
                  peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    parity = dict(loss64=loss64.item(), exact=exact, cpu_rel=cpu_rel,
                  cpu_losses=[want for _, want in losses])
    return record, parity


def _timed_training(model, opt, per_step):
    """TRAIN_TIMED_STEPS steps of ``model`` on one repeated batch,
    synchronized step by step (host clock); the launches must read
    ``per_step`` times the steps and the loss must fall.  Returns the
    step times, rates and losses, with the launches under "launches"."""
    from paddle_tpu_torch import kernels

    feed = _to(training_batch(seed=2), "cuda")
    step_ms, timed_losses = [], []
    kernels.reset_launches()
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model(**feed)
        opt.minimize(loss)
        timed_losses.append(loss.item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    n = TRAIN_TIMED_STEPS
    require(kernels.launches == expected(
        **{name: c * n for name, c in per_step.items()}),
        f"timed training: launches {kernels.launches}")
    require(all(np.isfinite(timed_losses))
            and timed_losses[-1] < timed_losses[0],
            f"training: loss did not fall on a repeated batch "
            f"{timed_losses}")
    med_ms = float(np.median(step_ms))
    tokens = TRAIN_BATCH * TRAIN_LEN  # target tokens, as bench.py counts
    flops_tok = transformer_train_flops_per_token(
        BASE["n_layer"], BASE["d_model"], BASE["d_inner_hid"],
        BASE["n_head"], BASE["d_key"], TRAIN_LEN, BASE["trg_vocab_size"])
    tok_s = tokens / (med_ms / 1e3)
    return dict(step_ms_median=med_ms,
                step_ms_range=(min(step_ms), max(step_ms)),
                tokens_per_s=tok_s, flops_per_token=flops_tok,
                f32_peak_share=tok_s * flops_tok / PEAK_F32_FLOPS,
                timed_losses=timed_losses,
                launches=dict(kernels.launches))


def run_training_fused(model, parity):
    """Phase 3 (e): the default route (``fused_qkv_attention=True``) from
    (d)'s initial weights on (d)'s parity batch: 12 launches each of #1,
    #2 and #3 (the self-attention sites) and 6 each of #4, #6 and #7 (the
    cross sites) per step.  Step 1's gradients must repeat their bits when
    the step is run again; its loss and gradients are held against
    (d)'s float64 evaluation under (d)'s criterion, step 2's loss against
    (d)'s CPU f32 step 2; then timed as (d).  Returns the run's record."""
    from paddle_tpu_torch import Adam, kernels

    L = BASE["n_layer"]
    per_step = dict(qkv_attention_fwd=2 * L, qkv_bwd_dq=2 * L,
                    qkv_bwd_dkv=2 * L, flash_fwd=L, flash_bwd_dq=L,
                    flash_bwd_dkv=L)
    opt = Adam(model.parameters(), learning_rate=TRAIN_LR)
    names = {p: n for n, p in model.named_parameters()}
    feed = _to(training_batch(seed=1), "cuda")
    exact = parity["exact"]
    repeat = _step_grads(model, feed)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, worst_grad = [], []
    for step in range(TRAIN_PARITY_STEPS):
        loss, _ = model(**feed)
        grads = {names[p]: g for p, g in opt.minimize(loss)}
        torch.cuda.synchronize()
        require(kernels.launches == expected(
            **{k: c * (step + 1) for k, c in per_step.items()}),
            f"fused training step {step}: launches {kernels.launches}")
        got = loss.item()
        want = parity["loss64"] if step == 0 else parity["cpu_losses"][step]
        require(np.isfinite(got) and abs(got - want) <= TOL_TRAIN_LOSS
                * abs(want), f"fused training step {step}: loss {got} on "
                f"the card, {want} on the CPU")
        losses.append((got, want))
        if step == 0:
            _require_repeat(grads, repeat, "fused training")
            del repeat
            require(grads.keys() == exact.keys(),
                    "fused training: other params trained than in (d)")
            for n, g in grads.items():
                card = _grad_rel(g.cpu(), exact[n])
                f32 = parity["cpu_rel"][n]
                require(card <= max(TOL_TRAIN_GRAD, 2 * f32),
                        f"fused training step 0: gradient of {n} off "
                        f"float64 by {card} on the card, {f32} on the CPU "
                        f"in f32")
                worst_grad.append((card, f32, n))
        del grads
    counts = dict(kernels.launches)
    timed = _timed_training(model, opt, per_step)
    for name, c in timed.pop("launches").items():
        counts[name] += c
    worst_grad.sort(reverse=True)
    return dict(route="training fused", batch=TRAIN_BATCH, launches=counts,
                # (card, reference): step 1 against float64, step 2
                # against the CPU's f32
                parity_losses=losses,
                # (card vs f64, cpu f32 vs f64, name)
                parity_grad_rel_worst=worst_grad[:4],
                parity_grad_rel_median=[float(np.median(
                    [w[i] for w in worst_grad])) for i in range(2)],
                **timed,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


#: phase 3 (f): the generator seed of step 1's dropout seeds
DROPOUT_STEP_SEED = 5
#: (f): step 1's loss on the flag-off route against the fused route's,
#: relative: the same masks, sums in other orders
TOL_ROUTES_LOSS = 1e-5


def run_training_dropout(model, unfused, cpu32, cpu64):
    """Phase 3 (f): ``model`` (the default route at DROPOUT) takes step 1
    under fixed seeds on (d)'s parity batch, repeating its gradients' bits
    when run again, held against the float64 CPU
    copy ``cpu64`` under (d)'s criterion (the f32 CPU copy ``cpu32``, same
    seeds, gives the CPU's own f32 error); ``unfused`` (the flag-off route,
    the same weights) must give step 1's loss within TOL_ROUTES_LOSS; then
    the timed steps, each drawing fresh seeds.  Returns the run's
    record."""
    from paddle_tpu_torch import Adam, kernels

    L = BASE["n_layer"]
    n_sites = len(model.dropout_sites())
    require(n_sites == 8 * L + 2, f"{n_sites} dropout sites")
    # 2 embedding sites and 5L residual ones: #16 forward, #17 backward
    residual_sites = 2 + 5 * L
    per_step = dict(qkv_attention_fwd=2 * L, qkv_bwd_dq=2 * L,
                    qkv_bwd_dkv=2 * L, flash_fwd=L, flash_bwd_dq=L,
                    flash_bwd_dkv=L, dropout_add_fwd=residual_sites,
                    dropout_add_bwd=residual_sites)
    seeds = torch.randint(0, 2 ** 32, (n_sites,), generator=torch.Generator(
        ).manual_seed(DROPOUT_STEP_SEED)).tolist()
    batch = training_batch(seed=1)
    cpu_feed = _to(batch, "cpu")

    t0 = time.perf_counter()
    exact, cpu_grads, cpu_losses = {}, {}, []
    for copy, grads in ((cpu64, exact), (cpu32, cpu_grads)):
        loss, _ = copy(**cpu_feed, dropout_seeds=seeds)
        loss.backward()
        cpu_losses.append(loss.item())
        grads.update((n, p.grad) for n, p in copy.named_parameters()
                     if p.grad is not None)
    cpu_s = time.perf_counter() - t0
    loss64 = cpu_losses[0]

    opt = Adam(model.parameters(), learning_rate=TRAIN_LR)
    names = {p: n for n, p in model.named_parameters()}
    feed = _to(batch, "cuda")
    repeat = _step_grads(model, feed, dropout_seeds=seeds)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    loss, _ = model(**feed, dropout_seeds=seeds)
    grads = {names[p]: g for p, g in opt.minimize(loss)}
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expected(**per_step),
            f"dropout training step 0: launches {counts}")
    got = loss.item()
    require(np.isfinite(got) and abs(got - loss64) <= TOL_TRAIN_LOSS
            * abs(loss64), f"dropout training: loss {got} on the card, "
            f"{loss64} in float64")
    _require_repeat(grads, repeat, "dropout training")
    del repeat
    require(grads.keys() == exact.keys() == cpu_grads.keys(),
            "dropout training: the card and the CPU trained other params")
    worst_grad = []
    for n, g in grads.items():
        card = _grad_rel(g.cpu(), exact[n])
        f32 = _grad_rel(cpu_grads[n], exact[n])
        require(card <= max(TOL_TRAIN_GRAD, 2 * f32),
                f"dropout training step 0: gradient of {n} off float64 by "
                f"{card} on the card, {f32} on the CPU in f32")
        worst_grad.append((card, f32, n))
    del grads, exact, cpu_grads

    with torch.no_grad():
        unfused_loss = unfused(**feed, dropout_seeds=seeds)[0].item()
    require(abs(unfused_loss - got) <= TOL_ROUTES_LOSS * abs(got),
            f"dropout training: flag-off route loss {unfused_loss}, fused "
            f"{got} under the same seeds")

    timed = _timed_training(model, opt, per_step)
    for name, c in timed.pop("launches").items():
        counts[name] += c
    worst_grad.sort(reverse=True)
    return dict(route="training fused dropout", batch=TRAIN_BATCH,
                dropout_rate=DROPOUT, launches=counts,
                # (card, float64, CPU f32) step-1 losses under one seed set
                parity_losses=(got, loss64, cpu_losses[1]),
                flag_off_loss=unfused_loss,
                # (card vs f64, cpu f32 vs f64, name)
                parity_grad_rel_worst=worst_grad[:4],
                parity_grad_rel_median=[float(np.median(
                    [w[i] for w in worst_grad])) for i in range(2)],
                cpu_parity_s=cpu_s, **timed,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


#: (g) the kernel route against the card's plain route (the twins of
#: #18-#21 on the card) at batch 256, from the same weights on the same
#: batch.  The loss and the running statistics come from the forward and
#: agree closely (relative; f32 against float64 on the CPU at 224, batch
#: 4: 1.3e-6).  The gradients do not: at initialization ResNet-50's f32
#: gradient sits 2-4% per tensor off float64 whatever the order of
#: summation (on the CPU at 224, batch 4: medians 2.6% and 2.9%, worst
#: 4.1%, by two convolution algorithms), so two f32 routes differ by as
#: much, and TOL_RESNET_ROUTES_GRAD is twice that spread
TOL_RESNET_ROUTES_LOSS, TOL_RESNET_ROUTES_STATS = 1e-4, 1e-4
TOL_RESNET_ROUTES_GRAD = 0.1


def resnet_batch(b, seed):
    """``bench_resnet50``'s feed: ``rand`` NCHW images in [0, 1) and
    ``randint(0, 1000)`` int64 labels [b, 1] (numpy, seeded)."""
    rng = np.random.RandomState(seed)
    image = rng.rand(b, 3, RESNET_SIZE, RESNET_SIZE).astype(np.float32)
    label = rng.randint(0, RESNET_CLASSES, (b, 1)).astype(np.int64)
    return {"image": image, "label": label}


@contextlib.contextmanager
def plain_conv_bn():
    """The card's plain route: the wrappers of #18-#21 swapped for their
    plain twins (on CUDA tensors) while the block runs."""
    from paddle_tpu_torch.kernels import conv_bn as kc

    swaps = {"channel_stats_fwd": kc.reference_channel_stats,
             "dot_col_stats_fwd": kc.reference_dot_col_stats,
             "ssa_fwd": kc.reference_ssa_fwd,
             "ssa_bwd": kc.reference_ssa_bwd}
    saved = {name: getattr(kc, name) for name in swaps}
    for name, twin in swaps.items():
        setattr(kc, name, twin)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kc, name, fn)


def _resnet_step(model, feed, opt=None):
    """One forward and backward of ``model`` on ``feed`` and, with
    ``opt``, its Momentum update: (loss, acc, {name: gradient})."""
    names = {p: n for n, p in model.named_parameters()}
    loss, acc, _ = model(**feed)
    if opt is not None:
        grads = {names[p]: g for p, g in opt.minimize(loss)}
    else:
        loss.backward()
        grads = {names[p]: p.grad for p in model.parameters()}
        for p in model.parameters():
            p.grad = None
    return loss.item(), acc.item(), grads


def _resnet_timed(model, opt, feed):
    """RESNET_TIMED_STEPS Momentum steps of ``model`` on ``feed`` by the host
    clock, each ended by its loss's ``.item()``: (step ms, losses).  The
    launches of #18-#21 must be RESNET_LAUNCHES a step (they stay counted
    for the caller)."""
    from paddle_tpu_torch import kernels

    step_ms, losses = [], []
    kernels.reset_launches()
    for _ in range(RESNET_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _, _ = model(**feed)
        opt.minimize(loss)
        losses.append(loss.item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    require(kernels.launches == expected(**{
        n: c * RESNET_TIMED_STEPS for n, c in RESNET_LAUNCHES.items()}),
        f"resnet timed steps: launches {kernels.launches}")
    return step_ms, losses


def _state(model):
    return {n: t.detach().clone() for n, t in model.state_dict().items()}


def run_resnet(model):
    """Phase 3 (g): ResNet-50 training, NHWC, f32, Momentum(0.1, 0.9),
    from ``model``'s weights (kept as the initial state of every leg).
    Step 1 at RESNET_PARITY_BATCH against float64 and f32 CPU copies under
    (d)'s criterion (gradients, running statistics, updated parameters);
    step 1 at RESNET_BATCH, repeated for equal bits and held against the
    card's plain route; then RESNET_TIMED_STEPS timed steps on one
    repeated batch.  Every counted step launches exactly RESNET_LAUNCHES.
    The parity and repeated steps run with cudnn.deterministic; the timed
    ones with PyTorch's defaults.  Returns the run's record."""
    from paddle_tpu_torch import Momentum, ResNet, kernels

    init = _state(model)
    cpu_init = {n: t.cpu() for n, t in init.items()}
    feed16 = resnet_batch(RESNET_PARITY_BATCH, seed=1)
    t0 = time.perf_counter()
    cpu = {}
    for dtype in (torch.float64, torch.float32):
        copy = ResNet(RESNET_DEPTH, RESNET_CLASSES, device="cpu").to(dtype)
        copy.load_state_dict(cpu_init)
        feed = {"image": torch.from_numpy(feed16["image"]).to(dtype),
                "label": torch.from_numpy(feed16["label"])}
        loss, _, grads = _resnet_step(copy, feed, Momentum(
            copy.parameters(), RESNET_LR, RESNET_MOMENTUM))
        cpu[dtype] = (loss, grads, _state(copy))
        del copy
    cpu_s = time.perf_counter() - t0
    loss64, exact, exact_state = cpu[torch.float64]
    _, cpu_grads, cpu_state = cpu[torch.float32]

    torch.backends.cudnn.deterministic = True
    counts = expected()
    kernels.reset_launches()
    loss16, _, grads = _resnet_step(model, _to(feed16, "cuda"), Momentum(
        model.parameters(), RESNET_LR, RESNET_MOMENTUM))
    torch.cuda.synchronize()
    require(kernels.launches == expected(**RESNET_LAUNCHES),
            f"resnet step 1 (batch {RESNET_PARITY_BATCH}): launches "
            f"{kernels.launches}")
    counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    require(np.isfinite(loss16) and abs(loss16 - loss64) <= TOL_TRAIN_LOSS
            * abs(loss64), f"resnet: loss {loss16} on the card, {loss64} in "
            f"float64")

    def held(tag, grads, card_state):
        worst = []
        for kind, got, want, f32 in (("grad", grads, exact, cpu_grads),
                                     ("state", card_state, exact_state,
                                      cpu_state)):
            require(got.keys() == want.keys() == f32.keys(),
                    f"{tag}: the card and the CPU hold other {kind} tensors")
            for n in got:
                card = _grad_rel(got[n].cpu(), want[n])
                cpu32 = _grad_rel(f32[n], want[n])
                require(card <= max(TOL_TRAIN_GRAD, 2 * cpu32),
                        f"{tag} step 1: {kind} {n} off float64 by {card} on "
                        f"the card, {cpu32} on the CPU in f32")
                worst.append((card, cpu32, kind, n))
        return worst

    worst = held("resnet", grads, _state(model))
    # C9: the NCHW route (the reference's unfused composition, no kernel)
    # from the same state on the same batch, under the same criterion
    nchw = ResNet(RESNET_DEPTH, RESNET_CLASSES, data_format="NCHW")
    nchw.load_state_dict(init)
    kernels.reset_launches()
    loss_n, _, grads_n = _resnet_step(nchw, _to(feed16, "cuda"), Momentum(
        nchw.parameters(), RESNET_LR, RESNET_MOMENTUM))
    torch.cuda.synchronize()
    require(kernels.launches == expected(), "resnet NCHW launched kernels: "
            f"{kernels.launches}")
    require(np.isfinite(loss_n) and abs(loss_n - loss64) <= TOL_TRAIN_LOSS
            * abs(loss64), f"resnet NCHW: loss {loss_n} on the card, "
            f"{loss64} in float64")
    worst_nchw = sorted(held("resnet NCHW", grads_n, _state(nchw)),
                        reverse=True)
    del grads, exact, cpu_grads, exact_state, cpu_state, cpu, nchw, grads_n

    feed = _to(resnet_batch(RESNET_BATCH, seed=2), "cuda")
    model.load_state_dict(init)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    loss_k, _, grads_k = _resnet_step(model, feed)
    torch.cuda.synchronize()
    require(kernels.launches == expected(**RESNET_LAUNCHES),
            f"resnet step 1 (batch {RESNET_BATCH}): launches "
            f"{kernels.launches}")
    counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats_k = {n: b.clone() for n, b in model.named_buffers()}
    model.load_state_dict(init)
    loss_r, _, grads_r = _resnet_step(model, feed)
    require(loss_r == loss_k, f"resnet: a repeated step 1 gave loss "
            f"{loss_r}, first {loss_k}")
    _require_repeat(grads_k, grads_r, "resnet (batch 256)")
    del grads_r
    model.load_state_dict(init)
    kernels.reset_launches()
    with plain_conv_bn():
        loss_p, _, grads_p = _resnet_step(model, feed)
    torch.cuda.synchronize()
    require(kernels.launches == expected(), "resnet plain route launched "
            f"kernels: {kernels.launches}")
    require(abs(loss_k - loss_p) <= TOL_RESNET_ROUTES_LOSS * abs(loss_p),
            f"resnet: loss {loss_k} on the kernels, {loss_p} on the plain "
            f"route")
    route_rel = sorted((_grad_rel(grads_k[n], grads_p[n]), n)
                       for n in grads_p)
    require(route_rel[-1][0] <= TOL_RESNET_ROUTES_GRAD,
            f"resnet: gradient of {route_rel[-1][1]} differs between the "
            f"routes by {route_rel[-1][0]}")
    stats_rel = max((_grad_rel(stats_k[n], b), n)
                    for n, b in model.named_buffers())
    require(stats_rel[0] <= TOL_RESNET_ROUTES_STATS,
            f"resnet: running statistic {stats_rel[1]} differs between the "
            f"routes by {stats_rel[0]}")
    del grads_k, grads_p, stats_k

    torch.backends.cudnn.deterministic = False
    model.load_state_dict(init)
    opt = Momentum(model.parameters(), RESNET_LR, RESNET_MOMENTUM)
    step_ms, losses = _resnet_timed(model, opt, feed)
    counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    # the first update must lower the loss on the batch it was taken on;
    # later steps may overshoot: Momentum 0.9 grows the effective step to
    # 10x lr on one repeated batch
    require(all(np.isfinite(losses)) and losses[1] < losses[0],
            f"resnet: the loss did not fall on a repeated batch {losses}")
    med = float(np.median(step_ms))
    ips = RESNET_BATCH / (med / 1e3)
    worst.sort(reverse=True)
    return dict(route="resnet50 training", batch=RESNET_BATCH,
                image=RESNET_SIZE, launches=counts,
                parity_batch=RESNET_PARITY_BATCH,
                parity_losses=(loss16, loss64),
                # (card vs f64, cpu f32 vs f64, kind, name)
                parity_rel_worst=worst[:4],
                parity_grad_rel_median=[float(np.median(
                    [w[i] for w in worst if w[2] == "grad"]))
                    for i in range(2)],
                cpu_parity_s=cpu_s,
                nchw_loss=loss_n, nchw_rel_worst=worst_nchw[:3],
                routes_loss=(loss_k, loss_p),
                routes_grad_rel_worst=route_rel[-3:],
                routes_grad_rel_median=float(np.median(
                    [r for r, _ in route_rel])),
                routes_stats_rel_worst=stats_rel,
                step_ms_median=med, step_ms_range=(min(step_ms),
                                                   max(step_ms)),
                images_per_s=ips,
                f32_peak_share=ips * RESNET_FLOPS_PER_IMAGE / PEAK_F32_FLOPS,
                timed_losses=losses, peak_memory_gb=peak_gb)


# -- (h): DeepFM -------------------------------------------------------------

#: 8 batches of seeds 0-7 cycled, as ``bench_deepfm`` scans them
DEEPFM_BATCHES, DEEPFM_TIMED_STEPS, DEEPFM_PARITY_STEPS = 8, 10, 3
#: per step: one #22 launch and one #23 launch per table group
DEEPFM_LAUNCHES = dict(multi_table_gather=2, multi_table_apply=2)
#: bench.py's analytic sparse traffic per example (run_deepfm): 26 slots x
#: (10 + 1) f32 x (the gather, the gradient's read and write, both
#: moments' read and write)
DEEPFM_SPARSE_BYTES = DEEPFM_SLOTS * (DEEPFM_EMB + 1) * F32 * 7
#: kernel route against the per-table composition on the card: the
#: reference's own fused-against-per-slot tolerances
#: (tests/test_fused_embedding.py) per element, and TOL_DEEPFM_RTOL of each
#: tensor's largest magnitude: a table's moments (m1 about 1e-6, m2 about
#: 1e-13 at batch 4096) lie far inside the atol
TOL_DEEPFM_RTOL, TOL_DEEPFM_ATOL = 2e-4, 2e-5
#: the float64 check runs at the bench's smoke size
DEEPFM_SMOKE_HASH = 10001


def deepfm_batches(hash_dim, n=DEEPFM_BATCHES):
    """``make_batch(4096, hash_dim, RandomState(s))`` for s < n, as
    (dense, ids [26, b] int32, click) on the card."""
    from paddle_tpu_torch.models.deepfm import batch_tensors, make_batch

    return [batch_tensors(make_batch(DEEPFM_BATCH, hash_dim,
                                     np.random.RandomState(s)), DEV)
            for s in range(n)]


def _deepfm_adam(model):
    from paddle_tpu_torch import Adam

    return Adam(model.parameters(), learning_rate=DEEPFM_LR, lazy_mode=True)


@contextlib.contextmanager
def plain_embedding():
    """The card's plain route of the table updates: the #23 wrappers that
    the optimizers call swapped for their plain twins (on CUDA tensors)
    while the block runs (SGD's goes through the scatter-add one)."""
    from paddle_tpu_torch.kernels import embedding as ke

    swaps = {"multi_table_scatter_add": ke.reference_scatter_add,
             "multi_table_sparse_adam": ke.reference_sparse_adam}
    saved = {name: getattr(ke, name) for name in swaps}
    for name, twin in swaps.items():
        setattr(ke, name, twin)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(ke, name, fn)


def _deepfm_state(model, opt):
    """Every parameter and moment of a DeepFM and its Adam, by name."""
    out = {}
    for n, p in model.named_parameters():
        out[n] = p
        st = opt.state[p]
        out[n + "_moment1"], out[n + "_moment2"] = st["moment1"], st["moment2"]
    return out


def _deepfm_steps(model, opt, batches, steps, per_step=None):
    """``steps`` steps cycling ``batches``: the losses; each step's launches
    must equal ``per_step`` when given."""
    from paddle_tpu_torch import kernels

    losses = []
    for i in range(steps):
        kernels.reset_launches()
        loss, _, _ = model(*batches[i % len(batches)])
        opt.minimize(loss)
        losses.append(loss.item())
        if per_step is not None:
            require(kernels.launches == per_step,
                    f"deepfm step {i + 1}: launches {kernels.launches}")
    return losses


def deepfm_float64_check():
    """One step at hash_dim DEEPFM_SMOKE_HASH on the card against float64
    and f32 copies on the CPU from the same weights and batch: the loss
    within TOL_TRAIN_LOSS of float64's, and each parameter's and moment's
    update within TOL_TRAIN_GRAD of float64's or no further than twice the
    CPU's f32 update is ((d)'s criterion).  Returns (the losses, the
    worst three (card, cpu f32, name))."""
    from paddle_tpu_torch import DeepFM
    from paddle_tpu_torch.models.deepfm import batch_tensors, make_batch

    card = DeepFM(hash_dim=DEEPFM_SMOKE_HASH, device=DEV).init_params(5)
    feed = make_batch(DEEPFM_BATCH, DEEPFM_SMOKE_HASH,
                      np.random.RandomState(9))
    start = {k: v.cpu().clone() for k, v in card.state_dict().items()}
    after, losses = {}, {}
    for tag, model, dev in (
            ("card", card, DEV),
            ("f32", DeepFM(hash_dim=DEEPFM_SMOKE_HASH, device="cpu"), "cpu"),
            ("f64", DeepFM(hash_dim=DEEPFM_SMOKE_HASH, device="cpu"),
             "cpu")):
        if tag != "card":
            model.load_state_dict(start)
        if tag == "f64":
            model.double()
        dense, ids, click = batch_tensors(feed, dev)
        before = {n: p.detach().double().cpu().clone()
                  for n, p in model.named_parameters()}
        opt = _deepfm_adam(model)
        loss, _, _ = model(dense.to(next(model.parameters()).dtype), ids,
                           click)
        opt.minimize(loss)
        losses[tag] = loss.item()
        # what the step moved: each parameter's update, each moment (zero
        # before the step)
        after[tag] = {n: t.detach().double().cpu() - before.get(n, 0.0)
                      for n, t in _deepfm_state(model, opt).items()}
    require(abs(losses["card"] - losses["f64"])
            <= TOL_TRAIN_LOSS * abs(losses["f64"]),
            f"deepfm float64 check: loss {losses}")
    worst = []
    for n, want in after["f64"].items():
        card_rel = _grad_rel(after["card"][n], want)
        cpu_rel = _grad_rel(after["f32"][n], want)
        require(card_rel <= max(TOL_TRAIN_GRAD, 2 * cpu_rel),
                f"deepfm float64 check: {n} off float64 by {card_rel} on the "
                f"card, {cpu_rel} on the CPU in f32")
        worst.append((card_rel, cpu_rel, n))
    worst.sort(reverse=True)
    return losses, worst[:3]


def run_deepfm(model):
    """Phase 3 (h): DeepFM training as ``bench_deepfm`` runs it (batch
    4096, hash_dim 1000001, lazy Adam 1e-3, FLAGS_fused_embedding on) from
    ``model``'s weights.  Step 1 twice from the same state: equal bits.
    DEEPFM_PARITY_STEPS steps on the kernel route against the per-table
    composition on the card (``fused_embedding=False`` for the model, the
    #23 wrappers swapped for their twins by :func:`plain_embedding`: no
    kernel launches): losses and every table, weight and moment within
    TOL_DEEPFM_* per element and within TOL_DEEPFM_RTOL of the tensor's
    largest magnitude.  DEEPFM_TIMED_STEPS timed steps
    after one warm-up, cycling the 8 batches: exactly DEEPFM_LAUNCHES a
    step, and the loss must fall below its first value.  One step at the
    smoke size against float64 (:func:`deepfm_float64_check`).  Returns
    the run's record."""
    from paddle_tpu_torch import DeepFM, kernels

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    batches = deepfm_batches(DEEPFM_HASH)
    init = _state(model)
    per_step = expected(**DEEPFM_LAUNCHES)
    counts = expected()

    snaps = []
    for _ in range(2):
        model.load_state_dict(init)
        opt = _deepfm_adam(model)
        losses_k = _deepfm_steps(model, opt, batches, 1, per_step)
        snaps.append({n: t.clone()
                      for n, t in _deepfm_state(model, opt).items()})
        counts = {n: c + kernels.launches[n] for n, c in counts.items()}
    require(snaps[0].keys() == snaps[1].keys() and all(
        torch.equal(t, snaps[1][n]) for n, t in snaps[0].items()),
        "deepfm: a repeated step 1 gave other bits")
    del snaps
    losses_k += _deepfm_steps(model, opt, batches[1:],
                              DEEPFM_PARITY_STEPS - 1, per_step)
    counts = {n: c + (DEEPFM_PARITY_STEPS - 1) * per_step[n]
              for n, c in counts.items()}
    composed = DeepFM(hash_dim=DEEPFM_HASH, fused_embedding=False,
                      device=DEV)
    composed.load_state_dict(init)
    opt_c = _deepfm_adam(composed)
    with plain_embedding():
        losses_c = _deepfm_steps(composed, opt_c, batches,
                                 DEEPFM_PARITY_STEPS, expected())
    require(np.allclose(losses_k, losses_c, rtol=TOL_DEEPFM_RTOL,
                        atol=TOL_DEEPFM_ATOL),
            f"deepfm: losses {losses_k} on the kernels, {losses_c} on the "
            f"per-table composition")
    mine = _deepfm_state(model, opt)
    worst, worst_scaled = (-1.0, ""), (0.0, "")
    with torch.no_grad():
        for n, want in _deepfm_state(composed, opt_c).items():
            diff = (mine[n] - want).abs()
            err = diff - TOL_DEEPFM_RTOL * want.abs()
            worst = max(worst, (err.max().item(), n))
            scaled = diff.max().item() / max(want.abs().max().item(), 1e-30)
            worst_scaled = max(worst_scaled, (scaled, n))
    require(worst[0] <= TOL_DEEPFM_ATOL, f"deepfm: {worst[1]} differs "
            f"between the kernel route and the composition by {worst[0]} "
            f"over rtol {TOL_DEEPFM_RTOL}")
    require(worst_scaled[0] <= TOL_DEEPFM_RTOL, f"deepfm: {worst_scaled[1]} "
            f"differs between the kernel route and the composition by "
            f"{worst_scaled[0]} of its largest magnitude")
    del composed, opt_c, mine
    parity_s = time.perf_counter() - t0

    model.load_state_dict(init)
    opt = _deepfm_adam(model)
    losses = _deepfm_steps(model, opt, batches, 1, per_step)   # warm-up
    step_ms = []
    kernels.reset_launches()
    for i in range(1, DEEPFM_TIMED_STEPS + 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, auc, _ = model(*batches[i % DEEPFM_BATCHES])
        opt.minimize(loss)
        losses.append(loss.item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t1) * 1e3)
    require(kernels.launches == expected(**{
        n: c * DEEPFM_TIMED_STEPS for n, c in DEEPFM_LAUNCHES.items()}),
        f"deepfm timed steps: launches {kernels.launches}")
    counts = {n: c + kernels.launches[n] + per_step[n]
              for n, c in counts.items()}
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"deepfm: the loss did not fall over the run {losses}")
    med = float(np.median(step_ms))
    eps = DEEPFM_BATCH / (med / 1e3)
    f64_losses, f64_worst = deepfm_float64_check()
    return dict(route="deepfm training", batch=DEEPFM_BATCH,
                hash_dim=DEEPFM_HASH, launches=counts,
                step_ms_median=med, step_ms_range=(min(step_ms),
                                                   max(step_ms)),
                examples_per_s=eps,
                sparse_bytes_share=eps * DEEPFM_SPARSE_BYTES
                / PEAK_BYTES_PER_S,
                timed_losses=losses, auc=auc.item(),
                routes_losses=(losses_k, losses_c),
                routes_worst_over_rtol=worst,
                routes_worst_of_largest=worst_scaled, parity_s=parity_s,
                float64_losses=f64_losses, float64_rel_worst=f64_worst,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def run_demo_head16():
    """Phase 3, C2: the reference demo's widths (head width 16) served on
    the card through the batcher, driven synchronously: no attention or
    decode kernel launches, the composition counter counts the routed
    calls, and every request gets the CPU plain path's tokens."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.serving import (ContinuousBatcher,
                                          build_demo_generation_model)
    from paddle_tpu_torch.serving.generation import _GenRequest

    prompts = [[5, 9, 3], [5, 9, 3], [7, 2], [11, 4, 8, 1, 6], [3] * 8]
    tokens = {}
    for side, dev in (("card", DEV), ("cpu", "cpu")):
        served = build_demo_generation_model(device=dev)
        if side == "cpu":
            served.session.model.load_state_dict(
                {k: v.cpu() for k, v in card_state.items()})
        else:
            card_state = served.session.model.state_dict()
        served.warmup()
        batcher = ContinuousBatcher(served)
        reqs = [_GenRequest(list(p), 12) for p in prompts]
        kernels.reset_launches()
        for r in reqs:
            batcher._pending_join.append(r)
        for _ in range(300):
            if all(r.event.is_set() for r in reqs):
                break
            batcher._admit()
            batcher._step()
        require(all(r.event.is_set() and r.error is None for r in reqs),
                f"demo ({side}): requests did not finish")
        tokens[side] = [list(r.tokens) for r in reqs]
        if side == "card":
            torch.cuda.synchronize()
            launches, composed = dict(kernels.launches), dict(
                kernels.composed)
    require(launches == expected(), f"demo at head width 16 launched "
            f"kernels: {launches}")
    require(composed["qkv_attention_fwd"] > 0 and composed["megastep"] > 0
            and composed["ffn"] > 0,
            f"demo at head width 16: composition counts {composed}")
    require(tokens["card"] == tokens["cpu"],
            f"demo at head width 16: tokens {tokens['card']} on the card, "
            f"{tokens['cpu']} on the CPU")
    return dict(route="demo head width 16", launches=launches,
                composed={k: v for k, v in composed.items() if v},
                requests=len(prompts),
                tokens=sum(len(t) for t in tokens["card"]))


def bert_train_flops_per_token(n_layer, d_model, d_ff, seq_len, vocab):
    """Analytic matmul FLOPs per token, encoder-only + MLM head (2 FLOPs
    per MAC, train = 3x fwd).  Copied from the reference's ``bench.py``."""
    attn = 4 * d_model * d_model + 2 * seq_len * d_model
    fwd_macs = n_layer * (attn + 2 * d_model * d_ff) + d_model * vocab
    return 3 * 2 * fwd_macs


def bert_batch(b, seed):
    """The reference's make_batch at batch b and BERT's widths, with padded
    tails (input mask and label weights 0) of lengths uniform in 64-128
    (row 0 unpadded), so the attention bias matters (numpy)."""
    from paddle_tpu_torch import make_bert_batch

    t = BERT["seq_len"]
    rng = np.random.RandomState(seed)
    batch = make_bert_batch(b, t, BERT["vocab_size"], rng)
    lens = rng.randint(t // 2, t + 1, b)
    lens[0] = t
    pad = np.arange(t)[None, :] >= lens[:, None]
    batch["input_mask"][pad] = 0.0
    batch["mask_weights"][pad] = 0.0
    return batch


def _bert_models():
    """BERT-base at DROPOUT from ``init_params(0)`` on the card: the
    default build after ``attention_fuse`` (the bhtd kernels), the same
    weights on the ``use_flash=True`` route (#1-#3), and on the unfused
    composition (no pass)."""
    from paddle_tpu_torch import BertPretrain, attention_fuse

    fused = BertPretrain(**BERT, dropout_rate=DROPOUT,
                         device=DEV).init_params(0)
    require(attention_fuse(fused) == BERT["n_layer"],
            "attention_fuse did not switch every BERT layer")
    flash = BertPretrain(**BERT, dropout_rate=DROPOUT, use_flash=True,
                         device=DEV)
    composed = BertPretrain(**BERT, dropout_rate=DROPOUT, device=DEV)
    for m in (flash, composed):
        m.load_state_dict(fused.state_dict())
    return fused, flash, composed


def _bert_timed(model, opt, per_step, seed):
    """BERT_TIMED_STEPS steps of ``model`` on one repeated batch, each with
    fresh dropout seeds, synchronized step by step (host clock); the
    launches must read ``per_step`` times the steps and the loss must
    fall.  Returns the step times, rates, losses and peak memory."""
    from paddle_tpu_torch import kernels

    feed = _to(bert_batch(BERT_BATCH, seed=2), DEV)
    gen = torch.Generator().manual_seed(seed)
    step_ms, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for _ in range(BERT_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model(**feed, generator=gen)
        opt.minimize(loss)
        losses.append(loss.item())  # syncs: the step is done
        step_ms.append((time.perf_counter() - t0) * 1e3)
    n = BERT_TIMED_STEPS
    require(kernels.launches == expected(
        **{name: c * n for name, c in per_step.items()}),
        f"timed BERT steps: launches {kernels.launches}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"BERT: loss did not fall on a repeated batch {losses}")
    med_ms = float(np.median(step_ms))
    tok_s = BERT_BATCH * BERT["seq_len"] / (med_ms / 1e3)
    flops_tok = bert_train_flops_per_token(
        BERT["n_layer"], BERT["d_model"], BERT["d_ff"], BERT["seq_len"],
        BERT["vocab_size"])
    return dict(step_ms_median=med_ms, step_ms_range=(min(step_ms),
                                                      max(step_ms)),
                tokens_per_s=tok_s, flops_per_token=flops_tok,
                f32_peak_share=tok_s * flops_tok / PEAK_F32_FLOPS,
                timed_losses=losses, launches=dict(kernels.launches),
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)


def run_bert(fused, flash, composed):
    """Phase 3 (i): BERT-base pretraining at DROPOUT.  ``fused`` (the
    default build after ``attention_fuse``) takes step 1 under fixed
    per-site seeds at BERT_BATCH, twice for equal gradient bits, with 12
    launches each of #5, #8 and #9 and 25 each of #16 and #17 (24
    residual sites and the embedding's) and no other; at
    BERT_PARITY_BATCH the same step is held against float64 and f32 CPU
    copies under the same seeds by (d)'s criterion.  ``flash``
    (``use_flash=True``: 12 each of #1-#3) must give step 1's loss within
    TOL_ROUTES_LOSS under the same seeds (the same masks), and
    ``composed`` (no pass) the fused route's rate-0 loss.  Then both
    kernel routes are timed.  Returns the (fused, flash) records."""
    from paddle_tpu_torch import Adam, BertPretrain, attention_fuse, kernels

    L = BERT["n_layer"]
    drops = dict(dropout_add_fwd=2 * L + 1, dropout_add_bwd=2 * L + 1)
    per_fused = dict(flash_fwd_bhtd=L, flash_bwd_dq_bhtd=L,
                     flash_bwd_dkv_bhtd=L, **drops)
    per_flash = dict(qkv_attention_fwd=L, qkv_bwd_dq=L, qkv_bwd_dkv=L,
                     **drops)
    sites = fused.dropout_sites()
    require(len(sites) == 3 * L + 1, f"{len(sites)} BERT dropout sites")
    # one seed per site name, whichever order a route lists its sites in
    by_site = dict(zip(sites, torch.randint(
        0, 2 ** 32, (len(sites),), generator=torch.Generator().manual_seed(
            DROPOUT_STEP_SEED)).tolist()))

    def seeds(model):
        return [by_site[name] for name in model.dropout_sites()]

    # step 1 at the parity batch against float64 and f32 CPU copies
    small = bert_batch(BERT_PARITY_BATCH, seed=3)
    t0 = time.perf_counter()
    exact, cpu_grads, cpu_losses = {}, {}, []
    for dtype, grads in ((torch.float64, exact), (torch.float32, cpu_grads)):
        copy = BertPretrain(**BERT, dropout_rate=DROPOUT,
                            device="cpu").to(dtype)
        attention_fuse(copy)
        copy.load_state_dict({k: v.cpu() for k, v in
                              fused.state_dict().items()})
        loss, _ = copy(**_to(small, "cpu"), dropout_seeds=seeds(copy))
        loss.backward()
        cpu_losses.append(loss.item())
        grads.update((n, p.grad) for n, p in copy.named_parameters())
        del copy
    cpu_s = time.perf_counter() - t0
    small_loss, _ = fused(**_to(small, DEV), dropout_seeds=seeds(fused))
    small_loss.backward()
    card_small = {n: p.grad for n, p in fused.named_parameters()}
    fused.zero_grad(set_to_none=True)
    small_loss = small_loss.item()
    require(abs(small_loss - cpu_losses[0]) <= TOL_TRAIN_LOSS
            * abs(cpu_losses[0]), f"BERT batch {BERT_PARITY_BATCH}: loss "
            f"{small_loss} on the card, {cpu_losses[0]} in float64")
    worst_grad = []
    for n, g in card_small.items():
        card = _grad_rel(g.cpu(), exact[n])
        f32 = _grad_rel(cpu_grads[n], exact[n])
        require(card <= max(TOL_TRAIN_GRAD, 2 * f32),
                f"BERT step 1: gradient of {n} off float64 by {card} on "
                f"the card, {f32} on the CPU in f32")
        worst_grad.append((card, f32, n))
    worst_grad.sort(reverse=True)
    del card_small, exact, cpu_grads

    # step 1 at BERT_BATCH: repeated for equal bits, then counted
    feed = _to(bert_batch(BERT_BATCH, seed=1), DEV)
    repeat = _step_grads(fused, feed, dropout_seeds=seeds(fused))
    opt = Adam(fused.parameters(), learning_rate=BERT_LR)
    names = {p: n for n, p in fused.named_parameters()}
    kernels.reset_launches()
    loss, _ = fused(**feed, dropout_seeds=seeds(fused))
    grads = {names[p]: g for p, g in opt.minimize(loss)}
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    require(counts == expected(**per_fused),
            f"BERT fused step 1: launches {counts}")
    _require_repeat(grads, repeat, "BERT fused route")
    fused_loss = loss.item()
    del grads, repeat

    flash_opt = Adam(flash.parameters(), learning_rate=BERT_LR)
    kernels.reset_launches()
    loss, _ = flash(**feed, dropout_seeds=seeds(flash))
    flash_opt.minimize(loss)
    torch.cuda.synchronize()
    flash_counts = dict(kernels.launches)
    require(flash_counts == expected(**per_flash),
            f"BERT use_flash step 1: launches {flash_counts}")
    flash_loss = loss.item()
    require(abs(flash_loss - fused_loss) <= TOL_ROUTES_LOSS * abs(fused_loss),
            f"BERT step 1: use_flash loss {flash_loss}, fused {fused_loss} "
            f"under the same seeds")

    # rate 0 (eval mode): the unfused composition against the fused route
    # at its initial weights, no kernel on the composition
    fused_0 = BertPretrain(**BERT, device=DEV)
    attention_fuse(fused_0)
    fused_0.load_state_dict(composed.state_dict())
    with torch.no_grad():
        kernels.reset_launches()
        composed_loss = composed.eval()(**feed)[0].item()
        require(kernels.launches == expected(),
                f"BERT composition launched {kernels.launches}")
        rate0_loss = fused_0.eval()(**feed)[0].item()
    del fused_0
    require(abs(composed_loss - rate0_loss) <= TOL_ROUTES_LOSS
            * abs(rate0_loss), f"BERT rate 0: composed loss "
            f"{composed_loss}, fused {rate0_loss}")

    records = []
    for route, model, o, c, per in (
            ("bert fused (attention_fuse, bhtd)", fused, opt, counts,
             per_fused),
            ("bert use_flash (fused qkv)", flash, flash_opt, flash_counts,
             per_flash)):
        timed = _bert_timed(model, o, per, seed=len(records) + 7)
        for name, n in timed.pop("launches").items():
            c[name] += n
        records.append(dict(route=route, batch=BERT_BATCH,
                            dropout_rate=DROPOUT, launches=c, **timed))
    records[0].update(
        # (card, float64, CPU f32) step-1 losses at the parity batch
        parity_losses=(small_loss, *cpu_losses),
        # (card vs f64, cpu f32 vs f64, name)
        parity_grad_rel_worst=worst_grad[:4],
        parity_grad_rel_median=[float(np.median([w[i] for w in worst_grad]))
                                for i in range(2)],
        cpu_parity_s=cpu_s, step1_loss=fused_loss,
        use_flash_step1_loss=flash_loss, rate0_loss=rate0_loss,
        composed_rate0_loss=composed_loss)
    return records


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


def profile_training(model, tag, feed=None, lr=TRAIN_LR):
    """Device time by kernel over one training step (forward, backward,
    Adam) on ``feed`` (the Transformer's timed batch by default), beside
    host wall time; the table goes to
    ``profile_training_step_<tag>.txt``."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import Adam

    opt = Adam(model.parameters(), learning_rate=lr)
    if feed is None:
        feed = _to(training_batch(seed=2), "cuda")
    opt.minimize(model(**feed)[0])  # warm: the allocator and the state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.minimize(model(**feed)[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_kernels(prof)
    busy_us = sum(us for _, us in rows)
    with open(os.path.join(OUT_DIR, f"profile_training_step_{tag}.txt"),
              "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / wall_us if busy_us else None,
                gemm_cuh_ms=_gemm_cuh_us(rows) / 1e3,
                walks_ms=_walks_us(rows) / 1e3,
                top=[(name[:60], us / 1e3) for name, us in rows[:12]])


def _gemm_cuh_us(rows):
    """Device us of ``csrc/gemm.cuh``'s kernels (its GEMM tile and the
    split-K sums) among the profiler's rows."""
    return sum(us for name, us in rows
               if "::gemm_kernel<" in name or "::sum_splits(" in name)


def _walks_us(rows):
    """Device us of the backward walks (``csrc/flash_walk.cuh``'s dq and
    dkv kernels, in every layout and inside the pair) among the
    profiler's rows."""
    return sum(us for name, us in rows
               if "flash_bwd_dq_kernel<" in name
               or "flash_bwd_dkv_kernel<" in name)


def profile_resnet(model):
    """Device time by kernel over one ResNet-50 step at RESNET_BATCH
    (forward, backward, Momentum), beside host wall time; the table goes
    to ``profile_resnet_step.txt``.  Also lists every device kernel whose
    name says it converts layouts (NCHW/NHWC or a transpose)."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch import Momentum

    opt = Momentum(model.parameters(), RESNET_LR, RESNET_MOMENTUM)
    feed = _to(resnet_batch(RESNET_BATCH, seed=2), "cuda")
    opt.minimize(model(**feed)[0])  # warm: the allocator and the state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.minimize(model(**feed)[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_kernels(prof)
    busy_us = sum(us for _, us in rows)
    with open(os.path.join(OUT_DIR, "profile_resnet_step.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=80))
    layout = [(name[:80], us / 1e3) for name, us in rows
              if any(k in name.lower() for k in ("nchw", "nhwc",
                                                 "transpose"))]
    # #19 in the step: its 36 launches' device time beside the summed
    # bound of the 36 sites
    dot_ms = sum(us for name, us in rows if "dot_stats_kernel" in name) / 1e3
    dot_bound = sum(dot_stats_bound_ms(*site)
                    for site in resnet_dot_sites(RESNET_BATCH))
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / wall_us if busy_us else None,
                dot_stats_ms=dot_ms, dot_stats_bound_ms=dot_bound,
                dot_stats_bound_share=dot_bound / dot_ms if dot_ms else None,
                top=[(name[:60], us / 1e3) for name, us in rows[:16]],
                layout_kernels=layout)


def profile_deepfm(model):
    """Device time by kernel over one DeepFM step (forward, backward, lazy
    Adam) at DEEPFM_BATCH, beside host wall time; the table goes to
    ``profile_deepfm_step.txt``."""
    from torch.profiler import ProfilerActivity, profile

    opt = _deepfm_adam(model)
    feed = deepfm_batches(DEEPFM_HASH, 1)[0]
    opt.minimize(model(*feed)[0])  # warm: the allocator and the state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.minimize(model(*feed)[0])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_kernels(prof)
    busy_us = sum(us for _, us in rows)
    with open(os.path.join(OUT_DIR, "profile_deepfm_step.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=60))
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
                idle_share=1 - busy_us / wall_us if busy_us else None,
                top=[(name[:60], us / 1e3) for name, us in rows[:12]],
                device_kernels=len(rows))


# ---------------------------------------------------------------------------


def _builds(log, want):
    """Each entry function of the build whose name holds a key of ``want``
    ({kernel: (source or None for any, dynamic shared memory bytes)}): its
    source, template arguments (the mangled name after the kernel's),
    registers, spills and stack (``-Xptxas -v``'s lines of ``log``) and its
    block's dynamic shared memory."""
    import re

    out, src, cur = [], None, None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].split()[0]
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            for kernel, (source, smem) in want.items():
                if kernel in m.group(1) and source in (None, src):
                    args = m.group(1).split(kernel, 1)[1]
                    cur = dict(kernel=kernel, source=src,
                               template=args[:args.find("EE") + 2]
                               if args.startswith("I") else "",
                               layout=("bhtd" if "Bhtd" in args else "bthd")
                               if "flash" in kernel else None,
                               dropout="Lb1E" in args and "flash" in kernel,
                               smem_bytes=smem)
                    out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if cur is not None and m:
            cur.update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if cur is not None and m:
            cur["registers"] = int(m[1])
    return out


def walk_builds(log, lib):
    """Each instantiation of the backward walks in the build (every source
    that compiles them): see ``_builds``."""
    return _builds(log, {
        "flash_bwd_dq_kernel": (None, lib.ptt_flash_walk_smem(0)),
        "flash_bwd_dkv_kernel": (None, lib.ptt_flash_walk_smem(1))})


def tile_builds(log, lib):
    """The instantiations of #19's kernel, ``gemm.cuh``'s GEMM (as
    ``gemm.cu`` compiles it) and the flash forward (#4, #5): see
    ``_builds``."""
    return _builds(log, {
        "dot_stats_kernel": ("conv_bn.cu", lib.ptt_dot_stats_smem()),
        "gemm_kernel": ("gemm.cu", lib.ptt_gemm_smem()),
        "flash_fwd_kernel": ("flash_attention.cu",
                             lib.ptt_flash_walk_smem(2))})


def print_record(r, label):
    """Print a phase-2 record and append it to phase2_records.jsonl in
    OUT_DIR (stdout's tail may not reach back to phase 2)."""
    with open(os.path.join(OUT_DIR, "phase2_records.jsonl"), "a") as f:
        f.write(json.dumps(dict(r, label=label)) + "\n")
    print(f"phase 2: {r['name']}{label}: max_abs_err "
          f"{r['max_abs_err']:.3e} ms {r['ms']} plain_ms {r['plain_ms']} "
          f"bound_ms {r['bound_ms']} ({r['bound_by']}) library_ms "
          f"{r['library_ms']}"
          + (f" (library max_abs_err {r['library_max_abs_err']:.3e})"
             if "library_max_abs_err" in r else "")
          + (f"; rate {DROPOUT}: ms {r['dropout_ms']} bound_ms "
             f"{r['dropout_bound_ms']} max_abs_err "
             f"{r['dropout_max_abs_err']:.3e}" if "dropout_ms" in r else "")
          + (f"; bare product (torch.matmul) ms {r['matmul_ms']}"
             if "matmul_ms" in r else "")
          + (f"; {r['tflops']:.2f} TFLOP/s, {r['peak_share']:.1%} of the "
             f"f32 peak (torch.matmul {r['matmul_tflops']:.2f})"
             if "tflops" in r else "")
          + (f"; strided rows copied in {r['strided_copy_ms']} ms"
             if "strided_copy_ms" in r else "")
          + (f"; sums {r['sum_err_of_terms']:.3e} of their terms (TOL_SUM "
             f"{TOL_SUM})" if "sum_err_of_terms" in r else "")
          + (f"; with the host's enqueue {r['call_ms']} ms"
             if "call_ms" in r else "")
          + (f"; device only {r['device_ms']} ms"
             if "device_ms" in r else "")
          + (f"; 26 F.embedding calls {r['embedding_x26_ms']} ms"
             if "embedding_x26_ms" in r else "")
          + (f"; twin's bits: {r['twin_bit_equal']}"
             if "twin_bit_equal" in r else "")
          + (f"; {r['bound_share']:.1%} of the bound"
             if "bound_share" in r else "")
          + (f"; the walks' own bound (s, dp twice) {r['walks_bound_ms']} "
             f"ms; {r['library_factor']:.3f}x the library"
             if "library_factor" in r else ""))


class _Tee:
    """stdout copied into a file of OUT_DIR: the command's tail that the
    caller sees may not reach back to phases 2 and 3."""

    def __init__(self, stream, path):
        self.stream, self.file = stream, open(path, "w")

    def write(self, text):
        self.file.write(text)
        return self.stream.write(text)

    def flush(self):
        self.file.flush()
        self.stream.flush()


def _phase_seconds(label, t0):
    """Print a phase's seconds; returns the time it ended."""
    now = time.perf_counter()
    print(f"{label}: {now - t0:.1f} s")
    return now


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
    os.makedirs(OUT_DIR, exist_ok=True)
    sys.stdout = _Tee(sys.stdout, os.path.join(OUT_DIR,
                                               "chip_smoke_stdout.log"))
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
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_build.build_log())
    open(os.path.join(OUT_DIR, "phase2_records.jsonl"), "w").close()
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "== " in line:
            print("  " + line.strip())
    builds = walk_builds(_build.build_log(), _build.lib())
    tiles = tile_builds(_build.build_log(), _build.lib())
    for r in builds + tiles:
        print(f"phase 1: {r}")

    gen = torch.Generator().manual_seed(0)
    records = {}
    t_phase = time.perf_counter()
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
            print_record(r, f"{' ' + side if side else ''} b={b}")
            # the JSON line carries the cross side of the flash-decode pair
            if side in (None, "cross"):
                records[(r["name"], b)] = r
    for (name, case), r in check_flash_attention(gen).items():
        print_record(r, f" {case} b={r['batch']}")
        if case == FLASH_RECORD_CASE:
            records[(name, max(BATCHES))] = r
    for (name, case), r in check_flash_attention_bhtd(gen).items():
        print_record(r, f" {case} b={r['batch']}")
        if case == BHTD_RECORD_CASE:
            records[(name, max(BATCHES))] = r
    # both walks of a layout in one call sequence, at the record case
    flash_bwd = {"bthd": records.pop(("flash_bwd", max(BATCHES))),
                 "bhtd": records.pop(("flash_bwd_bhtd", max(BATCHES)))}
    # the walks' records in the JSON line carry their builds
    for name, layout in (("flash_bwd_dq", "bthd"), ("flash_bwd_dkv", "bthd"),
                         ("flash_bwd_dq_bhtd", "bhtd"),
                         ("flash_bwd_dkv_bhtd", "bhtd")):
        kernel = name.replace("_bhtd", "") + "_kernel"
        records[(name, max(BATCHES))]["build"] = [
            {k: v for k, v in r.items() if k not in ("kernel", "layout")}
            for r in builds if r["kernel"] == kernel
            and r["layout"] == layout and r["source"] == "flash_attention.cu"]
    for name, layout in (("flash_fwd", "bthd"), ("flash_fwd_bhtd", "bhtd")):
        records[(name, max(BATCHES))]["build"] = [
            {k: v for k, v in r.items() if k not in ("kernel", "layout")}
            for r in tiles if r["kernel"] == "flash_fwd_kernel"
            and r["layout"] == layout]
    pair = {}
    for (name, case), r in check_qkv_training(gen).items():
        residuals = " (residuals)" if name == "qkv_attention_fwd" else ""
        print_record(r, f"{residuals} {case} b={r['batch']}")
        if name == "qkv_bwd":
            pair[case] = r
            for rate, parts in r.get("vs_float64", {}).items():
                print(f"phase 2: qkv_bwd {case} rate {rate}: max abs err "
                      f"against float64 (kernel, f32 twin) and the "
                      f"kernel's excess over TOL_KERNEL against the twin: "
                      f"{parts}")
            continue
        # #1's record in the JSON line stays the serving one (b=64), with
        # the training step's residual mode (its own batch, rate 0 and
        # rate 0.1) beside it
        if case == QKV_RECORD_CASE and not residuals:
            records[(name, max(BATCHES))] = r
        if case == QKV_RECORD_CASE and residuals:
            records[(name, max(BATCHES))]["residual"] = {
                k: r[k] for k in ("batch", "ms", "plain_ms", "bound_ms",
                                  "library_ms", "max_abs_err", "dropout_ms",
                                  "dropout_bound_ms", "dropout_max_abs_err")}
    # #2's and #3's records in the JSON line carry the pair's (the
    # autograd backward's one call) at the record case and at BERT-base's
    pair_keys = ("batch", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "max_abs_err", "dropout_ms",
                 "dropout_bound_ms", "dropout_max_abs_err", "vs_float64")
    for name in ("qkv_bwd_dq", "qkv_bwd_dkv"):
        records[(name, max(BATCHES))]["pair"] = {
            case: {k: pair[case][k] for k in pair_keys if k in pair[case]}
            for case in (QKV_RECORD_CASE, QKV_PAIR_BERT[0])}
    gemm_records = check_gemm(gen)
    for r in gemm_records:
        # the instantiation of its operand layouts
        r["build"] = [{k: v for k, v in t.items() if k != "kernel"}
                      for t in tiles if t["kernel"] == "gemm_kernel"
                      and t["template"] == f"ILb{int(r['a_kmajor'])}"
                                           f"ELb{int(r['b_kmajor'])}EE"]
        print_record(r, f" {r['case']} (M {r['m']}, N {r['n']}, K "
                        f"{r['k']})")
    plans = check_qkv_plans(gen)
    for case, r in plans.items():
        print_record(r, f" (residuals) {case} b={r['batch']} plan "
                        f"{tuple(r['plan'])}")
    # #1's record in the JSON line carries every plan's case beside it
    records[("qkv_attention_fwd", max(BATCHES))]["plans"] = {
        case: {k: r[k] for k in ("plan", "batch", "t", "ms", "plain_ms",
                                 "bound_ms", "library_ms", "max_abs_err",
                                 "dropout_ms", "dropout_max_abs_err",
                                 "device_ms")}
        for case, r in plans.items()}
    print(f"phase 2: head width 128 raises on the card: "
          f"{check_head_width_128(gen)}")
    for r in check_dropout_add(gen):
        print_record(r, f" [{DROPOUT_ROWS}, {BASE['d_model']}] rate "
                        f"{DROPOUT}")
        records[(r["name"], max(BATCHES))] = r
    # the JSON line carries each conv + BN kernel's first case
    for (name, case), r in check_conv_bn(gen).items():
        print_record(r, f" {case} b={r['batch']}")
        records.setdefault((name, max(BATCHES)), r)
    records[("dot_col_stats", max(BATCHES))]["build"] = [
        {k: v for k, v in t.items() if k != "kernel"}
        for t in tiles if t["kernel"] == "dot_stats_kernel"]
    # ... and each embedding kernel's first: #22 on the emb group, #23 in
    # Adam mode on it
    for r, label in check_embedding():
        print_record(r, label)
        records.setdefault((r["name"], max(BATCHES)), r)
    t_phase = _phase_seconds("phase 2", t_phase)

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

    del cpu_model, unfused
    train_model = paddle_tpu_torch.Transformer(
        **BASE, fused_qkv_attention=False).init_params(seed=1)
    # (f)'s models start from the same initial weights
    init_state = {k: v.detach().cpu().clone()
                  for k, v in train_model.state_dict().items()}
    # (e)'s model: the default route, from (d)'s initial weights
    fused_train = paddle_tpu_torch.Transformer(**BASE)
    fused_train.load_state_dict(train_model.state_dict())
    cpu_copies = [paddle_tpu_torch.Transformer(
        **BASE, device="cpu", fused_qkv_attention=False).to(dtype)
        for dtype in (torch.float32, torch.float64)]
    for copy in cpu_copies:
        copy.load_state_dict(train_model.state_dict())
    training, parity = run_training(train_model, *cpu_copies)
    del cpu_copies
    print("phase 3: " + ", ".join(f"{k} {v}" for k, v in training.items()))
    training_fused = run_training_fused(fused_train, parity)
    del parity
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_fused.items()))
    print(f"phase 3: training step, fused route against flag-off: "
          f"{training_fused['step_ms_median']} ms against "
          f"{training['step_ms_median']} ms, "
          f"{training_fused['tokens_per_s']} against "
          f"{training['tokens_per_s']} target tokens/s, f32 peak share "
          f"{training_fused['f32_peak_share']} against "
          f"{training['f32_peak_share']}")

    # (f): dropout on the default route, and its flag-off and CPU copies
    drop_models = [paddle_tpu_torch.Transformer(
        **BASE, dropout_rate=DROPOUT, fused_qkv_attention=fused)
        for fused in (True, False)]
    drop_cpu = [paddle_tpu_torch.Transformer(
        **BASE, device="cpu", fused_qkv_attention=False,
        dropout_rate=DROPOUT).to(dtype)
        for dtype in (torch.float32, torch.float64)]
    for m in drop_models + drop_cpu:
        m.load_state_dict(init_state)
    training_dropout = run_training_dropout(drop_models[0], drop_models[1],
                                            *drop_cpu)
    del drop_cpu, drop_models[1], init_state
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_dropout.items()))
    print(f"phase 3: training step, dropout {DROPOUT} against rate 0 (fused "
          f"route): {training_dropout['step_ms_median']} ms against "
          f"{training_fused['step_ms_median']} ms, "
          f"{training_dropout['tokens_per_s']} against "
          f"{training_fused['tokens_per_s']} target tokens/s, f32 peak "
          f"share {training_dropout['f32_peak_share']} against "
          f"{training_fused['f32_peak_share']}")

    # (g): ResNet-50 training
    resnet = paddle_tpu_torch.ResNet(RESNET_DEPTH,
                                     RESNET_CLASSES).init_params(seed=0)
    training_resnet = run_resnet(resnet)
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_resnet.items()))
    t_phase = _phase_seconds("phase 3 (a)-(g)", t_phase)

    # (h): DeepFM training; and the reference demo's head width 16 served
    deepfm = paddle_tpu_torch.DeepFM(hash_dim=DEEPFM_HASH,
                                     device=DEV).init_params(0)
    training_deepfm = run_deepfm(deepfm)
    print("phase 3: " + ", ".join(f"{k} {v}"
                                  for k, v in training_deepfm.items()))
    demo = run_demo_head16()
    print("phase 3: " + ", ".join(f"{k} {v}" for k, v in demo.items()))
    t_phase = _phase_seconds("phase 3 (h) and the head-width-16 demo",
                             t_phase)

    # (i): BERT-base pretraining on the attention_fuse route (#5, #8, #9);
    # the earlier phases' cached blocks go back first
    torch.cuda.empty_cache()
    bert_fused, bert_flash, bert_composed = _bert_models()
    training_bert = run_bert(bert_fused, bert_flash, bert_composed)
    del bert_composed
    for r in training_bert:
        print("phase 3: " + ", ".join(f"{k} {v}" for k, v in r.items()))
    print(f"phase 3: BERT-base step, attention_fuse (bhtd) route against "
          f"use_flash: {training_bert[0]['step_ms_median']} ms against "
          f"{training_bert[1]['step_ms_median']} ms, "
          f"{training_bert[0]['tokens_per_s']} against "
          f"{training_bert[1]['tokens_per_s']} tokens/s, f32 peak share "
          f"{training_bert[0]['f32_peak_share']} against "
          f"{training_bert[1]['f32_peak_share']}")
    t_phase = _phase_seconds("phase 3 (i)", t_phase)

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
    bert_feed = _to(bert_batch(BERT_BATCH, seed=2), DEV)
    profiles = {}
    for tag, m, kw in (("flag_off", train_model, {}),
                       ("fused", fused_train, {}),
                       ("fused_dropout", drop_models[0], {}),
                       ("bert_bhtd", bert_fused,
                        dict(feed=bert_feed, lr=BERT_LR)),
                       ("bert_use_flash", bert_flash,
                        dict(feed=bert_feed, lr=BERT_LR))):
        r = profile_training(m, tag, **kw)
        profiles[tag] = {k: v for k, v in r.items() if k != "top"}
        if not r["device_busy_ms"]:
            print(f"phase 4: training step {tag}: device time not measured "
                  f"(the profiler saw no device events)")
            continue
        print(f"phase 4: training step {tag}: wall {r['wall_ms']} ms, "
              f"device busy {r['device_busy_ms']} ms, idle share "
              f"{r['idle_share']}, gemm.cuh's kernels {r['gemm_cuh_ms']} "
              f"ms, the backward walks {r['walks_ms']} ms")
        for name, ms in r["top"]:
            print(f"    {ms:.4f} ms  {name}")
    profile_rn = profile_resnet(resnet)
    if profile_rn["dot_stats_ms"]:
        records[("dot_col_stats", max(BATCHES))]["per_step"] = {
            k: profile_rn[k] for k in ("dot_stats_ms", "dot_stats_bound_ms",
                                       "dot_stats_bound_share")}
    if not profile_rn["device_busy_ms"]:
        print("phase 4: resnet50 training step: device time not measured "
              "(the profiler saw no device events)")
    else:
        print(f"phase 4: resnet50 training step (batch {RESNET_BATCH}): "
              f"wall {profile_rn['wall_ms']} ms, device busy "
              f"{profile_rn['device_busy_ms']} ms, idle share "
              f"{profile_rn['idle_share']}; #19 {profile_rn['dot_stats_ms']} "
              f"ms a step against its 36 sites' summed bound "
              f"{profile_rn['dot_stats_bound_ms']} ms (share "
              f"{profile_rn['dot_stats_bound_share']})")
        for name, ms in profile_rn["top"]:
            print(f"    {ms:.4f} ms  {name}")
        print("phase 4: resnet50 layout-conversion kernels (NCHW/NHWC, "
              f"transpose): {profile_rn['layout_kernels'] or 'none'}")
    profile_fm = profile_deepfm(deepfm)
    if not profile_fm["device_busy_ms"]:
        print("phase 4: deepfm training step: device time not measured "
              "(the profiler saw no device events)")
    else:
        print(f"phase 4: deepfm training step (batch {DEEPFM_BATCH}): wall "
              f"{profile_fm['wall_ms']} ms, device busy "
              f"{profile_fm['device_busy_ms']} ms, idle share "
              f"{profile_fm['idle_share']}, "
              f"{profile_fm['device_kernels']} kernel names")
        for name, ms in profile_fm["top"]:
            print(f"    {ms:.4f} ms  {name}")
    t_phase = _phase_seconds("phase 4", t_phase)

    # launches over every counted path; the FFN counter is split between
    # the ring paths (#11) and the paged ones (#13)
    paths = runs + serving + [training, training_fused, training_dropout,
                              training_resnet, training_deepfm, demo,
                              *training_bert]
    total = {name: sum(r["launches"][name] for r in paths)
             for name in paths[0]["launches"]}
    paged_ffn = sum(r["launches"]["ffn"] for r in paths
                    if r["launches"]["megastep_paged"])
    total["ffn_paged"] = paged_ffn
    total["ffn"] -= paged_ffn
    kernels_line = []
    for name in ("qkv_attention_fwd", "qkv_bwd_dq", "qkv_bwd_dkv",
                 "megastep", "ffn", "megastep_paged", "ffn_paged",
                 "flash_decode", "flash_decode_paged", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_bhtd",
                 "flash_bwd_dq_bhtd", "flash_bwd_dkv_bhtd", "dropout_add_fwd",
                 "dropout_add_bwd", "channel_stats", "dot_col_stats",
                 "ssa_fwd", "ssa_bwd", "multi_table_gather",
                 "multi_table_apply"):
        r = dict(records[(name, max(BATCHES))])
        r.pop("library_max_abs_err", None)
        r["launches"] = total[name]
        require(r["launches"] > 0, f"{name}: no launch on the main paths")
        kernels_line.append(r)
    print(json.dumps({"main_path": runs, "serving": serving,
                      "training": training, "training_fused": training_fused,
                      "training_dropout": training_dropout,
                      "training_resnet": training_resnet,
                      "training_deepfm": training_deepfm, "demo": demo,
                      "training_bert": training_bert,
                      "profile_resnet": {k: v for k, v in profile_rn.items()
                                         if k != "top"},
                      "profile_deepfm": profile_fm, "gemm": gemm_records,
                      "flash_bwd": flash_bwd, "walk_builds": builds,
                      "tile_builds": tiles,
                      "profile_training": profiles,
                      "power": smi}))
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
