"""paddle_tpu_torch kernels: the plain PyTorch versions against the JAX
package, on the CPU.

On a CPU tensor each wrapper of the port runs its plain version, so these
tests hold that plain arithmetic against the reference's Pallas kernels
(interpret mode) and their XLA compositions.  The CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
Inputs are drawn from numpy seeds and handed to both packages.
"""

import ctypes
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import attention as jax_attention
from paddle_tpu.kernels import decode_attention as jax_decode_attention
from paddle_tpu.kernels import decode_step as jax_decode_step
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import attention as ka
from paddle_tpu_torch.kernels import decode_attention as kda
from paddle_tpu_torch.kernels import decode_step as kds
from paddle_tpu_torch.ops.generation_ops import sample_token

#: f32 on both sides; the packages sum in different orders
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash_qkv_attention
# ---------------------------------------------------------------------------


def _qkv_inputs(bias_kind, b=2, t=16, h=2, dh=64, dm=128, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, dm) * 0.5).astype(np.float32)
    w_qkv = (rng.randn(dm, 3 * h * dh) * 0.08).astype(np.float32)
    w_out = (rng.randn(h * dh, dm) * 0.08).astype(np.float32)
    if bias_kind == "pad":
        # the prefill's key-padding bias: lane 1 has a padded tail
        pad = np.zeros((b, t), np.float32)
        pad[1, t - 5:] = 1.0
        bias = (-1e9 * pad).reshape(b, 1, 1, t)
    else:
        bias = (rng.randn(b, h, t, t) * 0.5).astype(np.float32)
    return x, w_qkv, w_out, bias


@pytest.mark.parametrize("causal,bias_kind", [(False, "pad"), (True, "pad"),
                                              (False, "dense")])
def test_flash_qkv_attention_matches_jax(causal, bias_kind):
    x, w_qkv, w_out, bias = _qkv_inputs(bias_kind)
    kw = dict(n_head=2, scale=64 ** -0.5, causal=causal)
    want = jax_attention.flash_qkv_attention(
        jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out),
        jnp.asarray(bias), interpret=True, **kw)
    got = ka.flash_qkv_attention(torch.from_numpy(x),
                                 torch.from_numpy(w_qkv),
                                 torch.from_numpy(w_out),
                                 torch.from_numpy(bias), **kw)
    assert got.shape == (2, 16, 128) and got.dtype == torch.float32
    _close(got, want)


def test_flash_qkv_attention_broadcast_bias_and_masked_rows():
    """A [t]-only bias broadcasts like the reference's; a row whose keys
    are all causally hidden by -1e30 scores gets a zero context."""
    x, w_qkv, w_out, bias = _qkv_inputs("pad")
    kw = dict(n_head=2, scale=0.125)
    t = x.shape[1]
    row = torch.from_numpy(bias[1, 0, 0])            # [t]
    full = torch.from_numpy(bias[1:2]).expand(2, 1, 1, t)
    args = [torch.from_numpy(a) for a in (x, w_qkv, w_out)]
    _close(ka.flash_qkv_attention(*args, row, **kw),
           ka.flash_qkv_attention(*args, full, **kw), 0.0)
    hidden = torch.full((2, 1, t, t), -1e30)
    out = ka.reference_qkv_attention(*args, hidden, **kw)
    assert torch.count_nonzero(out) == 0


def test_flash_qkv_attention_refuses_what_it_cannot_compute():
    x, w_qkv, w_out, bias = _qkv_inputs("pad")
    args = [torch.from_numpy(a) for a in (x, w_qkv, w_out)]
    with pytest.raises(ValueError, match="needs dropout_seed"):
        ka.flash_qkv_attention(*args, n_head=2, dropout_rate=0.1)
    with pytest.raises(ValueError):
        ka.flash_qkv_attention(*args, torch.zeros(3, 1, 1, 16), n_head=2)
    # no fallback off the CPU: a tensor the kernel cannot take raises
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        ka.flash_qkv_attention(*meta, n_head=2)


# ---------------------------------------------------------------------------
# flash_decode, flash_decode_paged, paged_scatter_rows
# ---------------------------------------------------------------------------

#: lengths of the decode-attention cases: an empty lane, a mid-block
#: tail, a block boundary plus one and a full window
_DECODE_LENS = np.array([0, 5, 33, 64], np.int32)


def _decode_attention_inputs(seed, rows_or_pool, b=4, h=8, dh=64):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, dh).astype(np.float32)
    k = rng.randn(*rows_or_pool, h, dh).astype(np.float32)
    v = rng.randn(*rows_or_pool, h, dh).astype(np.float32)
    return rng, q, k, v


def test_flash_decode_matches_jax_interpret_kernel():
    """The ring walk against the interpret-mode Pallas kernel (which also
    gives the empty lane 0)."""
    _, q, k, v = _decode_attention_inputs(0, (4, 64))
    want = jax_decode_attention.flash_decode(
        *(jnp.asarray(a) for a in (q, k, v, _DECODE_LENS)), scale=0.125,
        block_t=16, interpret=True)
    got = kda.flash_decode(*(torch.from_numpy(a)
                             for a in (q, k, v, _DECODE_LENS)), scale=0.125)
    _close(got, want)
    assert torch.count_nonzero(got[0]) == 0


def test_flash_decode_paged_matches_jax_interpret_kernel():
    """The paged walk on a shuffled table over a pool with holes, against
    the interpret-mode Pallas kernel."""
    rng, q, k, v = _decode_attention_inputs(1, (32, 16))
    table = rng.permutation(32)[:16].reshape(4, 4).astype(np.int32)
    args = (q, k, v, table, _DECODE_LENS)
    want = jax_decode_attention.flash_decode_paged(
        *(jnp.asarray(a) for a in args), scale=0.125, interpret=True)
    got = kda.flash_decode_paged(*(torch.from_numpy(a) for a in args),
                                 scale=0.125)
    _close(got, want)
    # the same rows in a ring give the same answer
    ring = kda.reference_decode(
        torch.from_numpy(q), torch.from_numpy(k[table].reshape(4, 64, 8, 64)),
        torch.from_numpy(v[table].reshape(4, 64, 8, 64)),
        torch.from_numpy(_DECODE_LENS), 0.125)
    _close(got, ring, 0.0)


def test_paged_scatter_rows_matches_jax():
    """Two rows per lane: lane 0 across a block boundary, lane 1
    inactive, lane 2 half past the logical window (dropped), lane 3 at
    the last row; the pool is written in place, only where the
    reference writes."""
    rng = np.random.RandomState(2)
    cache = rng.randn(2, 12, 8, 2, 64).astype(np.float32)
    new = rng.randn(4, 2, 2, 64).astype(np.float32)
    table = rng.permutation(12)[:8].reshape(4, 2).astype(np.int32)
    pos = np.array([7, 3, 15, 14], np.int32)
    active = np.array([1, 0, 1, 1], np.int32)
    want = jax_decode_attention.paged_scatter_rows(
        *(jnp.asarray(a) for a in (cache, new, table, pos, active)), 1)
    got = torch.from_numpy(cache.copy())
    kda.paged_scatter_rows(got, *(torch.from_numpy(a)
                                  for a in (new, table, pos, active)), 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != cache).any(axis=(2, 3, 4)).sum() == 4


def test_paged_scatter_rows_drops_everything_when_no_row_is_kept():
    rng = np.random.RandomState(3)
    cache = torch.from_numpy(rng.randn(1, 4, 8, 2, 64).astype(np.float32))
    before = cache.clone()
    kda.paged_scatter_rows(
        cache, torch.ones(2, 1, 2, 64), torch.tensor([[1], [2]],
                                                     dtype=torch.int32),
        torch.tensor([3, 8], dtype=torch.int32),
        torch.tensor([0, 1], dtype=torch.int32), 0)
    assert torch.equal(cache, before)


def test_decode_attention_wrappers_refuse_non_cpu_tensors():
    _, q, k, v = _decode_attention_inputs(0, (4, 64))
    meta = [torch.from_numpy(a).to("meta")
            for a in (q, k, v, _DECODE_LENS)]
    with pytest.raises(ValueError):
        kda.flash_decode(*meta)
    table = torch.zeros(4, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        kda.flash_decode_paged(meta[0], meta[1].reshape(16, 16, 8, 64),
                               meta[2].reshape(16, 16, 8, 64), table,
                               meta[3])


def _decode_plan_sum(plan, q, k, v, lengths, scale):
    """Flash-decode as ``csrc/decode_attention.cu`` splits it under
    ``plan``, in numpy f32: each split holding rows walks its 16-row
    chunks in order (an online softmax), then each (sequence, head)'s
    partials are merged in split order; a lane with no rows gets 0."""
    b, h, dh = q.shape
    rows = k.shape[1]
    n = np.clip(lengths, 0, rows)
    out = np.zeros((b, h, dh), np.float32)
    for i in range(b):
        parts = []
        for s in range(-(-int(n[i]) // plan.split)):
            m = np.full(h, -np.inf, np.float32)
            l = np.zeros(h, np.float32)
            acc = np.zeros((h, dh), np.float32)
            end = min((s + 1) * plan.split, int(n[i]))
            for c0 in range(s * plan.split, end, kda.WALK_CHUNK):
                rs = slice(c0, min(c0 + kda.WALK_CHUNK, end))
                sc = np.einsum("hd,rhd->hr", q[i], k[i, rs]) * np.float32(
                    scale)
                m_new = np.maximum(m, sc.max(-1))
                p = np.exp(sc - m_new[:, None])
                alpha = np.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + np.einsum("hr,rhd->hd", p,
                                                       v[i, rs])
                m = m_new
            parts.append((m, l, acc))
        if parts:
            mx = np.max([m for m, _, _ in parts], axis=0)
            e = [np.exp(m - mx) for m, _, _ in parts]
            total = sum(l * es for (_, l, _), es in zip(parts, e))
            ctx = sum(a * es[:, None] for (_, _, a), es in zip(parts, e))
            out[i] = ctx / total[:, None]
    return out


@pytest.mark.parametrize("d_head", [64, 128])
@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("rows", [16, 128, 256])
@pytest.mark.parametrize("b", [1, 3, 33, 64])
def test_decode_plan_covers_every_item(b, rows, sms, d_head):
    """Flash-decode's plan for 8 heads of ``d_head`` on a card of ``sms``
    SMs: the walk's items (the (head group, sequence, split) triples whose
    split holds rows, item i on block i % grid) cover every valid row of
    every (sequence, head) exactly once, lengths 0 and full included; the
    blocks' shared memory fits a block (at 128 a group of 8 heads cannot:
    the plan takes 4 or fewer) and the SMs that hold them; the scratch
    holds every split's partial; and a sum that follows the plan's splits
    and merge order equals ``reference_decode``."""
    h = 8
    plan = kda.decode_plan(b, h, rows, sms, 1, d_head)
    assert plan.group in kda.DECODE_GROUPS
    assert plan.group <= (8 if d_head == 64 else 4)
    assert plan.smem == 4 * kda.walk_floats(d_head, plan.group,
                                            kda.DECODE_STAGES, h, b)
    assert plan.smem <= kda.SMEM_CAP
    per_sm = -(-plan.grid // sms)
    assert per_sm * (plan.smem + kda.BLOCK_RESERVED_SMEM) <= kda.SM_SMEM
    assert per_sm * plan.group <= 8
    assert plan.split % kda.WALK_CHUNK == 0
    assert plan.splits <= kda.WALK_MAX_SPLITS
    assert (plan.splits - 1) * plan.split < rows <= plan.splits * plan.split
    assert plan.scratch == b * plan.splits * h * kda.walk_part(d_head)
    assert plan.ints() == (plan.group, plan.grid, plan.split, plan.smem)

    rng = np.random.RandomState(b * 1000 + rows + sms + d_head)
    lengths = rng.randint(0, rows + 1, b).astype(np.int32)
    if b > 1:
        lengths[0], lengths[-1] = 0, rows
    groups = -(-h // plan.group)
    per_seq = -(-lengths // plan.split)
    items = [(g, i, s) for g in range(groups) for i in range(b)
             for s in range(per_seq[i])]
    assert len(items) <= groups * b * plan.splits
    seen = np.zeros((b, h, rows), np.int32)
    blocks = np.zeros(plan.grid, np.int32)
    for it, (g, i, s) in enumerate(items):
        heads = slice(g * plan.group, (g + 1) * plan.group)
        seen[i, heads, s * plan.split:min((s + 1) * plan.split,
                                          lengths[i])] += 1
        blocks[it % plan.grid] += 1
    valid = np.arange(rows)[None, None, :] < lengths[:, None, None]
    assert (seen[np.broadcast_to(valid, seen.shape)] == 1).all()
    assert (seen[~np.broadcast_to(valid, seen.shape)] == 0).all()
    assert blocks.max() - blocks.min() <= 1

    q = rng.randn(b, h, d_head).astype(np.float32)
    k = rng.randn(b, rows, h, d_head).astype(np.float32)
    v = rng.randn(b, rows, h, d_head).astype(np.float32)
    scale = d_head ** -0.5
    want = kda.reference_decode(*(torch.from_numpy(a)
                                  for a in (q, k, v, lengths)), scale)
    got = _decode_plan_sum(plan, q, k, v, lengths, scale)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)
    assert not got[lengths == 0].any()


# ---------------------------------------------------------------------------
# fused_decode_step
# ---------------------------------------------------------------------------

_LAYERS, _LAYER = 2, 1


def _decode_inputs(dm, di, b=4, h=8, dh=64, max_t=128, cross_t=128, seed=0):
    rng = np.random.RandomState(seed)
    hd = h * dh

    def f(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    weights = [f(b, 1, dm, scale=1.0), f(dm, 3 * hd), f(hd, dm),
               f(dm) + 1, f(dm), f(dm, hd), f(hd, dm), f(dm) + 1, f(dm),
               f(dm, di), f(di), f(di, dm), f(dm), f(dm) + 1, f(dm)]
    caches = [f(_LAYERS, b, max_t, h, dh, scale=1.0),
              f(_LAYERS, b, max_t, h, dh, scale=1.0),
              f(_LAYERS, b, cross_t, h, dh, scale=1.0),
              f(_LAYERS, b, cross_t, h, dh, scale=1.0)]
    # ragged self lengths (mid-block and a full buffer), lane 2 inactive,
    # lane 3 with an empty cross cache
    pos = np.array([0, 4, 36, 127], np.int32)
    active = np.array([1, 1, 0, 1], np.int32)
    ints = [pos, pos + active, np.array([3, 128, 60, 0], np.int32), active]
    return weights, caches, ints


def _run_port(weights, caches, ints, h):
    t = [torch.from_numpy(a.copy()) for a in weights + caches + ints]
    out, ck, cv = kds.fused_decode_step(*t, layer=_LAYER, n_head=h,
                                        scale=64 ** -0.5)
    assert ck is t[15] and cv is t[16]  # the self cache is written in place
    return out, ck, cv


@pytest.mark.parametrize("dm,di,fuse_ffn", [(128, 256, True),
                                            (128, 9216, False)])
def test_fused_decode_step_matches_jax(dm, di, fuse_ffn):
    """Both plan modes of the reference megastep (fused FFN and the split
    _ffn_kernel launch), ragged lengths, an inactive and an empty lane."""
    plan = jax_decode_step._megastep_plan(dm, 8, 64, di, 128, 128,
                                          "float32")
    assert plan.ok and plan.fuse_ffn == fuse_ffn
    weights, caches, ints = _decode_inputs(dm, di)
    got = _run_port(weights, caches, ints, h=8)

    jw = [jnp.asarray(a) for a in weights + caches + ints]
    kw = dict(layer=_LAYER, n_head=8, scale=64 ** -0.5)
    kernel = jax_decode_step.fused_decode_step(*jw, interpret=True, **kw)
    composed = jax_decode_step.reference_decode_step(*jw, **kw)
    for g, k in zip(got, kernel):
        _close(g, k)
    # the composition's plain softmax spreads an empty lane uniformly
    # over the cache where the kernel (and the port) give it 0: hold the
    # lanes with a non-empty cross cache against it
    _close(got[0][:3], composed[0][:3])
    _close(got[1], composed[1])
    _close(got[2], composed[2])


def test_inactive_lane_keeps_its_cache_rows():
    weights, caches, ints = _decode_inputs(128, 256, seed=3)
    _, ck, cv = _run_port(weights, caches, ints, h=8)
    np.testing.assert_array_equal(ck[:, 2].numpy(), caches[0][:, 2])
    np.testing.assert_array_equal(cv[:, 2].numpy(), caches[1][:, 2])
    changed = (ck[_LAYER].numpy() != caches[0][_LAYER]).any(axis=(2, 3))
    assert changed.sum() == 3 and not changed[2].any()  # one row per lane


def test_decode_wrappers_refuse_non_cpu_tensors():
    weights, caches, ints = _decode_inputs(128, 256)
    t = [torch.from_numpy(a).to("meta") for a in weights + caches + ints]
    with pytest.raises(ValueError):
        kds.fused_decode_step(*t, layer=_LAYER, n_head=8, scale=0.125)
    with pytest.raises(ValueError):
        kds.ffn_epilogue(t[0], *t[9:15])


@pytest.mark.parametrize("d_head", [64, 128])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n_head", [8, 12])
def test_megastep_plan_covers_every_item(n_head, sms, d_head):
    """The megastep's plan for b in 1..64 on a card of ``sms`` SMs (the
    H100 SXM's 132, the PCIe's 114), one block an SM, at head width 64
    (d_model 512) and 128 (d_model 1024, Transformer-big's, where the
    projections' W tiles and the walk's ring compete for a block's shared
    memory): every output of x Wqkv (3hd columns), ctx Wout (d_model) and
    x1 Wcq (hd) is owned by exactly one (column tile, row group) item,
    each tile within the block's threads, the whole layout within a
    block's shared memory, the walk's group of heads (8 at 64, 4 at 128)
    within it too; every (sequence, head) walk's rows are covered exactly
    once by its splits, whole 16-row chunks each."""
    dm, hd = 512 * d_head // 64, n_head * d_head
    group = kds.MEGASTEP_GROUPS[d_head]
    assert group * d_head <= 512  # a walk stage's row of k or v
    for b in range(1, 65):
        for self_rows, cross_rows in ((128, 256), (65, 258)):
            plan = kds.megastep_plan(b, n_head, dm, sms, 1, self_rows,
                                     cross_rows, d_head)
            assert plan.grid == sms
            assert plan.smem == 4 * kds._plan_floats(b, dm, n_head, plan.qkv,
                                                     plan.out, plan.cq,
                                                     d_head)
            assert plan.smem >= 4 * kda.walk_floats(
                d_head, group, kds.MEGASTEP_STAGES, n_head, b)
            assert plan.smem <= kds.MEGASTEP_SMEM_CAP
            assert plan.cq[1] <= kds.MEGASTEP_LN_ROWS
            for (ct, rg), n in ((plan.qkv, 3 * hd), (plan.out, dm),
                                (plan.cq, hd)):
                patches = (max(rg, 4) // 4) * (ct // 4)
                assert ct in (4, 8, 16, 32, 64) and rg in (1, 2, 4, 8, 16,
                                                           32, 64)
                assert kds.MEGASTEP_THREADS % patches == 0
                owned = np.zeros((b, n), np.int32)
                tiles = -(-n // ct)
                for item in range(tiles * -(-b // rg)):
                    c0, r0 = (item % tiles) * ct, (item // tiles) * rg
                    owned[r0:r0 + rg, c0:c0 + ct] += 1
                assert (owned == 1).all(), (b, ct, rg, n)
            for rows, split, splits in (
                    (self_rows, plan.self_split, plan.self_splits),
                    (cross_rows, plan.cross_split, plan.cross_splits)):
                assert split % kds.MEGASTEP_CHUNK == 0
                seen = np.zeros(rows, np.int32)
                for s in range(splits):
                    seen[s * split:(s + 1) * split] += 1
                assert (seen == 1).all() and (splits - 1) * split < rows
                assert splits <= kds.MEGASTEP_MAX_SPLITS


def _ffn_plan_sum(plan, x, w_in, b_in, w_out, b_out, ln_s, ln_b):
    """The FFN as ``csrc/ffn.cu`` splits it under ``plan``, in numpy f32:
    P1's items write h, P2's items write their slabs' partials, every
    element once (asserted), then x + (the partials summed in slab order
    + b_out) and LN3.  Returns (out, floats of scratch written)."""
    b, dm = x.shape
    di = w_in.shape[1]
    h = np.full((b, di), np.nan, np.float32)
    part = np.full((plan.slabs, b, dm), np.nan, np.float32)
    groups, t1 = -(-b // plan.rg), -(-di // plan.ct1)
    for item in range(t1 * groups):
        c0, r0 = (item % t1) * plan.ct1, (item // t1) * plan.rg
        rows, cols = slice(r0, r0 + plan.rg), slice(c0, c0 + plan.ct1)
        assert np.isnan(h[rows, cols]).all()
        h[rows, cols] = np.maximum(x[rows] @ w_in[:, cols] + b_in[cols], 0)
        if plan.fused:
            part[item % t1, rows] = h[rows, cols] @ w_out[cols]
    if not plan.fused:
        c2 = -(-dm // plan.ct2)
        for item in range(plan.slabs * c2 * groups):
            slab, rest = item % plan.slabs, item // plan.slabs
            c0, r0 = (rest % c2) * plan.ct2, (rest // c2) * plan.rg
            ks = slice(slab * plan.ks, (slab + 1) * plan.ks)
            rows, cols = slice(r0, r0 + plan.rg), slice(c0, c0 + plan.ct2)
            assert np.isnan(part[slab, rows, cols]).all()
            part[slab, rows, cols] = h[rows, ks] @ w_out[ks, cols]
    assert not np.isnan(h).any() and not np.isnan(part).any()
    f = part[0].copy()
    for s in range(1, plan.slabs):
        f += part[s]
    y = x + (f + b_out)
    mean = y.mean(-1, keepdims=True)
    var = np.square(y - mean).mean(-1, keepdims=True)
    out = (y - mean) / np.sqrt(var + 1e-5) * ln_s + ln_b
    written = (0 if plan.fused else h.size) + part.size
    return out, written


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("d_inner", [2048, 9216])
def test_ffn_plan_covers_every_item(d_inner, sms):
    """The FFN's plan for b in 1..64 at d_model 512 on a card of ``sms``
    SMs, one block an SM: every h column of every row is owned by exactly
    one P1 item; every (k, column) of W_out is covered exactly once by
    P2's items of each row group (fused: the item's own columns of
    d_inner by every column); the layout fits a block's shared memory;
    the scratch holds what the phases write; P3's lanes fit the grid.
    At small widths a sum that follows the plan's items and order (the
    partials added in slab order) equals ``reference_ffn``."""
    dm, di = 512, d_inner
    for b in range(1, 65):
        plan = kds.ffn_plan(b, dm, di, sms, 1)
        assert plan.grid == sms
        assert plan.smem == 4 * kds.ffn_floats(dm, plan.fused, plan.ct1,
                                               plan.rg, plan.ks, plan.ct2)
        assert plan.smem <= kds.MEGASTEP_SMEM_CAP
        assert plan.ct1 in (4, 8, 16, 32, 64)
        assert plan.rg in (1, 2, 4, 8, 16, 32, 64) and plan.rg // 2 < b
        groups, t1 = -(-b // plan.rg), -(-di // plan.ct1)
        h = np.zeros((b, di), np.int32)
        for item in range(t1 * groups):
            c0, r0 = (item % t1) * plan.ct1, (item // t1) * plan.rg
            h[r0:r0 + plan.rg, c0:c0 + plan.ct1] += 1
        assert (h == 1).all(), (b, plan)
        w_out = np.zeros((groups, di, dm), np.int32)
        if plan.fused:
            assert plan.slabs == t1 and plan.ks == plan.ct2 == 0
            for item in range(t1 * groups):
                c0 = (item % t1) * plan.ct1
                w_out[item // t1, c0:c0 + plan.ct1] += 1
        else:
            assert plan.ks % 4 == 0 and plan.ct2 in (4, 8, 16, 32, 64)
            assert plan.slabs == -(-di // plan.ks)
            c2 = -(-dm // plan.ct2)
            for item in range(plan.slabs * c2 * groups):
                slab, rest = item % plan.slabs, item // plan.slabs
                k0, c0 = slab * plan.ks, (rest % c2) * plan.ct2
                w_out[rest // c2, k0:k0 + plan.ks, c0:c0 + plan.ct2] += 1
        assert (w_out == 1).all(), (b, plan)
        assert plan.scratch == ((0 if plan.fused else b * di)
                                + plan.slabs * b * dm)
        assert plan.lanes in (1, 2, 4, 8, 16, 32)
        assert (plan.lanes == 1
                or plan.lanes * b * dm // 4 <= plan.grid * kds.FFN_THREADS)

    rng = np.random.RandomState(sms + d_inner)
    for b, dm, di, sms_small in ((1, 64, 128, 2), (5, 32, 96, 3),
                                 (33, 64, 200, 2), (9, 96, 64, 3)):
        def f(*shape, scale=1.0):
            return (rng.randn(*shape) * scale).astype(np.float32)

        args = [f(b, dm), f(dm, di, scale=dm ** -0.5), f(di, scale=0.1),
                f(di, dm, scale=di ** -0.5), f(dm, scale=0.1),
                1 + f(dm, scale=0.1), f(dm, scale=0.1)]
        want = kds.reference_ffn(*(torch.from_numpy(a) for a in args))
        plans = [kds.ffn_plan(b, dm, di, sms_small, 1)]
        plans += [kds.FfnPlan(sms_small, fused, ct1, rg, ks, ct2,
                              -(-di // (ks or ct1)), 1, 0, 0)
                  for fused, ct1, rg, ks, ct2 in ((1, 16, 4, 0, 0),
                                                  (0, 8, 2, 32, 16))]
        for plan in plans:
            got, written = _ffn_plan_sum(plan, *args)
            np.testing.assert_allclose(got, want.numpy(), rtol=1e-5,
                                       atol=1e-5)
            if plan is plans[0]:
                assert written == plan.scratch


def test_sample_token_first_max_like_jax():
    logits = np.array([[0.1, 3.0, 3.0, -1.0], [2.0, 2.0, 2.0, 2.0],
                       [-5.0, -4.0, -4.5, -4.0]], np.float32)
    got = sample_token(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(logits, -1)))
    assert got.tolist() == [1, 0, 1]


# ---------------------------------------------------------------------------
# the C entry points
# ---------------------------------------------------------------------------


def _c_entry_points():
    """{name: (return type, [parameter types])} of every ``extern "C"``
    function of ``csrc/*.cu``, as written there."""
    src = "\n".join(open(f).read() for f in sorted(
        glob.glob(os.path.join(_build.CSRC_DIR, "*.cu"))))
    found = {}
    for m in re.finditer(r'extern "C"\s+([\w\s*]+?)\s*\b(ptt_\w+)\s*'
                         r'\(([^)]*)\)', src):
        params = [p.strip() for p in m.group(3).split(",")]
        found[m.group(2)] = (m.group(1), [
            re.sub(r"\w+$", "", p) for p in params
            if p and p != "void"])
    return found


_C_TYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64,
            "float": ctypes.c_float, "double": ctypes.c_double,
            "uint32_t": ctypes.c_uint32, "unsigned": ctypes.c_uint32}


def _c_type(decl):
    words = decl.replace("const", " ").replace("*", " * ").split()
    if "*" in words:
        return ctypes.c_char_p if words[0] == "char" else ctypes.c_void_p
    return _C_TYPES[" ".join(words)]


_ENTRY_POINTS = _c_entry_points()


def test_every_entry_point_has_a_signature():
    """The ctypes table binds exactly the sources' ``extern "C"``
    functions."""
    assert set(_ENTRY_POINTS) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_entry_point_signature_matches_its_source(name):
    """Each entry point's ctypes return and argument types are the ones
    its C definition declares, in order: a plan integer added to or taken
    from a C entry point without its ``_SIGNATURES`` line would shift
    every argument after it."""
    ret, params = _ENTRY_POINTS[name]
    restype, argtypes = _build._SIGNATURES[name]
    assert _c_type(ret) == restype
    assert [_c_type(p) for p in params] == list(argtypes)
