"""Fused decode step: one decoder layer for one token, two launches.

Counterpart of ``paddle_tpu/kernels/decode_step.py`` ``fused_decode_step``
and ``fused_decode_step_paged`` in their split-FFN mode, the mode the
reference's plans take at Transformer-base widths in f32:

* :func:`megastep` (``csrc/megastep.cu``, for ``_megastep_kernel``): qkv
  projection, the in-place k/v row write into the ring cache, the self
  and cross walks with their projections, residuals and layer norms;
* :func:`megastep_paged` (the same source's paged instantiation, for
  ``_paged_megastep_kernel``): the same over paged block pools, every row
  addressed through the block tables;
* :func:`ffn_epilogue` (``csrc/ffn.cu``, for ``_ffn_kernel``): the
  feed-forward, its residual and the last layer norm, after either.

The megastep is one cooperative launch of one block on each SM of the
card, its work split by :func:`megastep_plan` (column tiles and row
groups of the four projections, row splits of the two walks), chosen
from the shape and the card before the launch and passed to the entry
point, which rejects a plan it cannot run.  It is compiled for head
widths 64 and 128 (launches at 128 counted under ``megastep_dh128`` and
``megastep_paged_dh128``); at 128 a walk item takes 4 heads
(:data:`MEGASTEP_GROUPS`), whose ring fits beside the projections'
tiles.  So is the FFN, split by
:func:`ffn_plan` (column tiles of d_inner, then split-K slabs of W_out
whose partials are summed in slab order).

The self cache is updated in place: the port's counterpart of the JAX
package's donated cache buffers.  The returned caches are the tensors
passed in.

The plain versions are :func:`reference_decode_step` and
:func:`reference_decode_step_paged`, the op chains of the reference's
compositions with ``kernels/decode_attention.py``'s plain walks as their
attention.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import (_build, compiled_widths, composed, composes, launches,
               width_suffix)
from .attention import sm_count
from .decode_attention import (SMEM_CAP, WALK_CHUNK, WALK_MAX_SPLITS,
                               reference_decode, reference_decode_paged,
                               walk_floats, walk_split)
from ..ops.generation_ops import kv_cache_update, paged_kv_cache_update
from ..ops.nn_ops import layer_norm


def reference_megastep(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                       ln2_scale, ln2_bias, cache_k, cache_v, cross_k,
                       cross_v, pos, lengths, cross_lengths, active, *,
                       layer, n_head, scale, eps=1e-5):
    """Plain version of :func:`megastep`: the attention half of the
    decoder step.  Updates cache_k/cache_v in place; returns the
    layer-norm-2 output [b, 1, d_model]."""
    b = x.shape[0]
    dh = cache_k.shape[-1]
    hd = n_head * dh

    qkv = x @ wqkv
    q, k, v = torch.split(qkv, hd, dim=-1)
    kv_cache_update(cache_k, cache_v, k.reshape(b, 1, n_head, dh),
                    v.reshape(b, 1, n_head, dh), pos, layer, active)
    ctx = reference_decode(q.reshape(b, n_head, dh), cache_k[layer],
                           cache_v[layer], lengths, scale)
    x = layer_norm(x + ctx.reshape(b, 1, hd) @ wout, ln1_scale, ln1_bias,
                   eps)
    cq = x @ wcq
    cctx = reference_decode(cq.reshape(b, n_head, dh), cross_k[layer],
                            cross_v[layer], cross_lengths, scale)
    return layer_norm(x + cctx.reshape(b, 1, hd) @ wcout, ln2_scale,
                      ln2_bias, eps)


def reference_ffn(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale,
                  ln3_bias, eps=1e-5):
    """Plain version of :func:`ffn_epilogue`:
    LN3(x + relu(x W_in + b_in) W_out + b_out)."""
    hid = torch.relu(x @ ffn_in_w + ffn_in_b)
    return layer_norm(x + (hid @ ffn_out_w + ffn_out_b), ln3_scale,
                      ln3_bias, eps)


def reference_decode_step(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                          ln2_scale, ln2_bias, ffn_in_w, ffn_in_b,
                          ffn_out_w, ffn_out_b, ln3_scale, ln3_bias,
                          cache_k, cache_v, cross_k, cross_v, pos, lengths,
                          cross_lengths, active=None, *, layer, n_head,
                          scale, eps=1e-5):
    """The whole decoder step in plain PyTorch (the reference's
    composition).  Returns (out [b, 1, d_model], cache_k, cache_v)."""
    if active is None:
        active = torch.ones_like(pos)
    x = reference_megastep(
        x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
        ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
        cross_lengths, active, layer=layer, n_head=n_head, scale=scale,
        eps=eps)
    out = reference_ffn(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
                        ln3_scale, ln3_bias, eps)
    return out, cache_k, cache_v


def _megastep_spec(what, x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                   ln2_scale, ln2_bias, cache_k, cache_v, pos, lengths,
                   cross_lengths, active, n_head, layer):
    """The checks both megastep wrappers share: raise unless the kernel
    takes these widths on this device; return the tensor specs of
    :func:`_build.require` for the weights, the self cache and the int32
    vectors."""
    b, _, dm = x.shape
    n_layer, h, dh = cache_k.shape[0], cache_k.shape[-2], cache_k.shape[-1]
    if (x.device.type != "cuda" or h != n_head
            or dh not in compiled_widths(what) or dm % 4
            or not 0 <= layer < n_layer):
        raise ValueError(
            f"{what}: no kernel for x {tuple(x.shape)}, cache "
            f"{tuple(cache_k.shape)}, n_head {n_head}, layer {layer} on "
            f"{x.device} (needs CUDA and d_head in "
            f"{compiled_widths(what)})")
    hd = h * dh
    f32, i32 = torch.float32, torch.int32
    vec = (dm,)
    return {
        "x": (x, f32, (b, 1, dm)), "wqkv": (wqkv, f32, (dm, 3 * hd)),
        "wout": (wout, f32, (hd, dm)), "ln1_scale": (ln1_scale, f32, vec),
        "ln1_bias": (ln1_bias, f32, vec), "wcq": (wcq, f32, (dm, hd)),
        "wcout": (wcout, f32, (hd, dm)), "ln2_scale": (ln2_scale, f32, vec),
        "ln2_bias": (ln2_bias, f32, vec),
        "cache_k": (cache_k, f32, cache_k.shape),
        "cache_v": (cache_v, f32, cache_k.shape),
        "pos": (pos, i32, (b,)), "lengths": (lengths, i32, (b,)),
        "cross_lengths": (cross_lengths, i32, (b,)),
        "active": (active, i32, (b,))}


#: threads of a megastep block (csrc/megastep.cu NT)
MEGASTEP_THREADS = 256
#: cache rows a walk stages at once (CR); a walk split is a multiple of it
MEGASTEP_CHUNK = WALK_CHUNK
#: head width -> heads a walk item stages, a warp each (csrc/megastep.cu
#: walk_group): all 8 of a block's warps at 64; at 128 a group of 8 heads
#: would need a 266 KB ring, so 4 heads walk and the other 4 warps only
#: copy
MEGASTEP_GROUPS = {64: 8, 128: 4}
#: walk chunks in a block's copy ring (STAGES)
MEGASTEP_STAGES = 2
#: shared memory a block may opt into on the H100 (227 KB)
MEGASTEP_SMEM_CAP = SMEM_CAP
#: walk splits a sequence at most (a merge lane each)
MEGASTEP_MAX_SPLITS = WALK_MAX_SPLITS
#: rows a block's warps stage layer norms for at once (one a warp)
MEGASTEP_LN_ROWS = 8
#: a projection item's reduction buffer and P1's row-write offsets
_RED = MEGASTEP_THREADS * 16 + 128
_COLUMN_TILES = (4, 8, 16, 32, 64)
_ROW_GROUPS = (1, 2, 4, 8, 16, 32, 64)


class MegastepPlan(NamedTuple):
    """The work split of one megastep launch (``csrc/megastep.cu``).

    ``grid`` blocks, all co-resident; each projection ``(ct, rg)``: items
    of ct output columns by rg batch rows, every output summed over the
    whole of k by one block (``qkv``: x Wqkv; ``out``: ctx Wout and cctx
    Wcout; ``cq``: x1 Wcq); each walk: items of (sequence, group of up to
    MEGASTEP_GROUPS[d_head] heads, split of ``*_split`` cache rows, a
    multiple of MEGASTEP_CHUNK), ``*_splits`` splits a sequence; ``smem``
    bytes of dynamic shared memory a block."""
    grid: int
    qkv: tuple
    out: tuple
    cq: tuple
    self_split: int
    self_splits: int
    cross_split: int
    cross_splits: int
    smem: int

    def ints(self):
        """The plan's integers in the entry points' order."""
        return (self.grid, *self.qkv, *self.out, *self.cq, self.self_split,
                self.cross_split, self.smem)


def _rows_floats(k, rg):
    """Shared memory floats of a projection item past its W tile: A^T for
    at least 4 rows, the reduction buffer and the row-write offsets."""
    return k * (max(rg, 4) + 4) + _RED


def _plan_floats(b, d_model, n_head, qkv, out, cq, d_head=64):
    """Shared memory floats of a block under these tiles, as
    ``csrc/megastep.cu`` lays them out: P3's and P6's W tile (prefetched
    a phase ahead), then the larger of a walk and P1's or P4's W tile
    with the largest A^T."""
    hd = n_head * d_head
    rows = max(_rows_floats(d_model, qkv[1]), _rows_floats(hd, out[1]),
               _rows_floats(d_model, cq[1]))
    return hd * (out[0] + 4) + max(
        walk_floats(d_head, MEGASTEP_GROUPS[d_head], MEGASTEP_STAGES,
                    n_head, b),
        d_model * (max(qkv[0], cq[0]) + 4) + rows)


def _proj_tile(n, k, b, grid, cap, max_rows=64):
    """(ct, rg) of a projection of n columns over k for b rows, ct and rg
    at most ``cap`` and rg at most ``max_rows`` (x1 Wcq: a row a warp for
    its layer norm): the tile of least modelled time, ceil(items / grid)
    rounds of an item's 1.5 us of latency and barriers, its W tile and
    rows at 20 GB/s an SM (the share of each when every SM loads) and its
    FMAs at 100 a clock (1.9 GHz); ties to fewer items."""
    best = None
    for ct in _COLUMN_TILES:
        if ct > cap or (ct > 4 and ct // 2 >= n):
            continue
        for rg in _ROW_GROUPS:
            if rg > min(cap, max_rows) or (rg > 1 and rg // 2 >= b):
                continue
            if (max(rg, 4) // 4) * (ct // 4) > MEGASTEP_THREADS:
                continue
            items = -(-n // ct) * -(-b // rg)
            us = (1.5 + 4 * k * (ct + rg) / 2e4
                  + rg * ct * k / (100 * 1900))
            key = (-(-items // grid) * us, items)
            if best is None or key < best[0]:
                best = (key, (ct, rg))
    return best[1]


def megastep_plan(b, n_head, d_model, sms, blocks_per_sm, self_rows,
                  cross_rows, d_head=64):
    """The megastep's work split for a batch of ``b`` at these widths
    (``n_head`` heads of ``d_head``, 64 or 128), on a card of ``sms`` SMs
    with a grid of ``blocks_per_sm`` blocks an SM (all co-resident: the
    launch is cooperative), over self and cross caches of ``self_rows``
    and ``cross_rows`` rows a sequence (ring: max_t and cross_t; paged:
    max_blocks * block_t of each side): the largest tiles (up to 32
    columns and rows, then 16, 8, 4) whose shared memory fits a block.
    At d_model 1024 and 8 heads of 128, P3's W tile alone takes 1024 (ct
    + 4) floats beside the 4-head walk's 134 KB, so the cap falls to 16
    (b <= 16: x Wqkv in 16 columns, the others in 8) or 8 (b > 16: every
    projection in (8, 8) items), 182 KB a block.
    Pure: the wrapper passes its integers to the entry point."""
    if min(b, n_head, d_model, sms, blocks_per_sm, self_rows,
           cross_rows) < 1 or d_head not in compiled_widths("megastep"):
        raise ValueError(f"megastep_plan: no plan for b {b}, {n_head} "
                         f"heads of {d_head}, d_model {d_model}, {sms} SMs "
                         f"x {blocks_per_sm}, rows {self_rows}/{cross_rows}")
    hd = n_head * d_head
    grid = sms * blocks_per_sm
    for cap in (32, 16, 8, 4):
        qkv = _proj_tile(3 * hd, d_model, b, grid, cap)
        out = _proj_tile(d_model, hd, b, grid, cap)
        cq = _proj_tile(hd, d_model, b, grid, cap, MEGASTEP_LN_ROWS)
        smem = 4 * _plan_floats(b, d_model, n_head, qkv, out, cq, d_head)
        if smem <= MEGASTEP_SMEM_CAP:
            return MegastepPlan(grid, qkv, out, cq, *walk_split(self_rows),
                                *walk_split(cross_rows), smem)
    raise ValueError(f"megastep: no plan fits b {b}, {n_head} heads of "
                     f"{d_head}, d_model {d_model} in {MEGASTEP_SMEM_CAP} "
                     f"bytes of shared memory a block")


def device_megastep_plan(device, paged, b, n_head, d_model, self_rows,
                         cross_rows, d_head=64):
    """:func:`megastep_plan` as :func:`megastep` and
    :func:`megastep_paged` launch it on ``device``."""
    return _device_launch(device, paged, b, n_head, d_model, self_rows,
                          cross_rows, d_head)[0]


@functools.lru_cache(maxsize=256)
def _device_launch(device, paged, b, n_head, d_model, self_rows,
                   cross_rows, d_head=64):
    """(plan, its integers, the scratch floats) of a launch on ``device``:
    one block an SM of its SM count, the entry point's occupancy at the
    plan's shared memory checked; made once a shape."""
    plan = megastep_plan(b, n_head, d_model, sm_count(device), 1, self_rows,
                         cross_rows, d_head)
    lib = _build.lib()
    per_sm = lib.ptt_megastep_occupancy(int(paged), d_head, plan.smem)
    if per_sm < 1:
        _build.check(-per_sm if per_sm < 0 else 1, "megastep occupancy")
    return plan, plan.ints(), lib.ptt_megastep_scratch(
        b, d_model, n_head, d_head, plan.self_splits, plan.cross_splits)


def _launch_megastep(what, paged, x, args, geometry, rows, layer, n_head,
                     d_head, scale, eps):
    """Launch #10 (ring) or #12 (paged) on checked tensors: ``args`` the
    entry point's tensors in order, ``geometry`` its cache integers,
    ``rows`` the (self, cross) rows a sequence the walks cover.  The
    output and the scratch are one allocation."""
    b, _, dm = x.shape
    _, ints, scratch = _device_launch(x.device, paged, b, n_head, dm, *rows,
                                      d_head)
    buf = torch.empty(b * dm + scratch, dtype=torch.float32, device=x.device)
    lib = _build.lib()
    entry = lib.ptt_megastep_paged if paged else lib.ptt_megastep
    err = entry(*(a.data_ptr() for a in args), buf.data_ptr(),
                buf.data_ptr() + 4 * b * dm, layer, b, dm, n_head, d_head,
                *geometry, *ints, float(scale), float(eps),
                _build.stream_of(x))
    _build.check(err, what)
    launches[what + width_suffix(d_head)] += 1
    return buf[:b * dm].view(b, 1, dm)

def megastep(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
             ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
             cross_lengths, active, *, layer, n_head, scale, eps=1e-5):
    """The attention half of the decoder step (see module docstring).
    x [b, 1, d_model]; caches [L, b, rows, h, dh] (the self cache is
    written in place); pos/lengths/cross_lengths/active [b] int32.
    Returns [b, 1, d_model]."""
    args = (x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
            ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
            cross_lengths, active)
    if x.device.type == "cpu" or composes("megastep", cache_k.shape[-1]):
        return reference_megastep(*args, layer=layer, n_head=n_head,
                                  scale=scale, eps=eps)
    spec = _megastep_spec("megastep", *args[:11], *args[13:], n_head,
                          layer)
    b = x.shape[0]
    n_layer, _, max_t, h, dh = cache_k.shape
    cross_t = cross_k.shape[2]
    cross = (n_layer, b, cross_t, h, dh)
    spec.update(cross_k=(cross_k, torch.float32, cross),
                cross_v=(cross_v, torch.float32, cross))
    _build.require(spec, x.device, "megastep")
    return _launch_megastep("megastep", False, x, args, (max_t, cross_t),
                            (max_t, cross_t), layer, h, dh, scale, eps)


def reference_megastep_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                             ln2_scale, ln2_bias, cache_k, cache_v, cross_k,
                             cross_v, pos, lengths, cross_lengths,
                             self_table, cross_table, active, *, layer,
                             n_head, scale, eps=1e-5):
    """Plain version of :func:`megastep_paged`: the attention half of the
    reference's ``reference_decode_step_paged``.  Updates the self pools
    in place; returns the layer-norm-2 output [b, 1, d_model]."""
    b = x.shape[0]
    dh = cache_k.shape[-1]
    hd = n_head * dh

    qkv = x @ wqkv
    q, k, v = torch.split(qkv, hd, dim=-1)
    paged_kv_cache_update(cache_k, cache_v, k.reshape(b, 1, n_head, dh),
                          v.reshape(b, 1, n_head, dh), self_table, pos,
                          layer, active)
    ctx = reference_decode_paged(q.reshape(b, n_head, dh), cache_k[layer],
                                 cache_v[layer], self_table, lengths, scale)
    x = layer_norm(x + ctx.reshape(b, 1, hd) @ wout, ln1_scale, ln1_bias,
                   eps)
    cq = x @ wcq
    cctx = reference_decode_paged(cq.reshape(b, n_head, dh), cross_k[layer],
                                  cross_v[layer], cross_table,
                                  cross_lengths, scale)
    return layer_norm(x + cctx.reshape(b, 1, hd) @ wcout, ln2_scale,
                      ln2_bias, eps)


def megastep_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                   ln2_scale, ln2_bias, cache_k, cache_v, cross_k, cross_v,
                   pos, lengths, cross_lengths, self_table, cross_table,
                   active, *, layer, n_head, scale, eps=1e-5):
    """:func:`megastep` over paged caches.  cache_k/cache_v [L, num_blocks,
    block_t, h, dh] (written in place) and cross_k/cross_v [L,
    cross_num_blocks, cross_block_t, h, dh] pools; self_table/cross_table
    [b, max_blocks] int32 block ids.  A row at or past
    max_blocks * block_t is dropped, as the reference's composition drops
    it.  Returns [b, 1, d_model]."""
    args = (x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
            ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
            cross_lengths, self_table, cross_table, active)
    if x.device.type == "cpu" or composes("megastep_paged",
                                          cache_k.shape[-1]):
        return reference_megastep_paged(*args, layer=layer, n_head=n_head,
                                        scale=scale, eps=eps)
    spec = _megastep_spec("megastep_paged", *args[:11], *args[13:16],
                          active, n_head, layer)
    b = x.shape[0]
    n_layer, nb, bt, h, dh = cache_k.shape
    cnb, cbt = cross_k.shape[1:3]
    mb, cmb = self_table.shape[1], cross_table.shape[1]
    f32, i32 = torch.float32, torch.int32
    cross = (n_layer, cnb, cbt, h, dh)
    spec.update(cross_k=(cross_k, f32, cross), cross_v=(cross_v, f32, cross),
                self_table=(self_table, i32, (b, mb)),
                cross_table=(cross_table, i32, (b, cmb)))
    _build.require(spec, x.device, "megastep_paged")
    return _launch_megastep("megastep_paged", True, x, args,
                            (nb, bt, mb, cnb, cbt, cmb),
                            (mb * bt, cmb * cbt), layer, h, dh, scale, eps)


#: threads of an FFN block (csrc/ffn.cu NT)
FFN_THREADS = 256
#: floats of an FFN block's group reduction (csrc/ffn.cu RED)
_FFN_RED = FFN_THREADS * 16
#: rows of W_out a split-mode P2 slab may take
_FFN_SLABS = (16, 32, 64, 128, 256, 512)
#: the FFN's cost model: weight bytes a us an SM from HBM when every SM
#: loads (2.6 TB/s over 132 SMs), bytes a us an SM from L2, f32 FMAs a us
#: an SM (100 a clock at 1.9 GHz), a round of items' latency and a grid
#: barrier, us
_FFN_HBM, _FFN_L2, _FFN_FMA, _FFN_ROUND, _FFN_BARRIER = (2e4, 5e4, 1.9e5,
                                                        1.0, 0.75)


class FfnPlan(NamedTuple):
    """The work split of one FFN launch (``csrc/ffn.cu``).

    ``grid`` blocks, all co-resident.  P1, h = relu(x W_in + b_in):
    items of ``ct1`` columns of d_inner by ``rg`` batch rows.  ``fused``:
    each item then multiplies its own h columns by the matching ``ct1``
    rows of W_out (``slabs`` = ceil(d_inner / ct1) partials); else, after
    a barrier, P2 items of ``ks`` rows of W_out by ``ct2`` columns of
    d_model by ``rg`` rows (``slabs`` = ceil(d_inner / ks)).  P3 sums each
    output's partials over ``lanes`` lanes.  ``scratch`` floats (h in
    split mode, then the partials); ``smem`` bytes of dynamic shared
    memory a block."""
    grid: int
    fused: int
    ct1: int
    rg: int
    ks: int
    ct2: int
    slabs: int
    lanes: int
    scratch: int
    smem: int

    def ints(self):
        """The plan's integers in the entry point's order."""
        return (self.grid, self.fused, self.ct1, self.rg, self.ks, self.ct2,
                self.lanes, self.smem)


def _ld(n):
    """Row stride of a shared tile of n columns (csrc/ffn.cu ld_of)."""
    return n + 4 + n % 8


def ffn_floats(d_model, fused, ct1, rg, ks, ct2):
    """Shared memory floats of an FFN block, as ``csrc/ffn.cu`` lays them
    out: the W_in tile, the W_out tile, the item's rows (x, or split P2's
    h slab), fused mode's h, the group reduction, and LN3's scale and
    bias, b_out and the item's b_in."""
    rgp = max(rg, 4)
    w1 = d_model * _ld(ct1) + _FFN_RED + 3 * d_model + ct1
    if fused:
        return (w1 + ct1 * _ld(d_model) + rgp * _ld(d_model)
                + rgp * _ld(ct1))
    return w1 + ks * _ld(ct2) + rgp * max(_ld(d_model), _ld(ks))


def _ffn_us(b, dm, di, grid, fused, ct1, rg, ks, ct2):
    """Modelled us of a plan: each phase's rounds of items (latency, weight
    bytes from HBM, rows and partials through L2, FMAs over all rgp rows
    a patch computes), P3's partial reads spread over the grid, and the
    barriers."""
    nr, rows = min(rg, b), max(rg, 4)
    groups, t1 = -(-b // rg), -(-di // ct1)

    def rounds(items):
        return -(-items // grid)

    if fused:
        us = rounds(t1 * groups) * (
            _FFN_ROUND + 8 * dm * ct1 / _FFN_HBM + 8 * nr * dm / _FFN_L2
            + 2 * rows * ct1 * dm / _FFN_FMA)
        slabs, barriers = t1, 2
    else:
        slabs = -(-di // ks)
        items2 = slabs * -(-dm // ct2) * groups
        us = (rounds(t1 * groups) * (
            _FFN_ROUND + 4 * dm * ct1 / _FFN_HBM
            + 4 * nr * (dm + ct1) / _FFN_L2 + rows * ct1 * dm / _FFN_FMA)
            + rounds(items2) * (
                _FFN_ROUND + 4 * ks * ct2 / _FFN_HBM
                + 4 * nr * (ks + ct2) / _FFN_L2 + rows * ks * ct2 / _FFN_FMA))
        barriers = 3
    return (us + _FFN_ROUND + 4 * slabs * b * dm / (grid * _FFN_L2)
            + barriers * _FFN_BARRIER)


def ffn_plan(b, d_model, d_inner, sms, blocks_per_sm):
    """The FFN's work split for a batch of ``b`` at these widths, on a card
    of ``sms`` SMs with a grid of ``blocks_per_sm`` blocks an SM (all
    co-resident: the launch is cooperative): of the fused and split
    layouts, the tiles of least modelled time (:func:`_ffn_us`) whose
    shared memory fits a block.  Pure: the wrapper passes its integers to
    the entry point."""
    if (min(b, d_model, d_inner, sms, blocks_per_sm) < 1 or d_model % 4
            or d_inner % 4):
        raise ValueError(f"ffn_plan: no plan for b {b}, d_model {d_model}, "
                         f"d_inner {d_inner}, {sms} SMs x {blocks_per_sm}")
    grid = sms * blocks_per_sm
    top = min(64, 1 << (b - 1).bit_length())
    best = None
    for rg in (r for r in _ROW_GROUPS if r <= top):
        for ct1 in _COLUMN_TILES:
            if ct1 > 4 and ct1 // 2 >= d_inner:
                continue
            options = [(1, 0, 0)] + [(0, ks, ct2) for ks in _FFN_SLABS
                                     for ct2 in _COLUMN_TILES
                                     if (ks == 16 or ks // 2 < d_inner)
                                     and (ct2 == 4 or ct2 // 2 < d_model)]
            for fused, ks, ct2 in options:
                smem = 4 * ffn_floats(d_model, fused, ct1, rg, ks, ct2)
                if smem > MEGASTEP_SMEM_CAP:
                    continue
                key = (_ffn_us(b, d_model, d_inner, grid, fused, ct1, rg,
                               ks, ct2), smem)
                if best is None or key < best[0]:
                    best = (key, (fused, ct1, rg, ks, ct2, smem))
    if best is None:
        raise ValueError(f"ffn: no plan fits b {b}, d_model {d_model} in "
                         f"{MEGASTEP_SMEM_CAP} bytes of shared memory a "
                         f"block")
    fused, ct1, rg, ks, ct2, smem = best[1]
    slabs = -(-d_inner // (ct1 if fused else ks))
    lanes = 1
    while (lanes < 32 and lanes < slabs
           and 2 * lanes * b * (d_model // 4) <= grid * FFN_THREADS):
        lanes *= 2
    scratch = (0 if fused else b * d_inner) + slabs * b * d_model
    return FfnPlan(grid, fused, ct1, rg, ks, ct2, slabs, lanes, scratch,
                   smem)


def device_ffn_plan(device, b, d_model, d_inner):
    """:func:`ffn_plan` as :func:`ffn_epilogue` launches it on
    ``device``."""
    return _device_ffn(device, b, d_model, d_inner)[0]


@functools.lru_cache(maxsize=256)
def _device_ffn(device, b, d_model, d_inner):
    """(plan, its integers) of an FFN launch on ``device``: one block an SM
    of its SM count, the entry point's occupancy at the plan's shared
    memory checked; made once a shape."""
    plan = ffn_plan(b, d_model, d_inner, sm_count(device), 1)
    per_sm = _build.lib().ptt_ffn_occupancy(plan.smem)
    if per_sm < 1:
        _build.check(-per_sm if per_sm < 0 else 1, "ffn occupancy")
    return plan, plan.ints()


def ffn_epilogue(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale,
                 ln3_bias, eps=1e-5):
    """LN3(x + relu(x W_in + b_in) W_out + b_out) over x [b, 1, d_model]:
    one cooperative launch of ``csrc/ffn.cu`` split by :func:`ffn_plan`."""
    if x.device.type == "cpu":
        return reference_ffn(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
                             ln3_scale, ln3_bias, eps)
    b, _, dm = x.shape
    di = ffn_in_w.shape[1]
    if x.device.type != "cuda" or dm % 4 or di % 4:
        raise ValueError(f"ffn_epilogue: no kernel for x {tuple(x.shape)}, "
                         f"d_inner {di} on {x.device} (needs CUDA and "
                         f"widths % 4 == 0)")
    f32, vec = torch.float32, (dm,)
    _build.require({
        "x": (x, f32, (b, 1, dm)), "ffn_in_w": (ffn_in_w, f32, (dm, di)),
        "ffn_in_b": (ffn_in_b, f32, (di,)),
        "ffn_out_w": (ffn_out_w, f32, (di, dm)),
        "ffn_out_b": (ffn_out_b, f32, vec),
        "ln3_scale": (ln3_scale, f32, vec), "ln3_bias": (ln3_bias, f32, vec)},
        x.device, "ffn_epilogue")
    return _launch_ffn(x, (ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
                           ln3_scale, ln3_bias), di, eps)


def _launch_ffn(x, weights, d_inner, eps):
    """Launch #11/#13 on checked tensors, ``weights`` the entry point's
    six in order: the plan of :func:`_device_ffn`, the output and the
    scratch in one allocation."""
    b, _, dm = x.shape
    plan, ints = _device_ffn(x.device, b, dm, d_inner)
    buf = torch.empty(b * dm + plan.scratch, dtype=torch.float32,
                      device=x.device)
    err = _build.lib().ptt_ffn(
        x.data_ptr(), *(w.data_ptr() for w in weights), buf.data_ptr(),
        buf.data_ptr() + 4 * b * dm, b, dm, d_inner, *ints, float(eps),
        _build.stream_of(x))
    _build.check(err, "ffn")
    launches["ffn"] += 1
    return buf[:b * dm].view(b, 1, dm)


def _ffn_route(x, d_head):
    """The FFN half of a decoder step: :func:`ffn_epilogue`, or on CUDA at
    a head width % 64 != 0 its plain version (counted), since there the
    reference's megastep plan declines the whole step, FFN included.  The
    FFN has no head axis, so every other width launches it."""
    if x.device.type == "cuda" and d_head % 64:
        composed["ffn"] += 1
        return reference_ffn
    return ffn_epilogue


def fused_decode_step(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                      ln2_scale, ln2_bias, ffn_in_w, ffn_in_b, ffn_out_w,
                      ffn_out_b, ln3_scale, ln3_bias, cache_k, cache_v,
                      cross_k, cross_v, pos, lengths, cross_lengths,
                      active=None, *, layer, n_head, scale, eps=1e-5):
    """One decoder layer over a single embedded token, in the argument
    order of the reference's ``fused_decode_step``.  x [b, 1, d_model];
    wqkv [d_model, 3*h*dh]; wout/wcout [h*dh, d_model]; wcq
    [d_model, h*dh]; caches [L, b, rows, h, dh] (self cache updated in
    place); pos/lengths/cross_lengths [b] int32; active [b] 0/1 or None.
    Returns (out [b, 1, d_model], cache_k, cache_v)."""
    if active is None:
        active = torch.ones_like(pos)
    x = megastep(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
                 ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
                 cross_lengths, active, layer=layer, n_head=n_head,
                 scale=scale, eps=eps)
    out = _ffn_route(x, cache_k.shape[-1])(
        x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale, ln3_bias,
        eps)
    return out, cache_k, cache_v


def reference_decode_step_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq,
                                wcout, ln2_scale, ln2_bias, ffn_in_w,
                                ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale,
                                ln3_bias, cache_k, cache_v, cross_k,
                                cross_v, pos, lengths, cross_lengths,
                                self_table, cross_table, active=None, *,
                                layer, n_head, scale, eps=1e-5):
    """The whole decoder step over paged caches in plain PyTorch (the
    reference's ``reference_decode_step_paged``).  Returns
    (out [b, 1, d_model], cache_k, cache_v)."""
    if active is None:
        active = torch.ones_like(pos)
    x = reference_megastep_paged(
        x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
        ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
        cross_lengths, self_table, cross_table, active, layer=layer,
        n_head=n_head, scale=scale, eps=eps)
    out = reference_ffn(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
                        ln3_scale, ln3_bias, eps)
    return out, cache_k, cache_v


def fused_decode_step_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq,
                            wcout, ln2_scale, ln2_bias, ffn_in_w,
                            ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale,
                            ln3_bias, cache_k, cache_v, cross_k, cross_v,
                            pos, lengths, cross_lengths, self_table,
                            cross_table, active=None, *, layer, n_head,
                            scale, eps=1e-5):
    """One decoder layer over paged caches, in the argument order of the
    reference's ``fused_decode_step_paged``: :func:`megastep_paged`, then
    :func:`ffn_epilogue`.  Pools [L, num_blocks, block_t, h, dh] (the self
    pools updated in place); tables [b, max_blocks] int32.  Returns
    (out [b, 1, d_model], cache_k, cache_v)."""
    if active is None:
        active = torch.ones_like(pos)
    x = megastep_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                       ln2_scale, ln2_bias, cache_k, cache_v, cross_k,
                       cross_v, pos, lengths, cross_lengths, self_table,
                       cross_table, active, layer=layer, n_head=n_head,
                       scale=scale, eps=eps)
    out = _ffn_route(x, cache_k.shape[-1])(
        x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale, ln3_bias,
        eps)
    return out, cache_k, cache_v
