"""Flash-decode: single-query attention over the ring cache or the paged
block pool.

Counterpart of ``paddle_tpu/kernels/decode_attention.py``:

* :func:`flash_decode` (``csrc/decode_attention.cu``, for
  ``_decode_kernel``): q [b, h, dh] against the first lengths[b] rows of
  one layer's ring cache k/v [b, max_t, h, dh];
* :func:`flash_decode_paged` (same source, for ``_paged_decode_kernel``):
  the same against one layer's pools [num_blocks, block_t, h, dh], row r
  of sequence i at block table[i, r // block_t], row r % block_t;
* :func:`paged_scatter_rows`: the paged cache write, the core of
  ``paged_kv_cache_update`` and of the composed paged decoder step.

Both kernels are one cooperative launch of the megastep's walk
(``csrc/decode_walk.cuh``) over the whole card: items of (group of heads,
sequence, split of rows) over the rows that exist, then, after a grid
barrier, the partials merged in split order.  :func:`decode_plan` picks
the group, the split and the grid from the shape and the card before the
launch; the entry points reject a plan they cannot run.  Both are
compiled for head widths 64 and 128 (launches at 128 counted under
``flash_decode_dh128`` and ``flash_decode_paged_dh128``); at 128 a group
of 8 heads does not fit a block's shared memory, so the plan takes 4 or
fewer.

The plain versions are :func:`reference_decode` and
:func:`reference_decode_paged`.  A lane with length 0 gets a zero context
in both, as in the TPU kernels (the reference's XLA twin spreads its
weight uniformly instead).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build, compiled_widths, composes, launches, width_suffix
from .attention import sm_count

#: cache rows a walk stages at once (``csrc/decode_walk.cuh`` CR); a walk
#: split is a multiple of it
WALK_CHUNK = 16
#: walk splits a sequence at most (MAX_SPLITS: a merge lane each)
WALK_MAX_SPLITS = 32
#: shared memory a block may opt into on the H100 (227 KB)
SMEM_CAP = 232448
#: shared memory of an SM (228 KB), and what each resident block reserves
SM_SMEM, BLOCK_RESERVED_SMEM = 233472, 1024
#: heads a flash-decode item may take (a block's warps), largest first
DECODE_GROUPS = (8, 4, 2, 1)
#: chunks in a flash-decode block's copy ring (``csrc/decode_attention.cu``
#: STAGES), which its shared memory holds
DECODE_STAGES = 2
#: warps an SM of the flash-decode grid, in eight-warp blocks' worth
DECODE_BLOCKS_PER_SM = 1


def walk_part(d_head):
    """Floats of one walk partial at this head width (``part_floats``:
    acc[d_head], m, l, padding)."""
    return d_head + 4


def walk_split(rows):
    """(split, splits) of a walk over a cache of ``rows`` rows a sequence:
    one chunk an item, so that the blocks' shares even out over many
    small items; longer where a sequence would need more than
    WALK_MAX_SPLITS."""
    chunks = -(-rows // WALK_CHUNK)
    split = -(-chunks // WALK_MAX_SPLITS) * WALK_CHUNK
    return split, -(-rows // split)


def walk_floats(d_head, group, stages, n_head, b):
    """Shared memory floats of a walk of head width ``d_head`` whose items
    take groups of at most ``group`` heads (as ``csrc/decode_walk.cuh``
    lays them out): ``stages`` chunks of k and v rows of a head group (8
    floats of padding a row), a q row each and the batch's prefix sum of
    splits (b + 1 ints)."""
    gw = min(n_head, group) * d_head
    return stages * (2 * WALK_CHUNK * (gw + 8) + gw) + b + 1


class DecodePlan(NamedTuple):
    """The work split of one flash-decode launch
    (``csrc/decode_attention.cu``).

    ``grid`` blocks of ``group`` warps, all co-resident; walk items of
    (``group`` heads, sequence, ``split`` rows, a multiple of
    WALK_CHUNK), ``splits`` splits a sequence; ``smem`` bytes of dynamic
    shared memory a block (a ring of DECODE_STAGES chunks); ``scratch``
    floats of partials [b, splits, h, walk_part(d_head)] behind the
    output."""
    group: int
    grid: int
    split: int
    splits: int
    smem: int
    scratch: int

    def ints(self):
        """The plan's integers in the entry points' order."""
        return (self.group, self.grid, self.split, self.smem)


def group_plan(group, b, n_head, rows, sms, blocks_per_sm, d_head=64):
    """(plan with items of ``group`` heads, its items), or None where
    such a block does not fit an SM: the grid as many blocks as the SMs
    hold (``blocks_per_sm`` eight-warp blocks' worth of warps an SM, and
    what their shared memory allows), cut to what the walk's items and
    the merge's (sequence, head) pairs can use."""
    split, splits = walk_split(rows)
    smem = 4 * walk_floats(d_head, group, DECODE_STAGES, n_head, b)
    per_sm = min(blocks_per_sm * 8 // group,
                 SM_SMEM // (smem + BLOCK_RESERVED_SMEM))
    if smem > SMEM_CAP or per_sm < 1:
        return None
    items = -(-n_head // group) * b * splits
    grid = min(sms * per_sm, max(items, -(-b * n_head // group)))
    return DecodePlan(group, grid, split, splits, smem,
                      b * splits * n_head * walk_part(d_head)), items


def decode_plan(b, n_head, rows, sms, blocks_per_sm, d_head=64):
    """Flash-decode's work split for a batch of ``b`` sequences of
    ``n_head`` heads of width ``d_head`` over caches of ``rows`` rows a
    sequence (ring: max_t; paged: max_blocks * block_t), on a card of
    ``sms`` SMs whose grid holds ``blocks_per_sm`` eight-warp blocks'
    worth of warps an SM (the launch is cooperative): the largest group of
    heads an item (8, 4, 2, 1) whose block fits (at 128 a group of 8
    heads' ring, 272 KB, does not) and whose items at full caches give
    every block of its grid at least two, else 1, so that a small batch
    still spreads over the card (:func:`group_plan`).  The lengths are not
    known on the host, so the group follows the caches' capacity.  Pure:
    the wrapper passes its integers to the entry point."""
    if min(b, n_head, rows, sms, blocks_per_sm) < 1 or (
            d_head not in compiled_widths("flash_decode")):
        raise ValueError(f"decode_plan: no plan for b {b}, {n_head} heads "
                         f"of {d_head}, {rows} rows, {sms} SMs x "
                         f"{blocks_per_sm}")
    for g in DECODE_GROUPS:
        fits = group_plan(g, b, n_head, rows, sms, blocks_per_sm, d_head)
        if fits is None:
            continue
        plan, items = fits
        if items >= 2 * plan.grid or g == DECODE_GROUPS[-1]:
            return plan
    raise ValueError(f"flash_decode: no plan fits b {b}, {n_head} heads of "
                     f"{d_head} in {SMEM_CAP} bytes of shared memory a "
                     f"block")


def device_decode_plan(device, paged, b, n_head, rows, d_head=64):
    """:func:`decode_plan` as :func:`flash_decode` and
    :func:`flash_decode_paged` launch it on ``device``: its SM count,
    DECODE_BLOCKS_PER_SM, the kernel's occupancy at the plan's shared
    memory checked; made once a shape."""
    return _device_plan(device, paged, b, n_head, rows, d_head)


@functools.lru_cache(maxsize=256)
def _device_plan(device, paged, b, n_head, rows, d_head):
    sms = sm_count(device)
    plan = decode_plan(b, n_head, rows, sms, DECODE_BLOCKS_PER_SM, d_head)
    per_sm = _build.lib().ptt_flash_decode_occupancy(
        int(paged), d_head, plan.group, plan.smem)
    if per_sm < 0:
        _build.check(-per_sm, "flash_decode occupancy")
    if per_sm * sms < plan.grid:
        raise RuntimeError(
            f"flash_decode: {plan.grid} blocks of {plan.group} warps do not "
            f"fit the card at once ({per_sm} an SM on {sms} SMs)")
    return plan


def reference_decode(q, k, v, lengths, scale=1.0):
    """Single-query attention: q [b, h, dh] against the first lengths[b]
    rows of k/v [b, max_t, h, dh]; f32 softmax.  A lane with length 0
    gets a zero context, as in the kernels."""
    max_t = k.shape[1]
    logits = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    valid = (torch.arange(max_t, device=q.device)[None, :]
             < lengths.long()[:, None])                      # [b, t]
    logits = logits.masked_fill(~valid[:, None, :], -1e30)
    w = torch.softmax(logits, dim=-1) * (lengths > 0).float()[:, None, None]
    return torch.einsum("bht,bthd->bhd", w, v.float()).to(q.dtype)


def reference_decode_paged(q, k_pool, v_pool, table, lengths, scale=1.0):
    """Plain paged walk: gather every sequence's table-addressed blocks
    into its logical [max_blocks * block_t] view and run
    :func:`reference_decode` on it.  Rows past a length never count, so
    whatever sits in unreferenced or trap blocks does not matter."""
    _, bt, h, dh = k_pool.shape
    b, mb = table.shape
    flat = table.reshape(-1).long()
    view_k = k_pool[flat].reshape(b, mb * bt, h, dh)
    view_v = v_pool[flat].reshape(b, mb * bt, h, dh)
    return reference_decode(q, view_k, view_v, lengths, scale)


def paged_scatter_rows(cache, new, table, pos, active, layer):
    """Write new [b, t, h, dh] into logical rows pos[b] .. pos[b]+t-1 of
    layer ``layer`` of the pool cache [L, num_blocks, block_t, h, dh], in
    place: row r of lane i lands at block table[i, r // block_t], row
    r % block_t.  Rows of lanes with ``active`` [b] == 0 (None: all
    active) and rows at or past max_blocks * block_t are dropped.

    Targets may repeat: joining lanes of a prefill all write the rows past
    their blocks into the trap block, which no length ever reads.  The
    dropped rows are routed, without a device-to-host sync, to the target
    of the first kept row and carry that row's value, so no dropped row can
    change what a kept one writes."""
    nb, bt, h, dh = cache.shape[1:]
    b, t = new.shape[:2]
    mb = table.shape[1]
    dev = cache.device
    rows = pos.reshape(-1, 1).long() + torch.arange(t, device=dev)
    blk = torch.gather(table.long(), 1, (rows // bt).clamp(0, mb - 1))
    flat = (blk * bt + rows % bt).reshape(-1)
    keep = rows < mb * bt
    if active is not None:
        keep = keep & (active.reshape(-1, 1) != 0)
    keep = keep.reshape(-1)
    vals = new.reshape(b * t, h, dh).to(cache.dtype)
    first = torch.argmax(keep.int())        # 0 when nothing is kept
    pool = cache[layer].view(nb * bt, h, dh)
    target = torch.where(keep, flat, flat[first])
    fill = torch.where(keep[first], vals[first], pool[flat[first]])
    pool[target] = torch.where(keep[:, None, None], vals, fill)


def _check_query(q, lengths, what):
    b, h, dh = q.shape
    if q.device.type != "cuda" or dh not in compiled_widths(what):
        raise ValueError(f"{what}: no kernel for q {tuple(q.shape)} on "
                         f"{q.device} (needs CUDA and d_head in "
                         f"{compiled_widths(what)})")
    return {"q": (q, torch.float32, (b, h, dh)),
            "lengths": (lengths, torch.int32, (b,))}


def _launch_decode(what, paged, q, args, geometry, rows, scale):
    """Launch #14 (ring) or #15 (paged) on checked tensors: ``args`` the
    entry point's tensors in order, ``geometry`` its cache integers after
    the batch, ``rows`` the rows a sequence the walk covers.  The output
    and the scratch are one allocation."""
    b, h, dh = q.shape
    plan = device_decode_plan(q.device, paged, b, h, rows, dh)
    buf = torch.empty(b * h * dh + plan.scratch, dtype=torch.float32,
                      device=q.device)
    lib = _build.lib()
    entry = lib.ptt_flash_decode_paged if paged else lib.ptt_flash_decode
    err = entry(*(a.data_ptr() for a in args), buf.data_ptr(),
                buf.data_ptr() + 4 * b * h * dh, b, *geometry, *plan.ints(),
                float(scale), _build.stream_of(q))
    _build.check(err, what)
    launches[what + width_suffix(dh)] += 1
    return buf[:b * h * dh].view(b, h, dh)


def flash_decode(q, k, v, lengths, scale=1.0):
    """Single-query attention against a length-masked ring cache slice.
    q [b, h, dh]; k/v [b, max_t, h, dh]; lengths [b] int32.  Returns
    [b, h, dh].  On CUDA the kernel at head widths 64 and 128, the plain
    walk at a width % 64 != 0 (the reference's plan declines the kernel
    there), an error at any other."""
    if q.device.type == "cpu" or composes("flash_decode", q.shape[-1]):
        return reference_decode(q, k, v, lengths, scale)
    b, h, dh = q.shape
    max_t = k.shape[1]
    spec = _check_query(q, lengths, "flash_decode")
    spec.update(k=(k, torch.float32, (b, max_t, h, dh)),
                v=(v, torch.float32, (b, max_t, h, dh)))
    _build.require(spec, q.device, "flash_decode")
    return _launch_decode("flash_decode", False, q, (q, k, v, lengths),
                          (max_t, h, dh), max_t, scale)


def flash_decode_paged(q, k_pool, v_pool, table, lengths, scale=1.0):
    """Single-query attention over one layer's paged pools.  q [b, h, dh];
    k_pool/v_pool [num_blocks, block_t, h, dh]; table [b, max_blocks]
    int32 pool block ids (trusted: the host allocator owns them); lengths
    [b] int32.  Returns [b, h, dh].  On CUDA at a head width % 64 != 0
    the plain walk, as :func:`flash_decode`."""
    if q.device.type == "cpu" or composes("flash_decode_paged",
                                          q.shape[-1]):
        return reference_decode_paged(q, k_pool, v_pool, table, lengths,
                                      scale)
    b, h, dh = q.shape
    nb, bt = k_pool.shape[:2]
    mb = table.shape[1]
    spec = _check_query(q, lengths, "flash_decode_paged")
    spec.update(k_pool=(k_pool, torch.float32, (nb, bt, h, dh)),
                v_pool=(v_pool, torch.float32, (nb, bt, h, dh)),
                table=(table, torch.int32, (b, mb)))
    _build.require(spec, q.device, "flash_decode_paged")
    return _launch_decode("flash_decode_paged", True, q,
                          (q, k_pool, v_pool, table, lengths),
                          (h, dh, nb, bt, mb), mb * bt, scale)
