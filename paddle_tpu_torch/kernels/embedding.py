"""Multi-table embedding kernels of the sparse CTR tier: #22 and #23.

Counterpart of ``paddle_tpu/kernels/embedding.py``.  A table group is S
same-shape [V, D] f32 tables (DeepFM: 26 x [1000001, 10] and 26 x
[1000001, 1]), addressed by ids [S, B] int32, one row of ids per slot:

* :func:`multi_table_gather` (#22, ``csrc/embedding.cu``): out [S, B, D]
  with out[s, b] = table_s[ids[s, b]], in one launch; an id outside [0, V)
  gives a zero row and is never read;
* :func:`merge_slot_rows`: each slot's duplicate ids combined, the
  reference's batched MergeAdd, in plain PyTorch;
* :func:`multi_table_scatter_add`, :func:`multi_table_sparse_sgd` and
  :func:`multi_table_sparse_adam` (#23, the same source): the row-sparse
  applies, in place, in one launch for the group: ``table[id] += scale *
  row``, SGD (scale = -lr) and lazy Adam on param, m1 and m2.

The applies take ids and rows merged or not: the kernel merges each
slot's duplicates itself, summing each id's rows in a fixed order (see
``csrc/embedding.cu``).  #23 is one cooperative launch: one block a slot
sorts the slot's ids in shared memory and lists its runs of equal ids,
then, after a grid barrier, the runs are applied over the whole card, a
few lanes, a warp or a block a run by its length.  :func:`apply_plan` sizes
the launch from the shape and the card; :func:`apply_items` is the
device's split of the runs, in Python, for the tests.  Where a slot holds
more ids than a block sorts (SORT_MAX), the wrapper sorts them with
``torch.sort`` first and the launch only lists the runs.  Ids outside [0,
V), the merged form's sentinel V among them, are dropped, as the
reference's scatter mode "drop" drops them.  The tables are updated in
place (the port's counterpart of the reference's aliased, donated
buffers) and returned.

Each wrapper runs its plain twin (``reference_*``, the reference's
``*_xla`` forms) for CPU tensors; for CUDA tensors it launches its kernel
or raises.  Launches count under ``multi_table_gather`` and
``multi_table_apply``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _build, launches
from .attention import sm_count

#: slots a group may hold: the kernels take the table pointers by value
MAX_SLOTS = 64
#: threads a block of either kernel (``csrc/embedding.cu`` NT), and a warp's
THREADS, WARP = 512, 32
#: ids one block of #23 sorts (NT x kItems), and the bits a sort pass takes
SORT_MAX, DIGIT_BITS = 4096, 5
#: rows a warp item of #23 takes at most (longer runs are block items)
WARP_MAX = 32
#: rows a lane item of #23 takes at most, by table width (kernel
#: kShortMax): every other width's runs are warp or block items
SHORT_MAX = {1: 5, 10: 5}
#: the lane items a warp takes at once, by table width (RPW): 6 runs of 5
#: lanes (a float2 of 2 columns each) at D = 10, 32 of one lane at D = 1
LANE_RUNS_PER_WARP = {1: 32, 10: 6}
#: ints of one run record (kRec)
RUN_RECORD = 8


def _valid(ids, height):
    return (ids >= 0) & (ids < height)


# -- #22 ---------------------------------------------------------------------


def reference_multi_table_gather(tables, ids):
    """Plain twin of #22: [S, B, D] of each slot's rows, zero where an id
    lies outside [0, V)."""
    v = tables[0].shape[0]
    out = []
    for t, i in zip(tables, ids):
        ok = _valid(i, v)
        rows = t[torch.where(ok, i, 0).long()]
        out.append(torch.where(ok[:, None], rows, 0.0))
    return torch.stack(out)


def _group(what, tables, ids=None):
    """Raise unless ``tables`` is a group the kernels take: 1..MAX_SLOTS
    distinct contiguous f32 [V, D] tables on one CUDA device with V <
    2^31 (and ids a contiguous int32 [S, K] there); returns (S, V, D)."""
    s_n = len(tables)
    t0 = tables[0]
    if not 1 <= s_n <= MAX_SLOTS:
        raise ValueError(f"{what}: {s_n} tables, the kernel takes 1 to "
                         f"{MAX_SLOTS}")
    if t0.dim() != 2 or t0.shape[0] >= 2 ** 31 - 1:
        raise ValueError(f"{what}: tables must be [V, D] with V < 2^31, "
                         f"got {tuple(t0.shape)}")
    spec = {f"table {s}": (t, torch.float32, t0.shape)
            for s, t in enumerate(tables)}
    if ids is not None:
        spec["ids"] = (ids, torch.int32, (s_n, ids.shape[-1]))
    _build.require(spec, t0.device, what)
    if len({t.data_ptr() for t in tables}) != s_n:
        raise ValueError(f"{what}: the tables of a group must be distinct "
                         "buffers")
    return s_n, t0.shape[0], t0.shape[1]


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


#: checked groups: the tuple of their tables' addresses -> (S, V, D, dtype,
#: device, the pointer arrays); a few groups live at once (DeepFM: two
#: gathers, two applies)
_GROUPS = {}
_GROUPS_MAX = 16


def _checked_group(what, kinds, ids):
    """(S, V, D, pointer arrays) of a group of tables (``kinds``: the
    params, then the moments where there are some), checked as
    :func:`_group` checks them once per tuple of the tables' addresses:
    the kernels update them in place, so they never move.  The ids are
    checked on every call."""
    key = (what,) + tuple(t.data_ptr() for kind in kinds for t in kind)
    hit = _GROUPS.get(key)
    t0 = kinds[0][0]
    if hit is None or hit[3:5] != (t0.dtype, t0.device) or \
            hit[1:3] != tuple(t0.shape):
        s_n, v, d = _group(what, kinds[0])
        for kind in kinds[1:]:
            if len(kind) != s_n or _group(what, kind) != (s_n, v, d):
                raise ValueError(f"{what}: the moments must match the "
                                 "params table for table")
        if len(set(key[1:])) != len(key) - 1:
            raise ValueError(f"{what}: params and moments must be "
                             "distinct buffers")
        if len(_GROUPS) >= _GROUPS_MAX:
            _GROUPS.clear()
        hit = _GROUPS[key] = (s_n, v, d, t0.dtype, t0.device,
                              [_pointers(kind) for kind in kinds])
    s_n = hit[0]
    _build.require({"ids": (ids, torch.int32, (s_n, ids.shape[-1]))},
                   t0.device, what)
    return hit[0], hit[1], hit[2], hit[5]


def multi_table_gather(tables, ids):
    """#22: [S, B, D] with out[s, b] = tables[s][ids[s, b]] (a zero row for
    an id outside [0, V)).  tables: S same-shape [V, D] f32 tables; ids
    [S, B] int32.  CPU tensors take the plain twin; CUDA tensors launch the
    kernel or raise."""
    tables = list(tables)
    if ids.device.type == "cpu":
        return reference_multi_table_gather(tables, ids)
    if ids.device.type != "cuda":
        raise ValueError(f"multi_table_gather: no kernel for {ids.device}")
    return _launch_gather(tables, ids)


def _launch_gather(tables, ids):
    """Launch #22 on a checked group: one thread a (slot, id)."""
    s_n, v, d, (ptrs,) = _checked_group("multi_table_gather", [tables],
                                        ids)
    b = ids.shape[1]
    _check_32(s_n, b, d, "multi_table_gather")
    out = torch.empty((s_n, b, d), dtype=torch.float32, device=ids.device)
    _build.check(_build.lib().ptt_table_gather(
        ptrs, s_n, v, d, ids.data_ptr(), b, out.data_ptr(),
        _build.stream_of(ids)), "multi_table_gather")
    launches["multi_table_gather"] += 1
    return out


def _check_32(s_n, k, d, what):
    """The kernels index in 32 bits: S K D and the run records' S K
    RUN_RECORD ints stay below 2^31."""
    if s_n * k * max(d, RUN_RECORD) >= 2 ** 31 - 1:
        raise ValueError(f"{what}: {s_n} x {k} x {d} elements exceed the "
                         "kernels' 32-bit indexing")


# -- merge --------------------------------------------------------------------


def merge_slot_rows(ids, rows, height):
    """The reference's batched MergeAdd: ids [S, K], rows [S, K, D] ->
    (uids [S, K] int32, mrows [S, K, D]).  Each slot's unique ids come
    first, ascending, each with the sum of its rows; the tail holds the
    sentinel ``height`` and zero rows.

    Each sum runs left to right over the id's rows in their order in the
    slot (a stable sort), one pass per row of the longest run, with no
    atomics: the same sums on every device and run, the order #23 sums
    in (so on the card the twin and the kernel round alike)."""
    s_n, k = ids.shape
    sids, order = torch.sort(ids.to(torch.int32), dim=1, stable=True)
    srows = torch.gather(rows, 1, order[..., None].expand_as(rows))
    start = torch.ones_like(sids, dtype=torch.bool)
    start[:, 1:] = sids[:, 1:] != sids[:, :-1]
    seg = torch.cumsum(start.to(torch.int64), dim=1) - 1
    run = torch.bincount((seg + k * torch.arange(
        s_n, device=ids.device)[:, None]).reshape(-1))
    sums = torch.where(start[..., None], srows, 0.0)
    for t in range(1, int(run.max()) if k else 0):
        more = start[:, :k - t] & (sids[:, t:] == sids[:, :k - t])
        sums[:, :k - t] += torch.where(more[..., None], srows[:, t:], 0.0)
    # the run starts' sums to the front of their slot; the other rows to a
    # spare column that is dropped
    dest = torch.where(start, seg, k)
    mrows = rows.new_zeros((s_n, k + 1) + tuple(rows.shape[2:]))
    mrows.scatter_(1, dest[..., None].expand_as(sums), sums)
    uids = torch.full((s_n, k + 1), int(height), dtype=torch.int32,
                      device=ids.device).scatter_(1, dest, sids)
    return uids[:, :k], mrows[:, :k]


# -- #23 ---------------------------------------------------------------------


@torch.no_grad()
def reference_scatter_add(tables, ids, rows, scale):
    """Plain twin of #23's scatter-add mode, in place: each slot's rows
    merged (:func:`merge_slot_rows`), then ``table[uid] += scale * row``
    on the ids inside [0, V)."""
    v = tables[0].shape[0]
    uids, mrows = merge_slot_rows(ids, rows, v)
    for s, t in enumerate(tables):
        ok = _valid(uids[s], v)
        u = uids[s][ok].long()
        t[u] = t[u] + scale * mrows[s][ok]
    return tables


@torch.no_grad()
def reference_sparse_adam(params, m1s, m2s, ids, rows, lr_t, beta1, beta2,
                          epsilon):
    """Plain twin of #23's Adam mode, in place: the reference's
    ``multi_table_sparse_adam_xla`` (``_adam_one``'s sparse branch) on the
    merged rows: m1 = b1 m1 + (1 - b1) g, m2 = b2 m2 + (1 - b2) g^2, p -=
    lr_t m1 / (sqrt(m2) + eps) on the touched rows only."""
    v = params[0].shape[0]
    uids, mrows = merge_slot_rows(ids, rows, v)
    for s, (p, m1, m2) in enumerate(zip(params, m1s, m2s)):
        ok = _valid(uids[s], v)
        u = uids[s][ok].long()
        g = mrows[s][ok]
        m1r = beta1 * m1[u] + (1 - beta1) * g
        m2r = beta2 * m2[u] + (1 - beta2) * g.square()
        p[u] = p[u] - lr_t * m1r / (torch.sqrt(m2r) + epsilon)
        m1[u] = m1r
        m2[u] = m2r
    return params, m1s, m2s


class ApplyPlan(NamedTuple):
    """The launch of #23 (``csrc/embedding.cu``): ``sort``, the launch
    sorts each slot's ids itself (K <= SORT_MAX; else the wrapper's
    ``torch.sort`` does first); ``bits``, the bits of V (the sort's keys
    lie in [0, V], ids outside [0, V) taking V), sorted DIGIT_BITS bits
    a pass; ``grid`` co-resident blocks of THREADS threads;
    ``scratch`` ints: the run records, the sorted positions, the warp and
    block lists, the counts and (presorted) the run starts."""
    sort: bool
    bits: int
    grid: int
    scratch: int

    def digit_widths(self):
        """The sort's digits, least significant first."""
        return (DIGIT_BITS,) * -(-self.bits // DIGIT_BITS)

    def ints(self):
        """The plan's integers in the entry point's order."""
        return (int(self.sort), self.bits, self.grid)


def apply_plan(s, k, d, v, sms, blocks_per_sm):
    """#23's launch for S slots of K ids each over [V, D] tables on a card
    of ``sms`` SMs holding ``blocks_per_sm`` blocks each at once (the
    launch is cooperative): the grid is every block the card holds, at
    least one a slot (the sort phase).  Pure: the wrapper passes its
    integers to the entry point."""
    if not 1 <= s <= MAX_SLOTS or k < 0 or min(d, v, sms, blocks_per_sm) < 1:
        raise ValueError(f"apply_plan: no plan for {s} slots of {k} ids, "
                         f"[{v}, {d}] tables, {sms} SMs x {blocks_per_sm}")
    grid = sms * blocks_per_sm
    if grid < s:
        raise ValueError(f"apply_plan: {grid} co-resident blocks cannot sort "
                         f"{s} slots")
    return ApplyPlan(k <= SORT_MAX, int(v).bit_length(), grid,
                     s * (12 * k + 4))


def apply_items(plan, d, sids, height):
    """The device's split of #23's runs, in Python: ``sids`` [S, K] each
    slot's ids stably sorted (numpy; ids outside [0, height) anywhere,
    they form no run).  Returns [(kind, unit, slot, start, rows)] for
    every run of a valid id: ``kind`` "block" (more than WARP_MAX rows),
    "warp" (more than SHORT_MAX[d] rows) or "lanes" (a few lanes of a
    warp), ``unit`` the block or warp of the grid that applies it
    (numbered as the kernel's loops number them), ``start`` the run's
    first sorted index."""
    sids = np.asarray(sids)
    s_n, k = sids.shape
    smax = SHORT_MAX.get(d, 0)
    runs = []
    for s in range(s_n):
        keys = np.where((sids[s] >= 0) & (sids[s] < height), sids[s],
                        height)
        starts = [i for i in range(k) if keys[i] < height
                  and (i == 0 or keys[i] != keys[i - 1])]
        valid = int((keys < height).sum())
        runs.append([(st, nxt - st) for st, nxt in
                     zip(starts, starts[1:] + [valid])])
    items = []
    warps = plan.grid * THREADS // WARP
    n_block = n_warp = 0
    for s in range(s_n):
        # the warp and block lists: in each chunk of SORT_MAX runs, thread t
        # of the slot's block lists runs t, t + THREADS, ... in turn
        listed = sorted(range(len(runs[s])), key=lambda r: (
            r // SORT_MAX, r % THREADS, r % SORT_MAX // THREADS))
        for r in listed:
            st, n = runs[s][r]
            if n > WARP_MAX:
                items.append(("block", n_block % plan.grid, s, st, n))
                n_block += 1
            elif n > smax:
                items.append(("warp", n_warp % warps, s, st, n))
                n_warp += 1
            else:
                per_warp = LANE_RUNS_PER_WARP[d]
                items.append(("lanes", (s * k + r) // per_warp % warps, s,
                              st, n))
    return items


def device_apply_plan(device, mode, s, k, d, v):
    """:func:`apply_plan` as #23's wrapper launches it on ``device``: its
    SM count and the kernel's occupancy; made once a shape."""
    return _device_apply_plan(device, mode, s, k, d, v)


@functools.lru_cache(maxsize=64)
def _device_apply_plan(device, mode, s, k, d, v):
    per_sm = _build.lib().ptt_table_apply_occupancy(mode, d)
    if per_sm < 0:
        _build.check(-per_sm, "multi_table_apply occupancy")
    return apply_plan(s, k, d, v, sm_count(device), per_sm)


def _apply(mode, params, m1s, m2s, ids, rows, scale=0.0, lr_t=None,
           consts=(0.0, 0.0, 0.0, 0.0, 0.0)):
    """Launch #23 on the group (CUDA tensors): one cooperative launch that
    sorts each slot's ids (or takes them sorted by ``torch.sort`` where K
    exceeds SORT_MAX) and applies each run of equal ids."""
    what = "multi_table_apply"
    if ids.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {ids.device}")
    _launch_apply(mode, params, m1s, m2s, ids, rows, scale, lr_t, consts)


def _launch_apply(mode, params, m1s, m2s, ids, rows, scale, lr_t, consts):
    what = "multi_table_apply"
    kinds = [params, m1s, m2s] if m1s else [params]
    s_n, v, d, ptrs = _checked_group(what, kinds, ids)
    k = ids.shape[1]
    _check_32(s_n, k, d, what)
    _build.require({"rows": (rows, torch.float32, (s_n, k, d))},
                   ids.device, what)
    lr_ptr = None
    if lr_t is not None:
        _build.require({"lr_t": (lr_t, torch.float32, (1,))}, ids.device,
                       what)
        lr_ptr = lr_t.data_ptr()
    plan = device_apply_plan(ids.device, mode, s_n, k, d, v)
    keys, order = ids, None
    if not plan.sort:
        keys = torch.where((ids >= 0) & (ids < v), ids, v)
        keys, order = torch.sort(keys, dim=1, stable=True)
    scratch = torch.empty(plan.scratch, dtype=torch.int32,
                          device=ids.device)
    _build.check(_build.lib().ptt_table_apply(
        mode, ptrs[0], ptrs[1] if m1s else None, ptrs[2] if m1s else None,
        s_n, v, d, keys.data_ptr(), None if order is None
        else order.data_ptr(), rows.data_ptr(), k, scratch.data_ptr(),
        *plan.ints(), float(scale), lr_ptr, *consts, _build.stream_of(ids)),
        what)
    launches[what] += 1


def multi_table_scatter_add(tables, ids, rows, scale):
    """#23, scatter-add mode: ``tables[s][id] += scale * (sum of the rows
    of id in slot s)`` for every id of ids [S, K] int32 inside [0, V), in
    place; rows [S, K, D] f32, merged or not; ``scale`` a number.
    Returns the tables.  CPU tensors take the plain twin; CUDA tensors
    launch the kernel or raise."""
    tables = list(tables)
    if ids.device.type == "cpu":
        return reference_scatter_add(tables, ids, rows, scale)
    _apply(0, tables, [], [], ids, rows, scale=scale)
    return tables


def multi_table_sparse_sgd(params, ids, rows, lr):
    """#23, SGD mode: ``params[s][id] -= lr * row`` on the merged rows, in
    place (the reference's sgd SelectedRows kernel over the group)."""
    return multi_table_scatter_add(params, ids, rows, -float(lr))


def multi_table_sparse_adam(params, m1s, m2s, ids, rows, lr_t, beta1,
                            beta2, epsilon):
    """#23, lazy Adam mode, in place: on every id of ids [S, K] inside
    [0, V), with g the sum of its rows [S, K, D] (merged or not), m1 = b1
    m1 + (1 - b1) g, m2 = b2 m2 + (1 - b2) g^2 and p -= lr_t m1 / (sqrt(m2)
    + eps); rows no id touches keep their moments (the lazy contract).
    ``lr_t``, the bias-corrected rate, is a [1] f32 tensor on the tables'
    device (no host sync).  Returns (params, m1s, m2s).  CPU tensors take
    the plain twin; CUDA tensors launch the kernel or raise."""
    params, m1s, m2s = list(params), list(m1s), list(m2s)
    if ids.device.type == "cpu":
        return reference_sparse_adam(params, m1s, m2s, ids, rows, lr_t,
                                     beta1, beta2, epsilon)
    b1, b2 = float(beta1), float(beta2)
    _apply(1, params, m1s, m2s, ids, rows, lr_t=lr_t.reshape(1),
           consts=(b1, 1.0 - b1, b2, 1.0 - b2, float(epsilon)))
    return params, m1s, m2s
