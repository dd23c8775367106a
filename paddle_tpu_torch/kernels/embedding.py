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
``csrc/embedding.cu``), so the wrapper only sorts the ids (a stable
``torch.sort``) before the launch.  Ids outside [0, V), the merged
form's sentinel V among them, are dropped, as the reference's scatter
mode "drop" drops them.  The tables are updated in place (the port's
counterpart of the reference's aliased, donated buffers) and returned.

Each wrapper runs its plain twin (``reference_*``, the reference's
``*_xla`` forms) for CPU tensors; for CUDA tensors it launches its kernel
or raises.  Launches count under ``multi_table_gather`` and
``multi_table_apply``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, launches

#: slots a group may hold: the kernels take the table pointers by value
MAX_SLOTS = 64


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
    s_n, v, d = _group("multi_table_gather", tables, ids)
    b = ids.shape[1]
    out = torch.empty((s_n, b, d), dtype=torch.float32, device=ids.device)
    _build.check(_build.lib().ptt_table_gather(
        _pointers(tables), s_n, v, d, ids.data_ptr(), b, out.data_ptr(),
        _build.stream_of(ids)), "multi_table_gather")
    launches["multi_table_gather"] += 1
    return out


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


def _apply(mode, params, m1s, m2s, ids, rows, scale=0.0, lr_t=None,
           consts=(0.0, 0.0, 0.0, 0.0, 0.0)):
    """Launch #23 on the group: the ids stably sorted per slot, the kernel
    walking each run of equal ids."""
    what = "multi_table_apply"
    if ids.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {ids.device}")
    s_n, v, d = _group(what, params)
    if m1s:
        for kind in (m1s, m2s):
            if len(kind) != s_n or _group(what, kind) != (s_n, v, d):
                raise ValueError(f"{what}: the moments must match the "
                                 "params table for table")
        if len({t.data_ptr() for t in params + m1s + m2s}) != 3 * s_n:
            raise ValueError(f"{what}: params and moments must be "
                             "distinct buffers")
    k = ids.shape[1]
    _build.require({"ids": (ids, torch.int32, (s_n, k)),
                    "rows": (rows, torch.float32, (s_n, k, d))},
                   ids.device, what)
    sids, order = torch.sort(ids, dim=1, stable=True)
    lr_ptr = None
    if lr_t is not None:
        _build.require({"lr_t": (lr_t, torch.float32, (1,))}, ids.device,
                       what)
        lr_ptr = lr_t.data_ptr()
    _build.check(_build.lib().ptt_table_apply(
        mode, _pointers(params), _pointers(m1s) if m1s else None,
        _pointers(m2s) if m2s else None, s_n, v, d, sids.data_ptr(),
        order.data_ptr(), rows.data_ptr(), k, float(scale), lr_ptr, *consts,
        _build.stream_of(ids)), what)
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
