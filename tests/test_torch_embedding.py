"""paddle_tpu_torch's multi-table embedding tier against the JAX package's,
on the CPU.

The plain twins of #22 (``multi_table_gather``) and #23 (the scatter-add,
SGD and lazy-Adam applies), ``merge_slot_rows``, ``SelectedRows``,
``lookup_table`` / ``fused_lookup_table`` with their row-sparse
gradients, and ``auc`` are held against ``paddle_tpu.kernels.embedding``
(its Pallas kernels in interpret mode with ``block_rows=8``, as the
reference's own kernel tests run them), ``paddle_tpu.core.selected_rows``
and a small reference program.  Every case has duplicate ids (runs of 3
and of 7 equal ids planted in each slot), and the applies also get ids
outside [0, V) and the merged form's sentinel tail; two table groups (D =
10 and D = 1) as DeepFM has them.

Tolerances: the gather copies rows, so it is exact; the merged sums and
the applies sum duplicates in the same (stable) order on both sides, and
are held to 1e-6.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import layers
from paddle_tpu.core import framework as fw
from paddle_tpu.core.selected_rows import SelectedRows as RefSelectedRows
from paddle_tpu.kernels import embedding as EK
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import embedding as K
from paddle_tpu_torch.ops import nn_ops
from paddle_tpu_torch.ops.metric_ops import auc
from paddle_tpu_torch.selected_rows import SelectedRows

S, V, B = 3, 37, 23
#: the reference's and the port's sums of the same rows in the same order
TOL = 1e-6


def _ids(rng, s=S, b=B, v=V):
    ids = rng.randint(0, v, (s, b)).astype(np.int32)
    ids[:, 4:7] = ids[:, 3:4]          # a run of 3 equal ids
    ids[:, 10:17] = ids[:, 0:1]        # and one of 7
    return ids


def _group(d, seed=0, s=S, b=B):
    rng = np.random.RandomState(seed)
    tables = [rng.randn(V, d).astype(np.float32) for _ in range(s)]
    rows = rng.randn(s, b, d).astype(np.float32)
    return tables, _ids(rng, s, b), rows


def _jnp(a):
    import jax.numpy as jnp

    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("d", [10, 1])
def test_gather_matches_reference_kernel(d):
    """#22's twin against the reference's Pallas gather (interpret mode):
    equal bits, out-of-range ids aside (the reference clips them; the port
    gives a zero row, below)."""
    tables, ids, _ = _group(d)
    want = EK.multi_table_gather([_jnp(t) for t in tables], _jnp(ids),
                                 block_rows=8, interpret=True)
    kernels.reset_launches()
    got = K.multi_table_gather([_t(t) for t in tables], _t(ids))
    assert not any(kernels.launches.values())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_out_of_range_ids_give_zero_rows():
    tables, ids, _ = _group(10)
    ids[1, 2], ids[2, 5] = V, -3
    got = K.multi_table_gather([_t(t) for t in tables], _t(ids)).numpy()
    assert not got[1, 2].any() and not got[2, 5].any()
    np.testing.assert_array_equal(got[0], tables[0][ids[0]])


@pytest.mark.parametrize("d", [10, 1])
def test_merge_matches_reference(d):
    """merge_slot_rows against the reference's: the same uids and
    sentinel tail, the summed rows to TOL."""
    _, ids, rows = _group(d)
    want_u, want_m = EK.merge_slot_rows(_jnp(ids), _jnp(rows), V)
    got_u, got_m = K.merge_slot_rows(_t(ids), _t(rows), V)
    assert got_u.dtype == torch.int32
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=TOL,
                               atol=TOL)


def _with_strays(ids):
    """Ids at or past V besides the duplicates: dropped by every apply.
    (A negative id is dropped by the port too, below; the reference's
    kernel does not define it.)"""
    ids = ids.copy()
    ids[0, 20], ids[1, 21], ids[2, 22] = V, V + 5, V
    return ids


def test_applies_drop_negative_ids():
    """A negative id is never written: the port's applies drop every id
    outside [0, V), as numpy's add.at over the ids inside it."""
    tables, ids, rows = _group(10, seed=6)
    ids[0, 2], ids[2, 9] = -1, -7
    got = K.multi_table_scatter_add([_t(t) for t in tables], _t(ids),
                                    _t(rows), 1.0)
    for s in range(S):
        want = tables[s].copy()
        ok = ids[s] >= 0
        np.add.at(want, ids[s][ok], rows[s][ok])
        np.testing.assert_allclose(got[s].numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [10, 1])
@pytest.mark.parametrize("merged", [False, True])
@pytest.mark.parametrize("mode", ["scatter_add", "sgd"])
def test_scatter_add_and_sgd_match_reference_kernel(mode, merged, d):
    """#23's scatter-add and SGD twins against the reference's Pallas
    apply (interpret mode) on its merged rows: the port takes the raw ids
    (duplicates and strays) or the merged ones with the sentinel tail and
    gives the same tables, updated in place."""
    tables, ids, rows = _group(d, seed=1)
    ids = _with_strays(ids)
    uids, mrows = EK.merge_slot_rows(_jnp(ids), _jnp(rows), V)
    ref = [_jnp(t) for t in tables]
    if mode == "sgd":
        want = EK.multi_table_sparse_sgd(ref, uids, mrows, 0.1,
                                         block_rows=8, interpret=True)
    else:
        want = EK.multi_table_scatter_add(ref, uids, mrows, _jnp(np.float32(
            0.5)), block_rows=8, interpret=True)
    port = [_t(t) for t in tables]
    args = (_t(uids), _t(mrows)) if merged else (_t(ids), _t(rows))
    if mode == "sgd":
        got = K.multi_table_sparse_sgd(port, *args, 0.1)
    else:
        got = K.multi_table_scatter_add(port, *args, 0.5)
    for s in range(S):
        assert got[s] is port[s]
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("d", [10, 1])
def test_sparse_adam_matches_reference_kernel(d):
    """#23's lazy-Adam twin against the reference's Pallas apply
    (interpret mode): params and both moments to TOL; rows no id touches
    keep their moments."""
    tables, ids, rows = _group(d, seed=2)
    ids = _with_strays(ids)
    rng = np.random.RandomState(3)
    m1s = [rng.rand(V, d).astype(np.float32) for _ in range(S)]
    m2s = [rng.rand(V, d).astype(np.float32) for _ in range(S)]
    uids, mrows = EK.merge_slot_rows(_jnp(ids), _jnp(rows), V)
    want = EK.multi_table_sparse_adam(
        [_jnp(a) for a in tables], [_jnp(a) for a in m1s],
        [_jnp(a) for a in m2s], uids, mrows, _jnp(np.float32(0.01)), 0.9,
        0.999, 1e-8, block_rows=8, interpret=True)
    port = [[_t(a) for a in kind] for kind in (tables, m1s, m2s)]
    got = K.multi_table_sparse_adam(*port, _t(ids), _t(rows),
                                    torch.tensor([0.01]), 0.9, 0.999, 1e-8)
    for kind_got, kind_want in zip(got, want):
        for g, w in zip(kind_got, kind_want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                       atol=TOL)
    touched = set(ids[0][(ids[0] >= 0) & (ids[0] < V)].tolist())
    for r in set(range(V)) - touched:
        np.testing.assert_array_equal(got[1][0][r].numpy(), m1s[0][r])


def test_wrappers_launch_or_raise_off_the_cpu():
    """No plain fallback off the CPU: a device with no kernel raises."""
    tables = [torch.zeros(4, 2, device="meta") for _ in range(2)]
    ids = torch.zeros(2, 3, dtype=torch.int32, device="meta")
    rows = torch.zeros(2, 3, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.multi_table_gather(tables, ids)
    with pytest.raises(ValueError, match="no kernel"):
        K.multi_table_scatter_add(tables, ids, rows, 1.0)


def test_selected_rows_matches_reference():
    """from_sparse / to_sparse keep the duplicates (nothing coalesced);
    merged() and to_dense() give the reference's."""
    _, ids, rows = _group(4)
    sr = SelectedRows(_t(ids[0]), _t(rows[0]), V)
    sp = sr.to_sparse()
    assert sp.is_sparse and not sp.is_coalesced()
    back = SelectedRows.from_sparse(sp)
    np.testing.assert_array_equal(back.ids.numpy(), ids[0])
    np.testing.assert_array_equal(back.rows.numpy(), rows[0])
    ref = RefSelectedRows(_jnp(ids[0]), _jnp(rows[0]), V)
    want_u, want_m = ref.merged()
    got_u, got_m = sr.merged()
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(sr.to_dense().numpy(),
                               np.asarray(ref.to_dense()), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("is_sparse", [True, False])
@pytest.mark.parametrize("padding_idx", [None, 5])
def test_fused_lookup_table_forward_and_gradients(is_sparse, padding_idx):
    """fused_lookup_table against S per-slot lookup_tables: the same rows
    (zero at padding_idx) and, for a random cotangent, the same gradient:
    row-sparse (uncoalesced sparse COO, the cotangent slices) with
    is_sparse, dense through the scatter-add otherwise, equal to numpy's
    add.at."""
    tables, ids, _ = _group(4, seed=4)
    if padding_idx is not None:
        ids[:, 1] = padding_idx
    cot = np.random.RandomState(5).randn(S, B, 4).astype(np.float32)
    fused = [torch.tensor(t, requires_grad=True) for t in tables]
    slots = [torch.tensor(t, requires_grad=True) for t in tables]
    ids_t = [_t(ids[s]).long()[:, None] for s in range(S)]   # [B, 1] each
    out = nn_ops.fused_lookup_table(fused, ids_t, padding_idx, is_sparse)
    per = torch.stack([nn_ops.lookup_table(t, i, padding_idx, is_sparse)
                       for t, i in zip(slots, ids_t)])
    np.testing.assert_array_equal(out.detach().numpy(),
                                  per.detach().numpy())
    (out * _t(cot)).sum().backward()
    (per * _t(cot)).sum().backward()
    for s in range(S):
        want = np.zeros((V, 4), np.float32)
        g = cot[s] * (ids[s] != padding_idx)[:, None]
        np.add.at(want, ids[s], g)
        for t in (fused[s], slots[s]):
            assert t.grad.is_sparse == is_sparse
            dense = t.grad.to_dense() if is_sparse else t.grad
            np.testing.assert_allclose(dense.numpy(), want, rtol=TOL,
                                       atol=TOL)
        if is_sparse:
            sr = SelectedRows.from_sparse(fused[s].grad)
            np.testing.assert_array_equal(sr.ids.numpy(), ids[s])
            np.testing.assert_array_equal(sr.rows.numpy(), g)


def test_auc_matches_reference_op():
    """auc against the reference's op over three batches: the histograms
    and the AUC after each."""
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with fw.guard_unique_name():
            pred = layers.data(name="pred", shape=[2], dtype="float32")
            label = layers.data(name="label", shape=[1], dtype="int64")
            auc_var, states = layers.auc(pred, label)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    stat_pos, stat_neg = torch.zeros(4096), torch.zeros(4096)
    rng = np.random.RandomState(0)
    for _ in range(3):
        p1 = rng.rand(64).astype(np.float32)
        feed = {"pred": np.stack([1 - p1, p1], 1),
                "label": (rng.rand(64, 1) < p1[:, None]).astype(np.int64)}
        want, = exe.run(prog, feed=feed, fetch_list=[auc_var], scope=scope)
        got = auc(_t(feed["pred"]), _t(feed["label"]), stat_pos, stat_neg)
        np.testing.assert_allclose(got.item(), float(np.asarray(want)),
                                   rtol=1e-6)
        for mine, var in zip((stat_pos, stat_neg), states):
            np.testing.assert_array_equal(
                mine.numpy(), np.asarray(scope.find_var(var.name)))


# -- #23's plan and the launches, without a card ------------------------------

PLAN_S, PLAN_K, PLAN_V = 3, 600, 1000
PLAN_MIXES = ("uniform", "planted", "zipf", "equal", "sentinel", "empty")


def _plan_ids(mix, seed=0, s=PLAN_S, k=PLAN_K, v=PLAN_V):
    """[S, K] int32 ids of one of PLAN_MIXES: uniform; planted runs of 6
    and 51 (a warp's and a block's at D = 10) with sentinels and a negative
    id; zipf(1.1) draws (a few runs of tens of rows); one id everywhere;
    the sentinel everywhere; no ids at all."""
    rng = np.random.RandomState(seed)
    if mix == "empty":
        return np.zeros((s, 0), np.int32)
    if mix == "uniform":
        ids = rng.randint(0, v, (s, k))
    elif mix == "planted":
        ids = rng.randint(0, v, (s, k))
        ids[:, 100:105] = ids[:, 0:1]
        ids[:, 200:250] = ids[:, 1:2]
        ids[:, -16:] = v
        ids[:, 7] = -4
    elif mix == "zipf":
        ids = (rng.zipf(1.1, (s, k)) - 1) % v
    elif mix == "equal":
        ids = np.full((s, k), 17)
    else:
        ids = np.full((s, k), v)
    return ids.astype(np.int32)


def _stable_sorted(ids, v):
    """Each slot's ids stably sorted with those outside [0, v) as v (the
    kernel's keys), and the positions they came from."""
    keys = np.where((ids >= 0) & (ids < v), ids, v)
    order = np.argsort(keys, axis=1, kind="stable")
    return np.take_along_axis(keys, order, 1), order


@pytest.mark.parametrize("sms", [2, 132])
@pytest.mark.parametrize("d", [1, 10])
@pytest.mark.parametrize("mix", PLAN_MIXES)
def test_apply_plan_covers_every_run(mix, d, sms):
    """apply_items (the kernel's split of #23's runs over lanes, warps
    and blocks) puts every run of a valid (slot, id) in exactly one item,
    of the kind its length calls for, on a unit of the plan's grid; and a
    float32 sum of each run's rows in the plan's order, left to right,
    is bit-equal to merge_slot_rows' sums."""
    ids = _plan_ids(mix)
    s_n, k = ids.shape
    rows = np.random.RandomState(1).randn(s_n, k, d).astype(np.float32)
    plan = K.apply_plan(s_n, k, d, PLAN_V, sms, 4)
    assert plan.sort and plan.grid == 4 * sms
    assert plan.scratch == s_n * (12 * k + 4)
    sids, order = _stable_sorted(ids, PLAN_V)
    items = K.apply_items(plan, d, sids, PLAN_V)
    seen = {}
    for kind, unit, s, st, n in items:
        assert (s, int(sids[s, st])) not in seen
        seen[(s, int(sids[s, st]))] = (kind, st, n)
        limit = plan.grid * (1 if kind == "block" else K.THREADS // 32)
        assert 0 <= unit < limit
        want_kind = ("block" if n > K.WARP_MAX else
                     "warp" if n > K.SHORT_MAX[d] else "lanes")
        assert kind == want_kind
    for s in range(s_n):
        ok = (ids[s] >= 0) & (ids[s] < PLAN_V)
        uniq, counts = np.unique(ids[s][ok], return_counts=True)
        assert {i for (t, i) in seen if t == s} == set(uniq.tolist())
        for i, c in zip(uniq, counts):
            assert seen[(s, int(i))][2] == c
    uids, mrows = K.merge_slot_rows(_t(ids), _t(rows), PLAN_V)
    uids, mrows = uids.numpy(), mrows.numpy()
    for (s, i), (kind, st, n) in seen.items():
        g = rows[s, order[s, st]].copy()
        for j in range(1, n):
            g = g + rows[s, order[s, st + j]]
        at = int(np.nonzero(uids[s] == i)[0][0])
        np.testing.assert_array_equal(g, mrows[s, at])


def _radix_model(keys, widths, threads=K.THREADS, items=K.SORT_MAX // K.THREADS):
    """The kernel's block sort in numpy: thread t holds items [16 t, 16 t +
    16); a pass ranks each thread's items by digit, scans the (digit,
    thread) counts digit-major and scatters.  Returns the positions in
    sorted order."""
    n = threads * items
    k = np.full(n, keys.max(initial=0) + 1, np.int64)
    k[:len(keys)] = keys
    v = np.arange(n)
    shift = 0
    for w in widths:
        dig = ((k >> shift) & ((1 << w) - 1)).reshape(threads, items)
        onehot = dig[..., None] == np.arange(1 << w)
        rank = (np.cumsum(onehot, 1) - onehot)[
            np.arange(threads)[:, None], np.arange(items), dig]
        counts = onehot.sum(1)                        # [threads, digits]
        flat = counts.T.reshape(-1)                   # digit-major
        offset = (np.cumsum(flat) - flat).reshape(1 << w, threads).T
        dst = offset[np.arange(threads)[:, None], dig] + rank
        nk, nv = np.empty_like(k), np.empty_like(v)
        nk[dst.reshape(-1)] = k
        nv[dst.reshape(-1)] = v
        k, v = nk, nv
        shift += w
    return v[:len(keys)]


@pytest.mark.parametrize("mix", PLAN_MIXES)
@pytest.mark.parametrize("k", [600, K.SORT_MAX])
def test_radix_sort_model_matches_stable_argsort(mix, k):
    """A numpy model of the launch's sort (a block's LSD radix passes at the
    plan's digit widths) gives np.argsort(kind="stable") of the keys."""
    ids = _plan_ids(mix, seed=2, k=k, v=1000001)
    plan = K.apply_plan(ids.shape[0], k, 10, 1000001, 132, 4)
    assert plan.digit_widths() == (5,) * 4
    keys, _ = _stable_sorted(ids, 1000001)
    raw = np.where((ids >= 0) & (ids < 1000001), ids, 1000001)
    for s in range(ids.shape[0]):
        got = _radix_model(raw[s], plan.digit_widths())
        np.testing.assert_array_equal(got, np.argsort(raw[s],
                                                      kind="stable"))


class _Recorder:
    """A stand-in for the kernel library that records each entry point's
    arguments (and, for #23, the keys and order it was handed)."""

    def __init__(self, per_sm=4):
        self.calls, self.per_sm = [], per_sm

    def ptt_table_apply_occupancy(self, mode, d):
        self.calls.append(("occupancy", mode, d))
        return self.per_sm

    def ptt_table_apply(self, *args):
        import ctypes

        s_n, k = args[4], args[10]
        keys = np.ctypeslib.as_array(
            (ctypes.c_int32 * (s_n * k)).from_address(args[7])).copy()
        order = None if args[8] is None else np.ctypeslib.as_array(
            (ctypes.c_int64 * (s_n * k)).from_address(args[8])).copy()
        self.calls.append(("apply", args, keys.reshape(s_n, k), order))
        return 0

    def ptt_table_gather(self, *args):
        self.calls.append(("gather", args))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    from paddle_tpu_torch.kernels import _build

    lib = _Recorder()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 7)
    monkeypatch.setattr(K, "sm_count", lambda device: 132)
    K._device_apply_plan.cache_clear()
    K._GROUPS.clear()
    kernels.reset_launches()
    yield lib
    K._device_apply_plan.cache_clear()
    K._GROUPS.clear()


@pytest.mark.parametrize("k", [600, K.SORT_MAX + 4])
@pytest.mark.parametrize("adam", [True, False])
def test_apply_launch_passes_the_plan_to_the_entry_point(recorder, adam, k):
    """#23's wrapper makes the plan from the shape, the card's SM count
    and the kernel's occupancy, and hands the entry point the group's
    pointers, the ids (K <= SORT_MAX: as given, the launch sorts them;
    beyond: stably sorted by torch.sort with those outside [0, V) as V,
    with their positions), the rows, the scratch and the plan's integers;
    one launch is counted."""
    d, v = 10, PLAN_V
    ids = _t(_plan_ids("planted", k=k))
    s_n = ids.shape[0]
    rows = torch.zeros(s_n, k, d)
    params = [torch.zeros(v, d) for _ in range(s_n)]
    m1s = [torch.zeros(v, d) for _ in range(s_n)]
    m2s = [torch.zeros(v, d) for _ in range(s_n)]
    lr = torch.tensor([0.5])
    consts = (0.9, 0.1, 0.999, 0.001, 1e-8)
    if adam:
        K._launch_apply(1, params, m1s, m2s, ids, rows, 0.0, lr, consts)
    else:
        K._launch_apply(0, params, [], [], ids, rows, -0.25, None,
                        (0.0,) * 5)
    (occ, mode, od), (what, args, keys, order) = recorder.calls
    assert (occ, mode, od) == ("occupancy", int(adam), d)
    plan = K.apply_plan(s_n, k, d, v, 132, recorder.per_sm)
    assert what == "apply" and args[0] == int(adam)
    assert list(args[1]) == [t.data_ptr() for t in params]
    if adam:
        assert list(args[2]) == [t.data_ptr() for t in m1s]
        assert list(args[3]) == [t.data_ptr() for t in m2s]
    else:
        assert args[2] is None and args[3] is None
    assert args[4:7] == (s_n, v, d)
    if plan.sort:
        assert args[7] == ids.data_ptr() and order is None
    else:
        want_keys, want_order = _stable_sorted(ids.numpy(), v)
        np.testing.assert_array_equal(keys, want_keys)
        np.testing.assert_array_equal(order.reshape(s_n, k), want_order)
    assert args[9] == rows.data_ptr() and args[10] == k
    assert args[12:15] == plan.ints()
    assert args[15] == (0.0 if adam else -0.25)
    assert args[16] == (lr.data_ptr() if adam else None)
    assert args[17:22] == (consts if adam else (0.0,) * 5)
    assert args[22] == 7
    assert kernels.launches["multi_table_apply"] == 1


def test_gather_launch_passes_the_group_to_the_entry_point(recorder):
    """#22's wrapper hands the entry point the group's pointers (checked
    and built once for the group's addresses: a second call reuses them),
    its shape, the ids and the output; each launch is counted."""
    d, v = 10, PLAN_V
    ids = _t(_plan_ids("uniform"))
    s_n, b = ids.shape
    tables = [torch.zeros(v, d) for _ in range(s_n)]
    out = K._launch_gather(tables, ids)
    again = K._launch_gather(tables, ids)
    (w1, args), (w2, args2) = recorder.calls
    assert w1 == w2 == "gather"
    assert list(args[0]) == [t.data_ptr() for t in tables]
    assert args2[0] is args[0]
    assert args[1:4] == (s_n, v, d)
    assert args[4] == ids.data_ptr() and args[5] == b
    assert args[6] == out.data_ptr() and args2[6] == again.data_ptr()
    assert args[7] == 7 and out.shape == (s_n, b, d)
    assert kernels.launches["multi_table_gather"] == 2
