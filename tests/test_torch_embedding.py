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
