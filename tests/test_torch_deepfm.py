"""paddle_tpu_torch's DeepFM training step against the JAX package's, on the
CPU.

The reference's program is ``build_train_net(hash_dim=101,
embedding_size=4)`` with FLAGS at their defaults (``fused_embedding`` on:
its ``fused_lookup_table`` / ``fused_sparse_*`` ops), once with lazy Adam
(the bench's optimizer) and once with SGD, each built once per module.
Its startup scope goes into the port through
``load_paddle_tpu_deepfm_params``; both sides take 5 steps on one batch of
32 whose slots carry planted duplicates (rows 5-9 repeat row 0's ids, as
the reference's ``test_deepfm_train_step_parity`` plants them), on both of
the port's lookup routes (``fused_embedding`` True: the fused lookups;
False: the per-slot lookups); the optimizers group the tables on both.

Tolerances are the reference's own fused-against-per-slot ones
(``tests/test_fused_embedding.py``): rtol 2e-4 and atol 2e-5 on each
step's loss and AUC, and on every table, weight and moment after the
last step.  At lr 1e-3 SGD moves a table row by about 1e-6 in 5 steps,
far inside that allowance, so each tensor's change over the 5 steps is
also held to the reference's change: within UPDATE_RTOL of the largest
element of the reference's change.  A step that did nothing would be off
by 1, a step of the wrong sign by 2; the port is off by at most 7e-4
(SGD) and 4e-4 (Adam).
"""

import functools

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import framework as fw
from paddle_tpu.models import deepfm as D
from paddle_tpu_torch import (SGD, Adam, DeepFM, export_paddle_tpu_adam_state,
                              export_paddle_tpu_deepfm_params, kernels,
                              load_paddle_tpu_adam_state,
                              load_paddle_tpu_deepfm_params,
                              make_deepfm_batch)
from paddle_tpu_torch.models.deepfm import batch_tensors

HASH, EMB, BATCH, STEPS, LR = 101, 4, 32, 5, 1e-3
RTOL, ATOL = 2e-4, 2e-5
UPDATE_RTOL = 2e-3


def _batch():
    feed = D.make_batch(BATCH, hash_dim=HASH, rng=np.random.RandomState(0))
    for i in range(D.SPARSE_SLOTS):
        feed[f"C{i}"][5:10] = feed[f"C{i}"][0]
    return feed


class _Reference:
    """The reference program for one optimizer: its startup state, each
    step's loss and AUC, and its scope after the last step."""

    def __init__(self, optimizer):
        prog, startup = pt.Program(), pt.Program()
        with pt.program_guard(prog, startup):
            with fw.guard_unique_name():
                avg, auc_var, _, _ = D.build_train_net(
                    hash_dim=HASH, embedding_size=EMB, lr=LR,
                    optimizer=optimizer)
        self.ops = [op.type for op in prog.global_block().ops]
        self.params = [(p.name, tuple(p.shape))
                       for p in prog.global_block().all_parameters()]
        prog.random_seed = 7
        self.scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=self.scope)
        self.start = self.snapshot()
        self.losses, self.aucs = [], []
        for _ in range(STEPS):
            loss, a = exe.run(prog, feed=_batch(), fetch_list=[avg, auc_var],
                              scope=self.scope)
            self.losses.append(float(np.asarray(loss)))
            self.aucs.append(float(np.asarray(a)))
        self.end = self.snapshot()

    def snapshot(self):
        return {n: np.array(self.scope.find_var(n))
                for n in self.scope.local_var_names()
                if self.scope.find_var(n) is not None
                and (n.startswith("deepfm_") or n.startswith("auc_"))}


@functools.lru_cache(maxsize=None)
def _reference(optimizer):
    return _Reference(optimizer)


@pytest.fixture(params=["adam", "sgd"])
def ref(request):
    return request.param, _reference(request.param)


def _port(state, fused):
    model = DeepFM(EMB, HASH, fused_embedding=fused, device="cpu")
    return load_paddle_tpu_deepfm_params(model, state)


def test_param_names_and_ops_follow_the_reference(ref):
    """The port's parameters are the reference program's, name for name
    and shape for shape, in its order; the reference's graph is the fused
    one (two lookups, one grad each, two group updates)."""
    optimizer, r = ref
    model = DeepFM(EMB, HASH, device="cpu")
    assert [(n, tuple(p.shape)) for n, p in model.named_parameters()] == \
        r.params
    assert r.ops.count("fused_lookup_table") == 2
    assert r.ops.count(f"fused_sparse_{optimizer}") == 2


@pytest.mark.parametrize("fused", [True, False])
def test_five_steps_match_reference(ref, fused):
    """Five steps from the reference's startup state: each step's loss and
    AUC, then every parameter, the AUC histograms and (lazy Adam) every
    moment and beta pow, within the reference's A/B tolerances, and each
    one's change over the steps within UPDATE_RTOL of the reference's; no
    kernel launched on the CPU."""
    optimizer, r = ref
    model = _port(r.start, fused)
    if optimizer == "adam":
        opt = Adam(model.parameters(), learning_rate=LR, lazy_mode=True)
    else:
        opt = SGD(model.parameters(), learning_rate=LR)
    feed = batch_tensors(_batch(), "cpu")
    kernels.reset_launches()
    losses, aucs = [], []
    for _ in range(STEPS):
        loss, auc, predict = model(*feed)
        assert predict.shape == (BATCH, 2)
        opt.minimize(loss)
        losses.append(loss.item())
        aucs.append(auc.item())
    assert not any(kernels.launches.values())
    np.testing.assert_allclose(losses, r.losses, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aucs, r.aucs, rtol=RTOL, atol=ATOL)
    assert losses[-1] < losses[0]
    got = export_paddle_tpu_deepfm_params(model)
    if optimizer == "adam":
        got.update(export_paddle_tpu_adam_state(opt, model))
    for name in r.end:
        if name.startswith("auc_stat_"):
            got[name] = model.get_buffer(name.rsplit("_", 1)[0]).numpy()
    assert set(got) == set(r.end)
    for name, want in r.end.items():
        mine = got[name].reshape(want.shape)
        np.testing.assert_allclose(mine, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)
        start = r.start[name].astype(np.float64)
        change = want - start
        off = np.abs((mine - start) - change).max()
        assert off <= UPDATE_RTOL * np.abs(change).max(), (
            f"{name}: change off the reference's by {off}, its largest "
            f"element {np.abs(change).max()}")


def test_adam_state_round_trip():
    """load_paddle_tpu_adam_state puts the reference's lazy-Adam state
    where the port's Adam reads it, and export gives it back unchanged."""
    r = _reference("adam")
    model = _port(r.end, True)
    opt = Adam(model.parameters(), learning_rate=LR, lazy_mode=True)
    load_paddle_tpu_adam_state(opt, model, r.end)
    got = export_paddle_tpu_adam_state(opt, model)
    assert len(got) == 4 * len(r.params)
    for name, value in got.items():
        np.testing.assert_array_equal(value.reshape(r.end[name].shape),
                                      r.end[name])


def test_make_batch_gives_the_reference_arrays():
    for seed in (0, 3):
        want = D.make_batch(64, hash_dim=1000001,
                            rng=np.random.RandomState(seed))
        got = make_deepfm_batch(64, hash_dim=1000001,
                                rng=np.random.RandomState(seed))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_dense_gradients_route_through_scatter_add():
    """is_sparse=False: the fused route's dense table gradients (through
    #23's scatter-add twin) equal the per-slot route's.  Adam's non-lazy
    mode densifies a sparse gradient: on a first step from zero moments it
    moves the touched rows as lazy Adam does and leaves the others."""
    feed = batch_tensors(_batch(), "cpu")
    grads = []
    for fused in (True, False):
        model = DeepFM(EMB, HASH, is_sparse=False, fused_embedding=fused,
                       device="cpu").init_params(3)
        model(*feed)[0].backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert not g.is_sparse
        np.testing.assert_allclose(g.numpy(), grads[1][name].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)

    steps = []
    for lazy in (True, False):
        model = DeepFM(EMB, HASH, device="cpu").init_params(3)
        opt = Adam(model.parameters(), learning_rate=LR, lazy_mode=lazy)
        opt.minimize(model(*feed)[0])
        steps.append(model.deepfm_emb_0.detach().clone())
    touched = np.unique(feed[1][0].numpy())
    np.testing.assert_allclose(steps[0][touched].numpy(),
                               steps[1][touched].numpy(), rtol=1e-6)
    untouched = np.setdiff1d(np.arange(HASH), touched)
    np.testing.assert_array_equal(
        steps[0][untouched].numpy(),
        DeepFM(EMB, HASH, device="cpu").init_params(3)
        .deepfm_emb_0[untouched].detach().numpy())


def test_export_round_trip(ref):
    _, r = ref
    model = _port(r.start, True)
    out = export_paddle_tpu_deepfm_params(model)
    for name, _ in r.params:
        np.testing.assert_array_equal(out[name], r.start[name])
    with pytest.raises(KeyError, match="deepfm_out_b"):
        load_paddle_tpu_deepfm_params(
            DeepFM(EMB, HASH, device="cpu"),
            {k: v for k, v in out.items() if k != "deepfm_out_b"})
