"""paddle_tpu_torch's ResNet training under bf16 amp against the JAX
package, on the CPU.

The reference's program is ``build_train_net(depth=50, class_dim=16,
image_shape=(3, 64, 64), data_format="NHWC", lr=1e-3)`` under
``pt.amp.enable`` (its cast policy at trace time: ``conv2d_bn`` casts its
input, filter and residual to bf16, the softmax and the loss run in f32),
with FLAGS at their defaults, so every ``conv_bn_layer`` is a fused
``conv2d_bn``.  It takes 2 Momentum steps on one batch of BATCH images
from its startup scope; the port's ``ResNet`` under ``amp.enable`` takes
the same steps from the same state, carried across by
``load_paddle_tpu_resnet_params`` (and the velocities by
``load_paddle_tpu_momentum_state``).  The flag-off program (conv2d,
batch_norm, elementwise_add) under ``pt.amp.enable`` is held against the
port's ``fused_bn=False`` route the same way.

The anchor is the reference's float64 step (the unfused program under
``jax.enable_x64``, no amp) from the state each amp step started from.
bf16 amp at this size and at initialization is far from it, on both sides
alike: 64 x 64 leaves 2 x 2 pixels to a stage-4 batch norm (32 rows at
BATCH 8), whose channels normalize a spread that bf16's rounding of y is
not small against (the amp losses are 9-14% off float64), and this step's
gradient is ill-conditioned: in float64 it moves smoothly, about 250
times a relative change of the image, until a change near 1e-8 flips a
ReLU, and the flips move the gradients of every layer before them by
0.5-0.9% (tools/torch_resnet_conditioning.py).  f32's roundings flip a
few (its gradient is 1-4% off float64, tests/test_torch_resnet.py),
bf16's many, so a bf16 gradient keeps each tensor's norm and a share of
its direction, never all of it.
Below the head (the classifier and the last batch norm's bias, which the
loss reaches through no batch norm) the port's amp update is 1.14 off the
reference's at the median and both are 1.3 off float64 (cosines 0.36 and
0.11): a bound on that distance would pass a zero update (1.0).  So each
update and velocity is held by what a zero update or one in another
direction fails (``_held``): against the reference's amp step, its norm
(TOL_AMP_NORM each, TOL_AMP_NORM_MEDIAN at the median), its direction
(the median cosine at least TOL_AMP_COS) and, at the head, the distance
itself (TOL_AMP_HEAD); against float64, the median cosine at least half
the reference's own and the head within TOL_AMP_HEAD.  The gradients'
norms are held against float64's by TOL_AMP_NORM and
TOL_AMP_NORM_MEDIAN, the running statistics (a forward quantity) within
TOL_AMP_STATS of the reference's at the median, each step's loss within
TOL_AMP_LOSS of the reference's amp loss.
"""

import contextlib
import functools

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import framework as fw
from paddle_tpu.flags import FLAGS
from paddle_tpu.models import resnet as R
from paddle_tpu_torch import (Momentum, ResNet, amp,
                              export_paddle_tpu_resnet_params, kernels,
                              load_paddle_tpu_momentum_state,
                              load_paddle_tpu_resnet_params)
from paddle_tpu_torch.interop import resnet_param_names

DEPTH, CLASSES, SIZE, BATCH, LR, STEPS = 50, 16, 64, 8, 1e-3, 2
#: each step's loss against the reference's amp loss, relative.  Both
#: sides' bf16 forwards sit 9-14% off the float64 loss here, mostly in
#: the same direction (they round the same y the same way), and 0.6-2%
#: off each other: their convolutions sum in other orders, and a y that
#: rounds to the other bf16 neighbour moves a stage-4 batch norm's few
#: rows (measured: steps 1 and 2 1.1e-2 and 6.4e-3)
TOL_AMP_LOSS = 5e-2
#: the running statistics after each step against the reference's, the
#: median over the tensors of ||port - ref|| / ||ref|| (measured: 2.7e-3,
#: 1.4e-3, flag-off 3.7e-3; the worst tensor, a stage-4 statistic over 32
#: rows, 0.13)
TOL_AMP_STATS = 1e-2
#: the port's flag-off route against the reference's flag-off program
#: under amp, the loss, relative.  XLA's CPU compiler keeps that program's
#: fused elementwise chains (the conv output into the batch norm's
#: arithmetic) in f32 where the program rounds to bf16
#: (``xla_allow_excess_precision``, on by default), the port rounds each
#: op: measured 6.6% apart, 2.1% with that flag off (the fused route's
#: Pallas kernels store their bf16 outputs, so it has no such gap)
TOL_AMP_FLAG_OFF_LOSS = 0.1
#: the port's two routes under amp, the loss, relative: the same ops in
#: bf16, the statistics summed in other orders (measured 2.8e-3)
TOL_AMP_ROUTES_LOSS = 1e-2
#: each update's and velocity's |norm / the reference's amp one's - 1|
#: (and each gradient's against float64's), and their median.  A zero
#: update reads 1.0.  Measured: against the reference's amp step at most
#: 0.23, 0.17 and 0.28 (step 1, step 2, the flag-off route), medians
#: 0.031, 0.022 and 0.026; the gradients against float64 at most 0.22,
#: median 0.023 (the reference's own: 0.33 and 0.021)
TOL_AMP_NORM, TOL_AMP_NORM_MEDIAN = 0.5, 0.08
#: the median over the updates and velocities of the cosine between the
#: port's and the reference's amp update.  A zero update reads 0, one in a
#: random direction 0 within 1 / sqrt(size).  Measured 0.36, 0.78 (step
#: 2 carries step 1's velocity) and 0.25
TOL_AMP_COS = 0.15
#: the head's updates and velocities (``HEAD``), relative distance, each
#: against the reference's amp step and against float64.  Measured at
#: most 0.19, 0.087 and 0.23 against the reference (step 1, step 2, the
#: flag-off route), 0.31, 0.16 and 0.31 against float64 (the reference's
#: own 0.31, 0.16, 0.31).  The median cosine with float64 is held to half
#: the reference's own (measured: the port 0.109, 0.615, 0.098; the
#: reference 0.112, 0.625, 0.119)
TOL_AMP_HEAD = 0.5
#: the tensors whose gradient the loss reaches through no batch norm: the
#: classifier's fc and the last conv + BN's shift (its scale's gradient
#: is a sum of g * x-hat over a stage-4 batch norm's 32 rows, whose x-hat
#: bf16 moves)
HEAD = ("fc_0.w_0", "fc_0.b_0", "batch_norm_52.b_0")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(BATCH, 3, SIZE, SIZE).astype(np.float32),
            "label": rng.randint(0, CLASSES, (BATCH, 1)).astype(np.int64)}


@contextlib.contextmanager
def _unfused():
    """FLAGS_fused_bn off while the block runs; the previous override (if
    any) comes back after it."""
    values = object.__getattribute__(FLAGS, "_values")
    had, prev = "fused_bn" in values, values.get("fused_bn")
    FLAGS.fused_bn = False
    try:
        yield
    finally:
        if had:
            FLAGS.fused_bn = prev
        else:
            FLAGS.reset("fused_bn")


def _build():
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with fw.guard_unique_name():
            out = R.build_train_net(
                depth=DEPTH, class_dim=CLASSES, image_shape=(3, SIZE, SIZE),
                data_format="NHWC", lr=LR)
    return prog, startup, out


def _set(scope, state, params, velocities, names, dtype=np.float32):
    for n in names:
        scope.set_var(n, state[n].astype(dtype))
    for v, p in zip(velocities, params):
        scope.set_var(v, state.get(v, np.zeros_like(state[p])).astype(dtype))


class _Reference:
    """The reference's amp program from its startup state: per step the
    loss, the dtype of predict and the snapshot of every parameter,
    running statistic and velocity; its flag-off amp program's step 1 from
    the same state; and the float64 step (the unfused program under
    ``jax.enable_x64``) from the state each amp step started from:
    ``exact[i]``, ``exact_losses[i]``, and its gradients ``exact_grads[i]``
    (the velocity of a step from zero velocities is the gradient)."""

    def __init__(self):
        exe = pt.Executor(pt.CPUPlace())
        self.prog, startup, (_, _, avg_cost, _, predict) = _build()
        ops = [op.type for op in self.prog.global_block().ops]
        assert ops.count("conv2d_bn") == 53 and "batch_norm" not in ops
        pt.amp.enable(self.prog)
        self.names = [n for n, _ in resnet_param_names(DEPTH)]
        self.params = [p.name for p in
                       self.prog.global_block().all_parameters()]
        self.velocities = [f"{n}_velocity_0" for n in self.params]
        self.scope = pt.Scope()
        exe.run(startup, scope=self.scope)
        self.start = self.snapshot(self.names)
        self.losses, self.after = [], []
        for _ in range(STEPS):
            loss, pred = exe.run(self.prog, feed=_batch(),
                                 fetch_list=[avg_cost, predict],
                                 scope=self.scope)
            self.predict_dtype = np.asarray(pred).dtype
            self.losses.append(float(np.asarray(loss)))
            self.after.append(self.snapshot(self.names + self.velocities))
        self.unfused_step(exe)
        self.float64_steps(exe)

    def unfused_step(self, exe):
        # the flag also chooses batch_norm's lowering when the step traces
        with _unfused():
            prog, startup, (_, _, avg_cost, _, _) = _build()
            ops = [op.type for op in prog.global_block().ops]
            assert "conv2d_bn" not in ops and ops.count("batch_norm") == 53
            pt.amp.enable(prog)
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            _set(scope, self.start, self.params, self.velocities, self.names)
            loss, = exe.run(prog, feed=_batch(), fetch_list=[avg_cost],
                            scope=scope)
        self.unfused_loss = float(np.asarray(loss))
        self.unfused_after = {n: np.array(scope.find_var(n))
                              for n in self.names + self.velocities}

    def float64_steps(self, exe):
        with _unfused(), jax.enable_x64(True):
            prog, startup, (_, _, avg_cost, _, _) = _build()
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            feed = _batch()
            feed["image"] = feed["image"].astype(np.float64)
            self.exact, self.exact_losses, self.exact_grads = [], [], []
            for state in [self.start] + self.after[:-1]:
                _set(scope, state, self.params, self.velocities, self.names,
                     np.float64)
                loss, = exe.run(prog, feed=feed, fetch_list=[avg_cost],
                                scope=scope)
                self.exact_losses.append(float(np.asarray(loss)))
                self.exact.append({n: np.array(scope.find_var(n)) for n in
                                   self.names + self.velocities})
                # v' = 0.9 v + g, so g = v' - 0.9 v
                self.exact_grads.append({
                    p: self.exact[-1][v] - 0.9 * state.get(
                        v, np.zeros_like(state[p]))
                    for p, v in zip(self.params, self.velocities)})

    def snapshot(self, names):
        return {n: np.array(self.scope.find_var(n)) for n in names}


@functools.lru_cache(maxsize=1)
def _reference():
    return _Reference()


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / max(np.linalg.norm(want), 1e-30))


def _moved(values, state, n):
    """What a step changed in ``n``: a velocity itself, else the update."""
    if n.endswith("_velocity_0"):
        return np.asarray(values[n], np.float64)
    return np.asarray(values[n], np.float64) - state[n]


def _amp_step(state, velocities=None, **kw):
    """One Momentum step of the port under amp (``ResNet(**kw)``) from the
    reference's ``state``: (loss, predict, {name: gradient}, {reference
    name: value after the step}, velocities included)."""
    model = load_paddle_tpu_resnet_params(
        ResNet(DEPTH, CLASSES, device="cpu", **kw), state)
    amp.enable(model)
    opt = Momentum(model.parameters(), learning_rate=LR, momentum=0.9)
    if velocities is not None:
        load_paddle_tpu_momentum_state(opt, model, velocities)
    feed = {k: torch.from_numpy(v) for k, v in _batch().items()}
    loss, _, predict = model(**feed)
    path = {p: n for n, p in model.named_parameters()}
    grads = {path[p]: g for p, g in opt.minimize(loss)}
    after = export_paddle_tpu_resnet_params(model)
    named = dict(model.named_parameters())
    for ref_name, p in resnet_param_names(DEPTH):
        if p in named:
            after[f"{ref_name}_velocity_0"] = (
                opt.state[named[p]]["velocity"].double().numpy())
    return loss, predict, grads, after


def _cos(a, b):
    """The cosine of the angle between two tensors; 0 where either is 0."""
    a = np.ravel(np.asarray(a, np.float64))
    b = np.ravel(np.asarray(b, np.float64))
    den = np.linalg.norm(a) * np.linalg.norm(b)
    return float(a @ b / den) if den else 0.0


def _norm_off(got, want):
    return abs(np.linalg.norm(np.asarray(got, np.float64))
               / np.linalg.norm(np.asarray(want, np.float64)) - 1)


def _readings(ref, step, state, got, want):
    """Per updated tensor and velocity of ``got`` (the port's step from
    ``state``) against ``want`` (the reference's amp step) and the float64
    step: {"norm": |norm ratio - 1| against want, "cos": cosine with want,
    "cos_f64" and "ref_cos_f64": the port's and the reference's cosine
    with float64, "head": {name: (distance to want, to float64)}}."""
    exact = ref.exact[step]
    trained = [n for n in ref.names
               if not n.endswith((".mean_0", ".var_0"))] + ref.velocities
    out = {"norm": [], "cos": [], "cos_f64": [], "ref_cos_f64": [],
           "head": {}}
    for n in trained:
        g, w, e = (_moved(v, state, n) for v in (got, want, exact))
        out["norm"].append(_norm_off(g, w))
        out["cos"].append(_cos(g, w))
        out["cos_f64"].append(_cos(g, e))
        out["ref_cos_f64"].append(_cos(w, e))
        if n.removesuffix("_velocity_0") in HEAD:
            out["head"][n] = (_rel(g, w), _rel(g, e))
    return out


def _held(ref, step, state, got, want):
    """The port's step against the reference's amp step (``want``) and
    the float64 step from ``state``, by bounds that a zero update and one
    in another direction fail: each update's and velocity's norm within
    TOL_AMP_NORM of want's, their median within TOL_AMP_NORM_MEDIAN, the
    median cosine with want at least TOL_AMP_COS, the median cosine with
    float64 at least half the reference's, and each head tensor within
    TOL_AMP_HEAD of want and of float64."""
    r = _readings(ref, step, state, got, want)
    assert max(r["norm"]) <= TOL_AMP_NORM, (step, max(r["norm"]))
    assert np.median(r["norm"]) <= TOL_AMP_NORM_MEDIAN, (
        step, np.median(r["norm"]))
    assert np.median(r["cos"]) >= TOL_AMP_COS, (step, np.median(r["cos"]))
    assert np.median(r["cos_f64"]) >= 0.5 * np.median(r["ref_cos_f64"]), (
        step, np.median(r["cos_f64"]), np.median(r["ref_cos_f64"]))
    assert len(r["head"]) == 2 * len(HEAD), sorted(r["head"])
    for n, dist in r["head"].items():
        assert max(dist) <= TOL_AMP_HEAD, (step, n, dist)


def _stats_held(ref, step, got, want):
    stats = [n for n in ref.names if n.endswith((".mean_0", ".var_0"))]
    errs = [_rel(got[n], want[n]) for n in stats]
    assert np.median(errs) <= TOL_AMP_STATS, (step, np.median(errs))


@pytest.fixture(scope="module")
def ref():
    return _reference()


def test_reference_amp_program_is_bf16_where_the_policy_says(ref):
    """The reference's amp program trains 161 parameters from the same
    names as the port, its predict is f32 (the softmax is BLACK), and its
    amp loss is not its float64 loss (the policy took effect)."""
    assert len(ref.params) == 161 and ref.predict_dtype == np.float32
    assert ref.losses[0] != pytest.approx(ref.exact_losses[0], rel=1e-5)


def test_two_amp_steps_match_reference(ref):
    """Step 1 from the reference's startup state and step 2 from its amp
    state after step 1 (its velocities loaded): the loss and predict f32,
    every gradient reaching Momentum f32, the loss within TOL_AMP_LOSS of
    the reference's amp loss, the running statistics within TOL_AMP_STATS
    (median), the updates and velocities against the reference's amp step
    and the float64 step by ``_held``, and no kernel launched on the
    CPU."""
    for step, (state, velocities) in enumerate(
            [(ref.start, None), (ref.after[0], ref.after[0])]):
        kernels.reset_launches()
        loss, predict, grads, got = _amp_step(state, velocities)
        assert not any(kernels.launches.values()), kernels.launches
        assert loss.dtype == predict.dtype == torch.float32
        assert predict.shape == (BATCH, CLASSES)
        assert all(g.dtype == torch.float32 for g in grads.values())
        assert abs(loss.item() - ref.losses[step]) <= TOL_AMP_LOSS * abs(
            ref.losses[step]), (step, loss.item(), ref.losses[step])
        _stats_held(ref, step, got, ref.after[step])
        _held(ref, step, state, got, ref.after[step])


def test_amp_gradient_norms_match_float64(ref):
    """Step 1's gradients keep float64's norms: each gradient's |norm
    ratio - 1| within TOL_AMP_NORM, their median within
    TOL_AMP_NORM_MEDIAN (a zero gradient reads 1.0)."""
    _, _, grads, _ = _amp_step(ref.start)
    exact = ref.exact_grads[0]
    names = dict((p, n) for n, p in resnet_param_names(DEPTH))
    off = {names[path]: _norm_off(g.double().numpy(), exact[names[path]])
           for path, g in grads.items()}
    assert len(off) == len(ref.params)
    worst = max(off, key=off.get)
    assert off[worst] <= TOL_AMP_NORM, (worst, off[worst])
    assert np.median(list(off.values())) <= TOL_AMP_NORM_MEDIAN, (
        np.median(list(off.values())))


@pytest.mark.parametrize("fault", ["zero", "negated", "shuffled"])
def test_bounds_refuse_a_wrong_update(ref, fault):
    """``_held`` refuses the reference's own amp step made wrong: no update
    (every parameter at its start, every velocity 0), the update negated,
    or each tensor's update shuffled (its norm kept, its direction
    another)."""
    rng = np.random.RandomState(0)
    state, want = ref.start, ref.after[0]
    bad = {}
    for n, v in want.items():
        moved = _moved(want, state, n)
        if fault == "zero":
            moved = np.zeros_like(moved)
        elif fault == "negated":
            moved = -moved
        else:
            moved = rng.permutation(moved.ravel()).reshape(moved.shape)
        bad[n] = moved if n.endswith("_velocity_0") else state[n] + moved
    _held(ref, 0, state, want, want)
    with pytest.raises(AssertionError):
        _held(ref, 0, state, bad, want)


def test_unfused_amp_step_matches_reference_flag_off_program(ref):
    """``fused_bn=False`` under amp (``conv2d`` WHITE, ``batch_norm`` in
    its input's dtype with f32 statistics, the residual's
    ``elementwise_add`` GRAY_FOLLOW) against the reference's flag-off
    program under ``pt.amp.enable`` from the same state: the loss within
    TOL_AMP_FLAG_OFF_LOSS of it and within TOL_AMP_ROUTES_LOSS of the
    port's fused route, the running statistics within TOL_AMP_STATS, the
    updates and velocities against the flag-off program's and the float64
    step by ``_held``; no kernel launched."""
    kernels.reset_launches()
    loss, predict, grads, got = _amp_step(ref.start, fused_bn=False)
    assert not any(kernels.launches.values()), kernels.launches
    assert predict.dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert abs(loss.item() - ref.unfused_loss) <= TOL_AMP_FLAG_OFF_LOSS * abs(
        ref.unfused_loss), (loss.item(), ref.unfused_loss)
    fused, _, _, _ = _amp_step(ref.start)
    assert abs(loss.item() - fused.item()) <= TOL_AMP_ROUTES_LOSS * abs(
        fused.item()), (loss.item(), fused.item())
    _stats_held(ref, 0, got, ref.unfused_after)
    _held(ref, 0, ref.start, got, ref.unfused_after)
