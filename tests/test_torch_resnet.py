"""paddle_tpu_torch's ResNet training against the JAX package, on the CPU.

The reference's program is ``build_train_net(depth=50, class_dim=16,
image_shape=(3, 64, 64), data_format="NHWC", lr=1e-3)`` with FLAGS at
their defaults, so every ``conv_bn_layer`` is a fused ``conv2d_bn`` (53 of
them) and the optimizer is Momentum(1e-3, 0.9).  It is built once per
module and takes 2 steps on one batch of 2; its startup scope goes into
the port through ``load_paddle_tpu_resnet_params``, and the port's
``ResNet`` with ``Momentum`` takes the same steps.  64x64 keeps 8 rows
behind each of stage 4's batch norms (2 x 2 x 2).  The learning rate is
small because at the reference's 0.1 the second step's loss already sits
at the cross entropy's clip, -log(1e-12).

The float64 anchor is the reference too: the same program with
FLAGS_fused_bn off (its conv2d + batch_norm composition, which holds no
f32 kernel) run under ``jax.enable_x64`` from the same state.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import layers
from paddle_tpu.core import framework as fw
from paddle_tpu.flags import FLAGS
from paddle_tpu.models import resnet as R
from paddle_tpu_torch import (Momentum, ResNet,
                              export_paddle_tpu_resnet_params, kernels,
                              load_paddle_tpu_momentum_state,
                              load_paddle_tpu_resnet_params)
from paddle_tpu_torch.interop import resnet_param_names

DEPTH, CLASSES, SIZE, BATCH, LR, STEPS = 50, 16, 64, 2, 1e-3, 2
#: each step's loss against the reference's, relative: f32, 53 batch
#: norms deep (measured at step 1: the port 1.1e-5 and the reference 1.6e-5
#: off the port's float64 loss)
TOL_LOSS = 1e-4
#: running statistics after each step against the reference's, relative
#: per tensor (||port - ref|| / ||ref||): the forward alone, but var =
#: E[y^2] - mean^2 in f32 cancels where the mean is large (measured 1.0e-4
#: at step 1, 3.3e-5 at step 2)
TOL_STATS = 5e-4
#: the port's float64 step against the reference's float64 step from the
#: same state, relative per tensor: the loss, and what the step changed
#: (each parameter's and running statistic's update, each velocity).
#: Two float64 evaluations of one step, in other orders of summation
#: (measured: the loss 2.5e-13, the tensors at most 4.7e-12)
TOL_F64 = 1e-9
#: the f32 updates and velocities of each step.  At batch 2 this network's
#: gradient is ill-conditioned in f32: the batch norms near the loss
#: normalize a few rows whose spread is mostly between the two images, and
#: their backward cancels.  The reference's f32 gradients are 0.4-3.8% off
#: a float64 evaluation of the same step, the port's f32 ones 1.3e-5-4.7%
#: (medians 2.1% and 3.5%; measured), so an f32 comparison at 1e-4 is out
#: of reach for either.  Both are held against the reference's float64
#: step instead (which TOL_F64 ties to the port's): each tensor's update
#: within TOL_F32 of it, and the median over the tensors within
#: TOL_F32_MEDIAN.  A direct bound between the two f32 sides by the sum of
#: their distances to float64 would add nothing: the triangle inequality
#: gives it.  A wrong wiring is off by O(1)
TOL_F32, TOL_F32_MEDIAN = 0.1, 0.05


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


def _build(depth):
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with fw.guard_unique_name():
            out = R.build_train_net(
                depth=depth, class_dim=CLASSES, image_shape=(3, SIZE, SIZE),
                data_format="NHWC", lr=LR)
    return prog, startup, out


def _moved(values, state, n):
    """What a step changed in ``n``: a velocity itself, else the update
    (after - before)."""
    if n.endswith("_velocity_0"):
        return np.asarray(values[n], np.float64)
    return np.asarray(values[n], np.float64) - state[n]


class _Reference:
    """The reference program, its startup state and, after each of its
    STEPS steps on ``_batch()``, the loss and the snapshot of every
    parameter, running statistic and velocity; then its ``is_test`` clone
    on the final state (loss and predict).  ``exact[i]`` and
    ``exact_losses[i]`` are step i of the unfused program in float64 from
    the state the f32 step i started from."""

    def __init__(self):
        self.prog, startup, (_, _, avg_cost, acc, predict) = _build(DEPTH)
        ops = [op.type for op in self.prog.global_block().ops]
        assert ops.count("conv2d_bn") == 53 and "batch_norm" not in ops
        self.names = [n for n, _ in resnet_param_names(DEPTH)]
        self.params = [p.name for p in
                       self.prog.global_block().all_parameters()]
        self.velocities = [f"{n}_velocity_0" for n in self.params]
        self.scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup, scope=self.scope)
        self.start = self.snapshot(self.names)
        self.losses, self.accs, self.after = [], [], []
        for _ in range(STEPS):
            loss, a = exe.run(self.prog, feed=_batch(),
                              fetch_list=[avg_cost, acc], scope=self.scope)
            self.losses.append(float(np.asarray(loss)))
            self.accs.append(float(np.asarray(a).reshape(())))
            self.after.append(self.snapshot(self.names + self.velocities))
        test_prog = self.prog.clone(for_test=True)
        loss, pred = exe.run(test_prog, feed=_batch(seed=1),
                             fetch_list=[avg_cost, predict],
                             scope=self.scope)
        self.eval_loss, self.eval_predict = float(np.asarray(loss)), pred
        self.float64_steps(exe)

    def float64_steps(self, exe):
        with _unfused(), jax.enable_x64(True):
            prog, startup, (_, _, avg_cost, _, _) = _build(DEPTH)
            ops = [op.type for op in prog.global_block().ops]
            assert "conv2d_bn" not in ops and ops.count("batch_norm") == 53
            assert [p.name for p in
                    prog.global_block().all_parameters()] == self.params
            scope = pt.Scope()
            exe.run(startup, scope=scope)
            # the program's learning rate is an f32 variable
            momentum = next(op for op in prog.global_block().ops
                            if op.type == "momentum")
            self.lr = np.asarray(scope.find_var(
                momentum.input("LearningRate")[0])).item()
            feed = _batch()
            feed["image"] = feed["image"].astype(np.float64)
            self.exact, self.exact_losses = [], []
            for state in [self.start] + self.after[:-1]:
                for n in self.names:
                    scope.set_var(n, state[n].astype(np.float64))
                for n, p in zip(self.velocities, self.params):
                    v = state.get(n, np.zeros_like(self.start[p]))
                    scope.set_var(n, v.astype(np.float64))
                loss, = exe.run(prog, feed=feed, fetch_list=[avg_cost],
                                scope=scope)
                assert np.asarray(loss).dtype == np.float64
                self.exact_losses.append(float(np.asarray(loss)))
                self.exact.append({n: np.array(scope.find_var(n)) for n in
                                   self.names + self.velocities})

    def snapshot(self, names):
        return {n: np.array(self.scope.find_var(n)) for n in names}


@pytest.fixture(scope="module")
def ref():
    return _Reference()


def _feed(seed=0):
    return {k: torch.from_numpy(v) for k, v in _batch(seed).items()}


def _port(state, **kw):
    model = ResNet(DEPTH, CLASSES, device="cpu", **kw)
    return load_paddle_tpu_resnet_params(model, state)


def _rel(got, want):
    return (np.linalg.norm(np.asarray(got, np.float64) - want)
            / max(np.linalg.norm(want), 1e-30))


def _velocities(opt, model):
    named = dict(model.named_parameters())
    return {f"{ref_name}_velocity_0":
            opt.state[named[path]]["velocity"].double().numpy()
            for ref_name, path in resnet_param_names(DEPTH) if path in named}


def _step(state, dtype, velocities=None, lr=LR, **kw):
    """One Momentum step of the port (``ResNet(**kw)``) from the
    reference's ``state`` (and its velocities, when given) in ``dtype``:
    (loss, {reference name: value after the step}), velocities
    included."""
    model = _port(state, **kw).to(dtype)
    opt = Momentum(model.parameters(), learning_rate=lr, momentum=0.9)
    if velocities is not None:
        load_paddle_tpu_momentum_state(opt, model, velocities)
    feed = _feed()
    loss, acc, predict = model(feed["image"].to(dtype), feed["label"])
    assert predict.shape == (BATCH, CLASSES)
    opt.minimize(loss)
    after = export_paddle_tpu_resnet_params(model)
    after.update(_velocities(opt, model))
    return loss.item(), acc.item(), after


def _held(ref, step, state, velocities=None):
    """The port's step ``step`` from ``state`` against the reference's:
    the loss and accuracy, the running statistics directly, the port's
    float64 step against the reference's within TOL_F64, and the f32
    updates and velocities of both sides against the reference's float64
    step."""
    kernels.reset_launches()
    loss, acc, got = _step(state, torch.float32, velocities)
    assert not any(kernels.launches.values()), kernels.launches
    want = ref.after[step]
    assert abs(loss - ref.losses[step]) <= TOL_LOSS * abs(
        ref.losses[step]), (step, loss, ref.losses[step])
    assert acc == ref.accs[step]
    stats = [n for n in ref.names if n.endswith((".mean_0", ".var_0"))]
    worst = max((_rel(got[n], want[n]), n) for n in stats)
    assert worst[0] <= TOL_STATS, (step, worst)

    exact, exact_loss = ref.exact[step], ref.exact_losses[step]
    loss64, _, port64 = _step(state, torch.float64, velocities, lr=ref.lr)
    assert abs(loss64 - exact_loss) <= TOL_F64 * abs(exact_loss), (
        step, loss64, exact_loss)
    worst = max((_rel(_moved(port64, state, n), _moved(exact, state, n)), n)
                for n in ref.names + ref.velocities)
    assert worst[0] <= TOL_F64, (step, worst)

    trained = [n for n in ref.names if n not in stats] + ref.velocities
    for side, values in (("port", got), ("reference", want)):
        errs = [(_rel(_moved(values, state, n), _moved(exact, state, n)), n)
                for n in trained]
        assert max(errs)[0] <= TOL_F32, (step, side, max(errs))
        assert np.median([e for e, _ in errs]) <= TOL_F32_MEDIAN, (step,
                                                                   side)


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
def test_param_names_follow_the_reference_draw_order(depth):
    """resnet_param_names lists exactly the reference program's
    parameters (in its order) and running statistics, each with the
    shape of the port's tensor at that path: the shortcut's layer comes
    before conv1 in each stage's first block."""
    prog, _, _ = _build(depth)
    block = prog.global_block()
    params = [p.name for p in block.all_parameters()]
    stats = {v.name for v in prog.list_vars() if v.persistable
             and v.name.endswith((".mean_0", ".var_0"))}
    pairs = resnet_param_names(depth)
    names = [n for n, _ in pairs]
    assert [n for n in names if n in set(params)] == params
    assert set(names) == set(params) | stats
    model = ResNet(depth, CLASSES, device="cpu")
    tensors = dict(model.named_parameters()) | dict(model.named_buffers())
    assert set(tensors) == {path for _, path in pairs}
    for name, path in pairs:
        assert tuple(block.var(name).shape) == tuple(tensors[path].shape), \
            name


def test_two_momentum_steps_match_reference(ref):
    """Step 1 from the reference's startup state and step 2 from its
    state after step 1 (its velocities loaded): each step's loss within
    TOL_LOSS, running statistics within TOL_STATS, the port's float64
    step within TOL_F64 of the reference's, and the f32 updates and
    velocities of both sides under TOL_F32 against the reference's
    float64 step; no kernel launched on the CPU.  (The port's own second step is not compared: at batch 2
    the f32 noise of step 1's gradient moves step 2's loss by percents on
    either side, the reference's included.)"""
    _held(ref, 0, ref.start)
    _held(ref, 1, ref.after[0], velocities=ref.after[0])


@pytest.mark.parametrize("kw", [dict(data_format="NCHW"),
                                dict(fused_bn=False)],
                         ids=["nchw", "nhwc_unfused"])
def test_unfused_routes_match_reference_float64_program(ref, kw):
    """``data_format="NCHW"`` and ``fused_bn=False`` train through the
    reference's unfused composition (conv2d, batch_norm, elementwise_add):
    step 1 in float64 within TOL_F64 of the reference's unfused program
    under ``jax.enable_x64`` from the same state (loss, every update and
    velocity), and the f32 step's updates and velocities under TOL_F32 and
    TOL_F32_MEDIAN against it, as the fused route is held; no kernel
    launched, and the f32 loss within TOL_LOSS of the reference's."""
    kernels.reset_launches()
    loss, _, got = _step(ref.start, torch.float32, **kw)
    assert not any(kernels.launches.values())
    assert abs(loss - ref.losses[0]) <= TOL_LOSS * abs(ref.losses[0])
    exact, exact_loss = ref.exact[0], ref.exact_losses[0]
    loss64, _, port64 = _step(ref.start, torch.float64, lr=ref.lr, **kw)
    assert abs(loss64 - exact_loss) <= TOL_F64 * abs(exact_loss)
    worst = max((_rel(_moved(port64, ref.start, n),
                      _moved(exact, ref.start, n)), n)
                for n in ref.names + ref.velocities)
    assert worst[0] <= TOL_F64, worst
    stats = {n for n in ref.names if n.endswith((".mean_0", ".var_0"))}
    errs = [(_rel(_moved(got, ref.start, n), _moved(exact, ref.start, n)), n)
            for n in [n for n in ref.names if n not in stats]
            + ref.velocities]
    assert max(errs)[0] <= TOL_F32, max(errs)
    assert np.median([e for e, _ in errs]) <= TOL_F32_MEDIAN


def test_resume_from_reference_momentum_state(ref):
    """load_paddle_tpu_momentum_state puts the reference's velocities
    where the port's Momentum reads them: after loading the state of step
    1, every velocity equals the reference's, and a step with a zero
    gradient moves each parameter by lr * mu * v exactly as the
    reference's ``momentum`` op would."""
    model = _port(ref.after[0])
    opt = Momentum(model.parameters(), learning_rate=LR, momentum=0.9)
    load_paddle_tpu_momentum_state(opt, model, ref.after[0])
    got = _velocities(opt, model)
    assert got.keys() == set(ref.velocities)
    for name in ref.velocities:
        np.testing.assert_array_equal(got[name], ref.after[0][name])
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    named = dict(model.named_parameters())
    for ref_name, path in resnet_param_names(DEPTH):
        if path in named:
            v = torch.from_numpy(ref.after[0][f"{ref_name}_velocity_0"])
            want = before[path] - LR * (0.9 * v)
            assert torch.equal(named[path].detach(), want), ref_name


def test_export_round_trip(ref):
    """export gives the reference's names and arrays back unchanged, and
    a model loaded from it holds the same tensors; a missing name
    raises."""
    model = _port(ref.start)
    out = export_paddle_tpu_resnet_params(model)
    assert out.keys() == ref.start.keys()
    for name, value in out.items():
        np.testing.assert_array_equal(value, ref.start[name])
    again = _port(out)
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(a, b), n
    with pytest.raises(KeyError, match="batch_norm_0.var_0"):
        load_paddle_tpu_resnet_params(
            ResNet(DEPTH, CLASSES, device="cpu"),
            {k: v for k, v in out.items() if k != "batch_norm_0.var_0"})
    opt = Momentum(model.parameters(), learning_rate=LR, momentum=0.9)
    with pytest.raises(KeyError, match="velocity"):
        load_paddle_tpu_momentum_state(opt, model, {})


def test_eval_matches_is_test_program(ref):
    """model.eval() takes the composition over the running statistics:
    on the reference's final state, the loss and predict of another
    batch against its ``clone(for_test=True)``; the statistics stay."""
    model = _port(ref.after[-1]).eval()
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        loss, _, predict = model(**_feed(seed=1))
    assert abs(loss.item() - ref.eval_loss) <= TOL_LOSS * abs(ref.eval_loss)
    np.testing.assert_allclose(predict.numpy(), ref.eval_predict,
                               rtol=1e-4, atol=1e-6)
    for n, b in model.named_buffers():
        assert torch.equal(b, before[n]), n


def _momentum_program(use_nesterov):
    prog, startup = pt.Program(), pt.Program()
    with pt.program_guard(prog, startup):
        with fw.guard_unique_name():
            x = layers.data(name="x", shape=[8], dtype="float32")
            loss = layers.mean(layers.fc(x, size=4, bias_attr=False))
            pt.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                  use_nesterov=use_nesterov).minimize(loss)
    return prog, startup, loss


@pytest.mark.parametrize("use_nesterov", [False, True])
def test_momentum_matches_reference_op(use_nesterov):
    """Momentum alone: three steps of a linear layer's mean, the weight
    and its velocity against the reference's ``momentum`` op, plain and
    Nesterov."""
    prog, startup, loss = _momentum_program(use_nesterov)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    w = torch.from_numpy(np.array(scope.find_var("fc_0.w_0")))
    w.requires_grad_()
    opt = Momentum([w], learning_rate=0.1, momentum=0.9,
                   use_nesterov=use_nesterov)
    for step in range(3):
        x = np.random.RandomState(step).randn(5, 8).astype(np.float32)
        exe.run(prog, feed={"x": x}, fetch_list=[loss], scope=scope)
        opt.minimize((torch.from_numpy(x) @ w).mean())
    np.testing.assert_allclose(w.detach().numpy(),
                               scope.find_var("fc_0.w_0"), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(opt.state[w]["velocity"].numpy(),
                               scope.find_var("fc_0.w_0_velocity_0"),
                               rtol=1e-6, atol=1e-7)
