"""paddle_tpu_torch's conv + batch-norm kernels (#18-#21) and ops against
the JAX package, on the CPU.

Each wrapper of ``paddle_tpu_torch.kernels.conv_bn`` runs its plain twin
for CPU tensors; the reference side is ``paddle_tpu.kernels.conv_bn`` with
its Pallas kernels in interpret mode (``interpret=True``), from the same
seeded numpy inputs.  Forward values and gradients (against ``jax.vjp``)
must agree at C = 64 (the reference folds it into 128 lanes) and C = 256,
and at the channel counts that are not a multiple of 4: C = 1 and 2,
where the reference folds the channels into 128 lanes and launches
(:func:`_small_shape` gives it whole folded tiles), and C = 3 and 6,
where its plan declines and it composes in XLA.
The ops ``batch_norm``, ``conv2d_bn``, ``pool2d``, ``cross_entropy`` and
``accuracy`` are held against the reference's lowerings through small
programs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import layers
from paddle_tpu.core import framework as fw
from paddle_tpu.kernels import conv_bn as CB
from paddle_tpu_torch import kernels
from paddle_tpu_torch.kernels import conv_bn as kc
from paddle_tpu_torch.ops import nn_ops

#: f32 sums over at most a few thousand rows, taken in other orders than
#: the interpret-mode kernels' (per tile, then across tiles): relative,
#: and absolute against the tensor's largest magnitude (at least 1), since
#: an element that a sum cancels keeps the error of its large terms
TOL = 1e-5
#: the 1x1 products and the convolutions, and their gradients (sums of up
#: to 512 products, f32)
TOL_DOT = 2e-5
EPS = 1e-5


def _close(got, want, tol=TOL):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.fixture(autouse=True)
def _no_launches():
    """The CPU runs the plain twins: no kernel is ever launched."""
    kernels.reset_launches()
    yield
    assert not any(kernels.launches.values()), kernels.launches


#: channel counts that are not a multiple of 4, and the reference's route
#: at each: its Pallas kernels (folded into 128 lanes) or its composition
SMALL_C = {1: "kernel", 2: "kernel", 3: "composed", 6: "composed"}


def _small_shape(shape, c):
    """``shape`` (NHWC, ending in C) at the channel counts the port's
    kernels take as float4s; at SMALL_C, a shape of 1024 rows, so that
    the reference's folded view at C = 1 and 2 is whole 8-row tiles and
    its plan launches.  Checks the reference's route at SMALL_C."""
    if c not in SMALL_C:
        return shape
    rows = 1024
    route = "kernel" if CB._plan(rows, c, np.float32, True) else "composed"
    assert route == SMALL_C[c]
    return (4, 16, 16, c)


@pytest.mark.parametrize("c", [64, 256, *SMALL_C])
def test_channel_stats_matches_reference(c):
    """#18: s1 and s2 of y [4, 6, 8, C] (:func:`_small_shape` at SMALL_C),
    and the gradient into y of random cotangents of both, against
    ``jax.vjp``."""
    rng = np.random.RandomState(c)
    y = _rand(rng, *_small_shape((4, 6, 8, c), c))
    gs1, gs2 = _rand(rng, c), _rand(rng, c)
    want, vjp = jax.vjp(lambda a: CB.channel_stats(a, interpret=True),
                        jnp.asarray(y))
    (want_gy,) = vjp((jnp.asarray(gs1), jnp.asarray(gs2)))
    ty = _t(y, grad=True)
    s1, s2 = kc.channel_stats(ty)
    torch.autograd.backward((s1, s2), (_t(gs1), _t(gs2)))
    _close(s1, want[0])
    _close(s2, want[1])
    _close(ty.grad, want_gy)


@pytest.mark.parametrize("m,k,n", [(256, 64, 256), (128, 256, 64),
                                   (64, 128, 128), (200, 72, 100),
                                   (130, 64, 68)])
def test_dot_col_stats_matches_reference(m, k, n):
    """#19: y = x2 w2^T with its column sums, and dx, dw from cotangents
    of y, s1 and s2 together, against ``jax.vjp``."""
    rng = np.random.RandomState(m + k + n)
    x2, w2 = _rand(rng, m, k), _rand(rng, n, k, scale=k ** -0.5)
    gy, gs1, gs2 = _rand(rng, m, n), _rand(rng, n), _rand(rng, n)
    want, vjp = jax.vjp(lambda a, b: CB.dot_col_stats(a, b, interpret=True),
                        jnp.asarray(x2), jnp.asarray(w2))
    want_dx, want_dw = vjp(tuple(jnp.asarray(a) for a in (gy, gs1, gs2)))
    tx, tw = _t(x2, grad=True), _t(w2, grad=True)
    got = kc.dot_col_stats(tx, tw)
    torch.autograd.backward(got, [_t(a) for a in (gy, gs1, gs2)])
    for g, w in zip(got, want):
        _close(g, w, TOL_DOT)
    _close(tx.grad, want_dx, TOL_DOT)
    _close(tw.grad, want_dw, TOL_DOT)


@pytest.mark.parametrize("kernel,stride,padding", [(1, 1, 0), (1, 2, 0),
                                                   (3, 1, 1), (7, 2, 3)])
def test_conv_bn_stats_matches_reference(kernel, stride, padding):
    """conv_bn_stats: 1x1 (#19, a strided one on the copied rows) and the
    3x3 and 7x7 convolutions (``F.conv2d`` then #18), y and its sums, and
    the gradients into x and the OIHW filter, against ``jax.vjp``."""
    rng = np.random.RandomState(kernel * 10 + stride)
    c_in, c_out = (3, 64) if kernel == 7 else (64, 128)
    x = _rand(rng, 2, 8, 8, c_in)
    w = _rand(rng, c_out, c_in, kernel, kernel,
              scale=(c_in * kernel * kernel) ** -0.5)
    h = (8 + 2 * padding - kernel) // stride + 1
    cot = (_rand(rng, 2, h, h, c_out), _rand(rng, c_out), _rand(rng, c_out))
    strides, paddings = (stride, stride), (padding, padding)
    want, vjp = jax.vjp(lambda a, b: CB.conv_bn_stats(
        a, b, strides, paddings, interpret=True), jnp.asarray(x),
        jnp.asarray(w))
    want_dx, want_dw = vjp(tuple(jnp.asarray(a) for a in cot))
    tx, tw = _t(x, grad=True), _t(w, grad=True)
    got = kc.conv_bn_stats(tx, tw, strides, paddings)
    assert got[0].shape == (2, h, h, c_out)
    torch.autograd.backward(got, [_t(a) for a in cot])
    for g, wnt in zip(got, want):
        _close(g, wnt, TOL_DOT)
    _close(tx.grad, want_dx, TOL_DOT)
    _close(tw.grad, want_dw, TOL_DOT)


@pytest.mark.parametrize("c", [64, 256, *SMALL_C])
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_scale_shift_act_matches_reference(c, residual, relu):
    """#20 forward and #21 backward in each residual and ReLU mode:
    out, and dx, dwv, dbv (and dresidual), against ``jax.vjp``; x [2, 4,
    8, C] (:func:`_small_shape` at SMALL_C)."""
    rng = np.random.RandomState(c + 2 * residual + relu)
    shape = _small_shape((2, 4, 8, c), c)
    x, g = _rand(rng, *shape), _rand(rng, *shape)
    wv, bv = _rand(rng, c) + 1.0, _rand(rng, c)
    res = _rand(rng, *shape) if residual else None
    primals = [x, wv, bv] + ([res] if residual else [])

    def f(*a):
        return CB.scale_shift_act(a[0], a[1], a[2],
                                  residual=a[3] if residual else None,
                                  relu=relu, interpret=True)

    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in primals))
    want_grads = vjp(jnp.asarray(g))
    args = [_t(a, grad=True) for a in primals]
    out = kc.scale_shift_act(args[0], args[1], args[2],
                             residual=args[3] if residual else None,
                             relu=relu)
    out.backward(_t(g))
    _close(out, want)
    for a, w in zip(args, want_grads):
        _close(a.grad, w)


@pytest.mark.parametrize("residual,act", [(False, ""), (True, "relu")])
def test_bn_apply_matches_reference(residual, act):
    """bn_apply with batch-like statistics: the output and the gradients
    into x, scale, bias, mean, var (and the residual) through the f32
    folding, against ``jax.vjp``."""
    rng = np.random.RandomState(5 + residual)
    c = 64
    x, g = _rand(rng, 2, 4, 4, c), _rand(rng, 2, 4, 4, c)
    scale, bias = _rand(rng, c) + 1.0, _rand(rng, c)
    mean, var = _rand(rng, c, scale=0.1), rng.rand(c).astype(np.float32) + .5
    res = _rand(rng, 2, 4, 4, c) if residual else None
    primals = [x, scale, bias, mean, var] + ([res] if residual else [])

    def f(*a):
        return CB.bn_apply(*a[:5], residual=a[5] if residual else None,
                           eps=EPS, act=act, interpret=True)

    want, vjp = jax.vjp(f, *(jnp.asarray(a) for a in primals))
    want_grads = vjp(jnp.asarray(g))
    args = [_t(a, grad=True) for a in primals]
    out = kc.bn_apply(*args[:5], residual=args[5] if residual else None,
                      eps=EPS, act=act)
    out.backward(_t(g))
    _close(out, want)
    for a, w in zip(args, want_grads):
        _close(a.grad, w)


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor CUDA reaches no twin: every kernel
    wrapper raises."""
    x = torch.empty(8, 64, device="meta")
    wv = torch.empty(64, device="meta")
    for call in (lambda: kc.channel_stats_fwd(x),
                 lambda: kc.dot_col_stats_fwd(x, torch.empty(
                     32, 64, device="meta")),
                 lambda: kc.ssa_fwd(x, wv, wv),
                 lambda: kc.ssa_bwd(x, x, x, wv, False, True)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


def _bn_program(is_test):
    prog, startup = pt.Program(), pt.Program()
    with fw.guard_unique_name():
        with pt.program_guard(prog, startup):
            x = layers.data(name="x", shape=[6, 6, 32], dtype="float32")
            y = layers.batch_norm(x, data_layout="NHWC", is_test=is_test)
            loss = layers.mean(y * y * 0.1)
            if not is_test:
                pt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return prog, startup, y, loss


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm_matches_reference_program(is_test):
    """The ``batch_norm`` op on NHWC input (training: the fused route, #18
    and #20/#21; is_test: the global-stats composition): y, the running
    statistics, and in training the scale and bias after one SGD(0.1)
    step, against the reference's program (FLAGS at their defaults)."""
    prog, startup, y, loss = _bn_program(is_test)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(7)
    state = {"batch_norm_0.w_0": rng.rand(32).astype(np.float32) + 0.5,
             "batch_norm_0.b_0": _rand(rng, 32),
             "batch_norm_0.mean_0": _rand(rng, 32, scale=0.1),
             "batch_norm_0.var_0": rng.rand(32).astype(np.float32) + 0.5}
    for name, value in state.items():
        scope.set_var(name, value)
    x = rng.rand(4, 6, 6, 32).astype(np.float32)
    want_y, want_loss = exe.run(prog, feed={"x": x}, fetch_list=[y, loss],
                                scope=scope)
    scale, bias = (_t(state[f"batch_norm_0.{n}"], grad=True)
                   for n in ("w_0", "b_0"))
    got_y, mean_out, var_out = nn_ops.batch_norm(
        _t(x), scale, bias, _t(state["batch_norm_0.mean_0"]),
        _t(state["batch_norm_0.var_0"]), eps=EPS, momentum=0.9,
        use_global_stats=is_test)
    got_loss = (got_y * got_y * 0.1).mean()
    _close(got_y, want_y)
    _close(got_loss, np.asarray(want_loss).reshape(()))
    _close(mean_out, scope.find_var("batch_norm_0.mean_0"))
    _close(var_out, scope.find_var("batch_norm_0.var_0"))
    if not is_test:
        got_loss.backward()
        with torch.no_grad():
            _close(scale - 0.1 * scale.grad,
                   scope.find_var("batch_norm_0.w_0"))
            _close(bias - 0.1 * bias.grad,
                   scope.find_var("batch_norm_0.b_0"))


def _conv_bn_program(residual, act, is_test, c=32, side=8):
    prog, startup = pt.Program(), pt.Program()
    with fw.guard_unique_name():
        with pt.program_guard(prog, startup):
            x = layers.data(name="x", shape=[side, side, 16],
                            dtype="float32")
            r = (layers.data(name="r", shape=[side // 2, side // 2, c],
                             dtype="float32") if residual else None)
            y = layers.conv2d_bn(x, c, 3, stride=2, padding=1,
                                 act=act or None, residual=r,
                                 is_test=is_test, data_format="NHWC")
    return prog, startup, y


@pytest.mark.parametrize("residual,act,is_test,c", [
    pytest.param(False, "relu", False, 32, id="False-relu-False"),
    pytest.param(True, "relu", False, 32, id="True-relu-False"),
    pytest.param(False, "", False, 32, id="False--False"),
    pytest.param(True, "relu", True, 32, id="True-relu-True"),
    *(pytest.param(c % 2 == 0, "relu", False, c, id=f"c{c}")
      for c in SMALL_C)])
def test_conv2d_bn_matches_reference_program(residual, act, is_test, c):
    """The ``conv2d_bn`` op (3x3 stride 2: ``F.conv2d`` and #18, then
    #20): the output and the running statistics against the reference's
    op, in training and at is_test (the composition over the running
    statistics); with C output channels, at SMALL_C on 4 images of 32 x
    32 (1024 output rows: the reference launches at C = 1 and 2)."""
    side = 32 if c in SMALL_C else 8
    prog, startup, y = _conv_bn_program(residual, act, is_test, c, side)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3 + residual)
    names = ("conv2d_0.w_0", "batch_norm_0.w_0", "batch_norm_0.b_0",
             "batch_norm_0.mean_0", "batch_norm_0.var_0")
    state = {n: np.asarray(scope.find_var(n)) for n in names}
    state["batch_norm_0.mean_0"] = _rand(rng, c, scale=0.1)
    state["batch_norm_0.var_0"] = rng.rand(c).astype(np.float32) + 0.5
    for name, value in state.items():
        scope.set_var(name, value)
    n = 4 if c in SMALL_C else 2
    feed = {"x": _rand(rng, n, side, side, 16)}
    if residual:
        feed["r"] = _rand(rng, n, side // 2, side // 2, c)
    (want,) = exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    got, mean_out, var_out = nn_ops.conv2d_bn(
        _t(feed["x"]), *(_t(state[n]) for n in names),
        residual=_t(feed["r"]) if residual else None, strides=2,
        paddings=1, eps=EPS, momentum=0.9, act=act,
        use_global_stats=is_test)
    _close(got, want, TOL_DOT)
    _close(mean_out, scope.find_var("batch_norm_0.mean_0"), TOL_DOT)
    _close(var_out, scope.find_var("batch_norm_0.var_0"), TOL_DOT)


def test_pool_cross_entropy_accuracy_match_reference_program():
    """pool2d (max 3x3 stride 2 pad 1, global average) in NHWC, the
    softmax fc's cross_entropy with its 1e-12 clip (one probability
    driven to 0) and top-1 accuracy, against the reference's ops."""
    prog, startup = pt.Program(), pt.Program()
    with fw.guard_unique_name():
        with pt.program_guard(prog, startup):
            x = layers.data(name="x", shape=[7, 7, 8], dtype="float32")
            p = layers.data(name="p", shape=[5], dtype="float32")
            label = layers.data(name="label", shape=[1], dtype="int64")
            mx = layers.pool2d(x, pool_type="max", pool_size=3,
                               pool_stride=2, pool_padding=1,
                               data_format="NHWC")
            avg = layers.pool2d(x, pool_type="avg", global_pooling=True,
                                data_format="NHWC")
            ce = layers.cross_entropy(input=p, label=label)
            acc = layers.accuracy(input=p, label=label)
    rng = np.random.RandomState(11)
    x = _rand(rng, 3, 7, 7, 8)
    prob = rng.rand(3, 5).astype(np.float32)
    prob[1, 2] = 0.0
    lbl = np.array([[0], [2], [4]], np.int64)
    lbl[0, 0] = int(prob[0].argmax())
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    want = exe.run(prog, feed={"x": x, "p": prob, "label": lbl},
                   fetch_list=[mx, avg, ce, acc], scope=scope)
    got = [nn_ops.pool2d(_t(x), "max", 3, 2, 1),
           nn_ops.pool2d(_t(x), "avg", global_pooling=True),
           nn_ops.cross_entropy(_t(prob), _t(lbl)),
           nn_ops.accuracy(_t(prob), _t(lbl))]
    for g, w in zip(got, want):
        _close(g, w)
    assert np.isclose(float(got[2][1, 0]), -np.log(1e-12))


@pytest.mark.parametrize("pool_type,global_pooling", [("max", True),
                                                      ("avg", False)])
def test_pool2d_raises_for_what_is_not_ported(pool_type, global_pooling):
    """pool2d ports the max window and the global average that ResNet
    runs; global max and average windows raise instead of guessing."""
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(NotImplementedError, match="not ported"):
        nn_ops.pool2d(x, pool_type, 2, 2, global_pooling=global_pooling)
