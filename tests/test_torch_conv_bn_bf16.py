"""paddle_tpu_torch's conv + batch-norm kernels (#18-#21) in bf16 (amp)
against the JAX package, on the CPU.

The bf16 twins of ``paddle_tpu_torch.kernels.conv_bn`` (what a wrapper
runs for CPU tensors, and what the card's kernels are held to bit for bit
in ``chip_smoke.py``) against ``paddle_tpu.kernels.conv_bn`` on the same
bf16 inputs, its Pallas kernels in interpret mode (``interpret=True``), on
one shape where the reference's plan launches its kernel (rows a multiple
of 16; C a multiple of 128, or C < 128 folded into 128 lanes) and one
where its plan returns None and it composes in XLA.  The reference's
interpret mode rounds every bf16 op once, as PyTorch's bf16 ops do, so
#20's out and #21's dx and dres agree bit for bit.  The conv + BN op under
the cast policy is held against the reference's ``conv2d_bn`` program
under ``pt.amp.enable``, and the slot policy against
``paddle_tpu.amp.apply_cast_policy``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import amp as ref_amp
from paddle_tpu import layers
from paddle_tpu.core import framework as fw
from paddle_tpu.kernels import conv_bn as CB
from paddle_tpu_torch import amp, kernels
from paddle_tpu_torch.kernels import conv_bn as kc
from paddle_tpu_torch.ops import nn_ops

#: f32 sums of the same bf16 values, in other orders than the reference's
#: per-tile then across-tile sums (as tests/test_torch_conv_bn.py's TOL):
#: relative, and absolute against the largest magnitude (at least 1)
TOL_SUM = 1e-5
#: one bf16 step: a value rounded to bf16 from f32 sums taken in other
#: orders (the 1x1 product, the convolution, a wv rounded from an f32
#: rsqrt one ulp apart) may land on the neighbouring bf16 value
BF16_STEP = 2.0 ** -7
#: sums over values that may each sit one bf16 step apart (the statistics
#: of y, the gradients through it): relative to the largest magnitude
TOL_BF16_SUM = 2.0 ** -7
EPS = 1e-5


def _bf16(a):
    """A numpy f32 array rounded to bf16, as (jax array, torch tensor) of
    the same bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()
    return j, t


def _np(a):
    if torch.is_tensor(a):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _same_bits(got, want):
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def _one_step(got, want):
    """Within one bf16 step of the reference's value, relative, and
    absolute against the largest magnitude."""
    _close(got, want, BF16_STEP)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_launches():
    """The CPU runs the plain twins: no kernel is ever launched."""
    kernels.reset_launches()
    yield
    assert not any(kernels.launches.values()), kernels.launches


#: NHWC shapes of #18, #20 and #21, and the reference's route on each in
#: bf16: 64 rows of 128 channels and 64 rows of 64 (folded into 128 lanes)
#: launch its kernels; 105 rows of 96 and 64 of 6 compose
SHAPES = {(2, 4, 8, 128): "kernel", (2, 4, 8, 64): "kernel",
          (3, 5, 7, 96): "composed", (2, 4, 8, 6): "composed"}


def _route(shape):
    rows = int(np.prod(shape[:-1]))
    plan = CB._plan(rows, shape[-1], jnp.bfloat16, True)
    route = "kernel" if plan else "composed"
    assert route == SHAPES[tuple(shape)]
    return route


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
def test_channel_stats_bf16_matches_reference(shape):
    """#18 on a bf16 y: the f32 sums within TOL_SUM, and the bf16
    gradient into y of random cotangents (gs1 + 2 y gs2 in f32, rounded
    once) within one bf16 step, against ``jax.vjp``."""
    _route(shape)
    rng = np.random.RandomState(sum(shape))
    jy, ty = _bf16(_rand(rng, *shape))
    c = shape[-1]
    gs1, gs2 = _rand(rng, c), _rand(rng, c)
    want, vjp = jax.vjp(lambda a: CB.channel_stats(a, interpret=True), jy)
    (want_gy,) = vjp((jnp.asarray(gs1), jnp.asarray(gs2)))
    ty.requires_grad_()
    s1, s2 = kc.channel_stats(ty)
    assert s1.dtype == s2.dtype == torch.float32
    torch.autograd.backward((s1, s2), (torch.from_numpy(gs1),
                                       torch.from_numpy(gs2)))
    _close(s1, want[0], TOL_SUM)
    _close(s2, want[1], TOL_SUM)
    assert ty.grad.dtype == torch.bfloat16
    _one_step(ty.grad, want_gy)


@pytest.mark.parametrize("m,k,n", [(256, 64, 256), (200, 72, 100)])
def test_dot_col_stats_bf16_matches_reference(m, k, n):
    """#19 on bf16 x2 and w2 (M 256, N 256: the reference's kernel; M
    200, N 100: its XLA composition): y bf16 within one bf16 step, the
    f32 column sums of y within TOL_BF16_SUM, and dx, dw (bf16, from
    cotangents of y, s1 and s2 together) within one bf16 step, against
    ``jax.vjp``."""
    plan = CB._dot_plan(m, n, jnp.bfloat16, True)
    assert (plan is not None) == (m % 16 == 0 and n % 128 == 0)
    rng = np.random.RandomState(m + k + n)
    jx, tx = _bf16(_rand(rng, m, k))
    jw, tw = _bf16(_rand(rng, n, k, scale=k ** -0.5))
    jgy, tgy = _bf16(_rand(rng, m, n))
    gs1, gs2 = _rand(rng, n), _rand(rng, n)
    want, vjp = jax.vjp(lambda a, b: CB.dot_col_stats(a, b, interpret=True),
                        jx, jw)
    want_dx, want_dw = vjp((jgy, jnp.asarray(gs1), jnp.asarray(gs2)))
    tx.requires_grad_()
    tw.requires_grad_()
    y, s1, s2 = kc.dot_col_stats(tx, tw)
    assert y.dtype == torch.bfloat16 and s1.dtype == torch.float32
    torch.autograd.backward((y, s1, s2), (tgy, torch.from_numpy(gs1),
                                          torch.from_numpy(gs2)))
    _one_step(y, want[0])
    _close(s1, want[1], TOL_BF16_SUM)
    _close(s2, want[2], TOL_BF16_SUM)
    assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
    _one_step(tx.grad, want_dx)
    _one_step(tw.grad, want_dw)


def test_dot_col_stats_bf16_sums_are_of_the_stored_y():
    """#19's twin takes its sums from y as stored in bf16, as the
    reference's kernel does (``_dot_stats_kernel`` reads back y_ref): the
    sums equal f32 sums of the returned y, not of the f32 product."""
    rng = np.random.RandomState(3)
    _, tx = _bf16(_rand(rng, 256, 64))
    _, tw = _bf16(_rand(rng, 128, 64, scale=0.125))
    y, s1, s2 = kc.reference_dot_col_stats(tx, tw)
    yf = y.float()
    torch.testing.assert_close(s1, yf.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(s2, (yf * yf).sum(0), rtol=0, atol=0)
    exact = tx.double() @ tw.double().t()
    assert not torch.equal(s1.double(), exact.sum(0).float().double())


@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_scale_shift_act_bf16_matches_reference(shape, residual, relu):
    """#20 forward and #21 backward on bf16 x (and residual) with f32 wv,
    bv in each residual and ReLU mode: out, dx and dresidual bit for bit
    (both sides round wv, bv to bf16 and every product and sum once), dwv
    and dbv (f32 sums of g' x and g') within TOL_SUM, against
    ``jax.vjp``."""
    _route(shape)
    rng = np.random.RandomState(sum(shape) + 2 * residual + relu)
    c = shape[-1]
    (jx, tx), (jg, tg) = _bf16(_rand(rng, *shape)), _bf16(_rand(rng, *shape))
    wv, bv = _rand(rng, c) + 1.0, _rand(rng, c)
    jr, tr = _bf16(_rand(rng, *shape)) if residual else (None, None)

    def f(x, w, b, *r):
        return CB.scale_shift_act(x, w, b, residual=r[0] if r else None,
                                  relu=relu, interpret=True)

    primals = (jx, jnp.asarray(wv), jnp.asarray(bv)) + ((jr,) if residual
                                                        else ())
    want, vjp = jax.vjp(f, *primals)
    want_grads = vjp(jg)
    args = [tx, torch.from_numpy(wv), torch.from_numpy(bv)] + (
        [tr] if residual else [])
    for a in args:
        a.requires_grad_()
    out = kc.scale_shift_act(args[0], args[1], args[2],
                             residual=args[3] if residual else None,
                             relu=relu)
    out.backward(tg)
    _same_bits(out, want)
    _same_bits(args[0].grad, want_grads[0])
    assert args[1].grad.dtype == args[2].grad.dtype == torch.float32
    _close(args[1].grad, want_grads[1], TOL_SUM)
    _close(args[2].grad, want_grads[2], TOL_SUM)
    if residual:
        _same_bits(args[3].grad, want_grads[3])


@pytest.mark.parametrize("shape", [(2, 4, 8, 128), (3, 5, 7, 96)], ids=str)
def test_ssa_bwd_bf16_twin_rounds_wv(shape):
    """#21's twin rounds wv to bf16 before the product (dx = g' *
    bf16(wv), as the reference's kernel and its XLA fallback do), so dx
    is bf16 and is the f32 product's rounding only where bf16(wv) == wv."""
    rng = np.random.RandomState(7)
    c = shape[-1]
    _, x = _bf16(_rand(rng, *shape))
    _, g = _bf16(_rand(rng, *shape))
    wv = torch.from_numpy(_rand(rng, c) + 1.0)
    dx, dres, sg, sgx = kc.reference_ssa_bwd(g, x, None, wv, True, False)
    assert dx.dtype == dres.dtype == torch.bfloat16
    assert sg.dtype == sgx.dtype == torch.float32
    torch.testing.assert_close(dx, g * wv.bfloat16(), rtol=0, atol=0)
    assert not torch.equal(dx, (g.float() * wv).bfloat16())


@pytest.mark.parametrize("residual,act", [(False, ""), (True, "relu")])
def test_bn_apply_bf16_matches_reference(residual, act):
    """bn_apply on a bf16 x with f32 scale, bias, mean and var (folded in
    f32): the output and dx (and dresidual) within one bf16 step (wv
    rounds from an f32 rsqrt that may differ by an ulp), the f32
    gradients into scale, bias, mean and var within TOL_BF16_SUM, against
    ``jax.vjp``."""
    rng = np.random.RandomState(11 + residual)
    c = 128
    (jx, tx), (jg, tg) = (_bf16(_rand(rng, 2, 4, 4, c)),
                          _bf16(_rand(rng, 2, 4, 4, c)))
    vecs = [_rand(rng, c) + 1.0, _rand(rng, c), _rand(rng, c, scale=0.1),
            rng.rand(c).astype(np.float32) + 0.5]
    jr, tr = _bf16(_rand(rng, 2, 4, 4, c)) if residual else (None, None)

    def f(x, *a):
        return CB.bn_apply(x, *a[:4], residual=a[4] if residual else None,
                           eps=EPS, act=act, interpret=True)

    primals = [jx] + [jnp.asarray(v) for v in vecs] + ([jr] if residual
                                                       else [])
    want, vjp = jax.vjp(f, *primals)
    want_grads = vjp(jg)
    args = [tx] + [torch.from_numpy(v) for v in vecs] + ([tr] if residual
                                                         else [])
    for a in args:
        a.requires_grad_()
    out = kc.bn_apply(*args[:5], residual=args[5] if residual else None,
                      eps=EPS, act=act)
    out.backward(tg)
    assert out.dtype == torch.bfloat16
    _one_step(out, want)
    _one_step(args[0].grad, want_grads[0])
    for a, w in zip(args[1:5], want_grads[1:5]):
        assert a.grad.dtype == torch.float32
        _close(a.grad, w, TOL_BF16_SUM)
    if residual:
        _one_step(args[5].grad, want_grads[5])


@pytest.mark.parametrize("kernel,stride,padding", [(1, 1, 0), (1, 2, 0),
                                                   (3, 1, 1)])
def test_conv_bn_stats_bf16_matches_reference(kernel, stride, padding):
    """conv_bn_stats on bf16 x and filter: the 1x1 (#19, a strided one on
    the copied rows) and 3x3 (``F.conv2d`` then #18) routes, y within one
    bf16 step, its f32 sums within TOL_BF16_SUM, and the bf16 gradients
    into x and the filter within one bf16 step, against ``jax.vjp``."""
    rng = np.random.RandomState(kernel * 10 + stride)
    c_in, c_out = 64, 128
    jx, tx = _bf16(_rand(rng, 2, 8, 8, c_in))
    jw, tw = _bf16(_rand(rng, c_out, c_in, kernel, kernel,
                         scale=(c_in * kernel * kernel) ** -0.5))
    h = (8 + 2 * padding - kernel) // stride + 1
    (jgy, tgy) = _bf16(_rand(rng, 2, h, h, c_out))
    gs1, gs2 = _rand(rng, c_out), _rand(rng, c_out)
    strides, paddings = (stride, stride), (padding, padding)
    want, vjp = jax.vjp(lambda a, b: CB.conv_bn_stats(
        a, b, strides, paddings, interpret=True), jx, jw)
    want_dx, want_dw = vjp((jgy, jnp.asarray(gs1), jnp.asarray(gs2)))
    tx.requires_grad_()
    tw.requires_grad_()
    got = kc.conv_bn_stats(tx, tw, strides, paddings)
    assert got[0].shape == (2, h, h, c_out) and got[0].dtype == torch.bfloat16
    torch.autograd.backward(got, (tgy, torch.from_numpy(gs1),
                                  torch.from_numpy(gs2)))
    _one_step(got[0], want[0])
    _close(got[1], want[1], TOL_BF16_SUM)
    _close(got[2], want[2], TOL_BF16_SUM)
    _one_step(tx.grad, want_dx)
    _one_step(tw.grad, want_dw)


# -- the cast policy at the conv + BN op -------------------------------------

#: conv2d_bn's slots: the convolution operands and residual are cast to
#: bf16, the batch norm's vectors stay f32
SLOTS = ("Input", "Filter", "Residual", "Scale", "Bias", "Mean", "Variance")


class _Enabled(torch.nn.Module):
    """A model the policy is enabled on, to open amp.policy_scope."""


def _scope():
    holder = _Enabled()
    amp.enable(holder)
    return amp.policy_scope(holder)


def test_cast_slots_follows_reference_slot_policy():
    """amp.cast_slots("conv2d_bn", ...) casts exactly the slots the
    reference's ``apply_cast_policy`` casts (Input, Filter, Residual to
    bf16; Scale, Bias, Mean, Variance stay f32), returns them in the
    order given, and casts nothing outside the policy's scope."""
    rng = np.random.RandomState(0)
    arrays = {s: _rand(rng, 4) for s in SLOTS}
    want = ref_amp.apply_cast_policy(
        "conv2d_bn", {s: [jnp.asarray(a)] for s, a in arrays.items()})
    tensors = {s: torch.from_numpy(a) for s, a in arrays.items()}
    outside = amp.cast_slots("conv2d_bn", **tensors)
    assert all(a is b for a, b in zip(outside, tensors.values()))
    with _scope():
        got = amp.cast_slots("conv2d_bn", **tensors)
        x, r = amp.cast_slots("conv2d_bn", Input=tensors["Input"],
                              Residual=None)
    assert r is None and torch.equal(x, tensors["Input"].bfloat16())
    for slot, t in zip(SLOTS, got):
        ref_dtype = want[slot][0].dtype
        assert (t.dtype == torch.bfloat16) == (ref_dtype == jnp.bfloat16), \
            slot
        assert (t.dtype == torch.bfloat16) == (slot in ("Input", "Filter",
                                                        "Residual"))
        np.testing.assert_array_equal(_np(t), np.asarray(
            want[slot][0].astype(jnp.float32)))


def test_conv2d_bn_casts_its_slots_under_the_policy(monkeypatch):
    """Under the policy conv2d_bn hands bf16 x and filter to
    conv_bn_stats and a bf16 residual to bn_apply, with scale, bias and
    the running statistics f32; y and the output are bf16, the running
    statistics it returns f32.  Outside the policy nothing is cast."""
    seen = {}
    stats, apply = nn_ops.conv_bn_stats, nn_ops.bn_apply

    def conv_bn_stats(x, w, *a):
        seen.update(x=x.dtype, w=w.dtype)
        return stats(x, w, *a)

    def bn_apply(y, scale, bias, mean, var, residual=None, **kw):
        seen.update(y=y.dtype, scale=scale.dtype, residual=residual.dtype)
        return apply(y, scale, bias, mean, var, residual=residual, **kw)

    monkeypatch.setattr(nn_ops, "conv_bn_stats", conv_bn_stats)
    monkeypatch.setattr(nn_ops, "bn_apply", bn_apply)
    rng = np.random.RandomState(1)
    x, r = (torch.from_numpy(_rand(rng, 2, 8, 8, 16)) for _ in range(2))
    w = torch.from_numpy(_rand(rng, 16, 16, 3, 3, scale=0.1))
    vecs = [torch.ones(16), torch.zeros(16), torch.zeros(16), torch.ones(16)]
    out, mean, var = nn_ops.conv2d_bn(x, w, *vecs, residual=r, paddings=1,
                                      act="relu")
    assert out.dtype == torch.float32 and set(seen.values()) == {
        torch.float32}
    with _scope():
        out, mean, var = nn_ops.conv2d_bn(x, w, *vecs, residual=r,
                                          paddings=1, act="relu")
    assert seen == dict(x=torch.bfloat16, w=torch.bfloat16,
                        y=torch.bfloat16, scale=torch.float32,
                        residual=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32


def test_pool2d_bf16_average_is_jnp_mean():
    """The global average of a bf16 x is ``jnp.mean``'s bits: an f32 sum
    divided by the count, rounded once to bf16 (the reference's pool2d
    lowering)."""
    rng = np.random.RandomState(2)
    jx, tx = _bf16(_rand(rng, 4, 7, 7, 256) + 0.3)
    got = nn_ops.pool2d(tx, "avg", global_pooling=True)
    want = jnp.mean(jx, axis=(1, 2), keepdims=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _same_bits(got, want)


#: gradients through conv2d_bn under the policy against the reference's
#: program under pt.amp.enable: f32 parameter gradients that sum products
#: of bf16 values which may each sit one bf16 step apart (the convolution
#: and y round in other orders), relative to the largest magnitude
TOL_AMP_GRAD = 2.0 ** -6


def _conv_bn_amp_program(residual):
    prog, startup = pt.Program(), pt.Program()
    with fw.guard_unique_name():
        with pt.program_guard(prog, startup):
            x = layers.data(name="x", shape=[8, 8, 16], dtype="float32")
            g = layers.data(name="g", shape=[4, 4, 32], dtype="float32")
            r = (layers.data(name="r", shape=[4, 4, 32], dtype="float32")
                 if residual else None)
            y = layers.conv2d_bn(x, 32, 3, stride=2, padding=1, act="relu",
                                 residual=r, data_format="NHWC")
            loss = layers.mean(layers.elementwise_mul(y, g))
            pt.optimizer.SGD(learning_rate=1.0).minimize(loss)
    pt.amp.enable(prog)
    return prog, startup, y, loss


@pytest.mark.parametrize("residual", [False, True])
def test_conv2d_bn_gradients_under_policy_match_reference(residual):
    """conv2d_bn (3x3 stride 2: ``F.conv2d`` and #18, then #20; #21 and
    the statistics' backward) under the policy against the reference's
    ``conv2d_bn`` op in a program under ``pt.amp.enable``: the bf16 output
    within one bf16 step, the loss mean(y * g) (``elementwise_mul``
    GRAY_FOLLOW, ``mean`` BLACK), the f32 running statistics within
    TOL_BF16_SUM, and the f32 gradients of the filter, scale and bias
    within TOL_AMP_GRAD."""
    prog, startup, y, loss = _conv_bn_amp_program(residual)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(5 + residual)
    names = ("conv2d_0.w_0", "batch_norm_0.w_0", "batch_norm_0.b_0",
             "batch_norm_0.mean_0", "batch_norm_0.var_0")
    state = {n: np.asarray(scope.find_var(n)) for n in names}
    state["batch_norm_0.w_0"] = rng.rand(32).astype(np.float32) + 0.5
    state["batch_norm_0.b_0"] = _rand(rng, 32, scale=0.1)
    for name, value in state.items():
        scope.set_var(name, value)
    feed = {"x": _rand(rng, 2, 8, 8, 16), "g": _rand(rng, 2, 4, 4, 32)}
    if residual:
        feed["r"] = _rand(rng, 2, 4, 4, 32)
    trained = names[:3]
    want_y, want_loss, *want_grads = exe.run(
        prog, feed=feed,
        fetch_list=[y, loss] + [f"{n}@GRAD" for n in trained], scope=scope)
    params = [torch.from_numpy(np.array(state[n])).requires_grad_()
              for n in trained]
    t = {k: torch.from_numpy(v) for k, v in feed.items()}
    with _scope():
        out, mean_out, var_out = nn_ops.conv2d_bn(
            t["x"], *params, torch.from_numpy(state[names[3]]),
            torch.from_numpy(state[names[4]]), residual=t.get("r"),
            strides=2, paddings=1, eps=EPS, momentum=0.9, act="relu")
        got_loss = (out * t["g"].to(out.dtype)).float().mean()
    got_loss.backward()
    assert out.dtype == torch.bfloat16
    _one_step(out, want_y)
    _close(got_loss, np.asarray(want_loss).reshape(()), TOL_AMP_GRAD)
    _close(mean_out, scope.find_var(names[3]), TOL_BF16_SUM)
    _close(var_out, scope.find_var(names[4]), TOL_BF16_SUM)
    for p, w, n in zip(params, want_grads, trained):
        assert p.grad.dtype == torch.float32, n
        _close(p.grad, w, TOL_AMP_GRAD)
