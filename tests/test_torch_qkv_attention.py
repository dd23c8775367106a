"""paddle_tpu_torch flash_qkv_attention's training passes against the JAX
package, on the CPU.

On CPU tensors the port's autograd.Function runs the plain twins of its
three kernels (#1 with residuals, #2 dx_q/dW_q/dW_out, #3 dx_kv/dW_k/dW_v),
so these tests hold that arithmetic and the Function's wiring against the
reference's fused Pallas kernels in interpret mode (``_qkv_forward``,
``_qkv_backward`` and ``jax.vjp`` of ``flash_qkv_attention``) and against
autograd through a plain float64 softmax.  The CUDA kernels are held
against the same twins on the card by chip_smoke.py.  Inputs are numpy
arrays from seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import attention as jax_attention
from paddle_tpu_torch.kernels import attention as ka

#: the reference's own tolerance for its fused kernels against the
#: composed path (tests/test_fused_qkv_attention.py): f32, other orders
RTOL, ATOL = 2e-4, 1e-6
B, DM, DH = 2, 128, 64
SCALE = DH ** -0.5

#: (name, n_head, t, bias kind, causal): no bias, the key-padding bias
#: [b, 1, 1, t], the decoder's causal-plus-padding bias [b, 1, t, t],
#: causal=True with and without padding, a row masked by -1e30 on every
#: key, and a dense bias that requires grad
CASES = [
    ("no_bias", 2, 64, None, False),
    ("pad", 2, 128, "pad", False),
    ("decoder", 3, 64, "decoder", False),
    ("causal", 3, 128, None, True),
    ("causal_pad", 2, 64, "pad", True),
    ("masked_row", 2, 64, "masked", False),
    ("trainable_bias", 3, 64, "dense", False),
]


def _inputs(n_head, t, bias_kind, seed=0):
    """x, w_qkv, w_out, g = dL/dy and the case's bias, as numpy f32, at the
    reference test's scales (x 0.3, weights 0.08), for which its atol was
    chosen."""
    rng = np.random.RandomState(seed)
    hd = n_head * DH
    x = (rng.randn(B, t, DM) * 0.3).astype(np.float32)
    w_qkv = (rng.randn(DM, 3 * hd) * 0.08).astype(np.float32)
    w_out = (rng.randn(hd, DM) * 0.08).astype(np.float32)
    g = (rng.randn(B, t, DM) * 0.3).astype(np.float32)
    pad = np.zeros((B, 1, 1, t), np.float32)
    pad[1, ..., t - 7:] = -1e9  # lane 1 has a padded tail
    if bias_kind == "pad":
        bias = pad
    elif bias_kind in ("decoder", "masked"):
        future = np.triu(np.full((t, t), -1e9, np.float32), 1)
        bias = (pad + future[None, None]).astype(np.float32)
        if bias_kind == "masked":  # row 5 of lane 1 sees nothing
            bias[1, 0, 5, :] = -1e30
    elif bias_kind == "dense":
        bias = (rng.randn(B, 1, t, t) * 0.5).astype(np.float32)
    else:
        bias = None
    return x, w_qkv, w_out, g, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _jax_kernels(x, w_qkv, w_out, g, bias, n_head, causal):
    """(y, ctx [b, h, t, dh], lse, dx_q, dx_kv, dW_qkv, dW_out) from the
    reference's interpret-mode kernels, dW packed as its VJP packs it."""
    jx, jw, jo, jg, jb = (_j(a) for a in (x, w_qkv, w_out, g, bias))
    ok, bq, bk, interp = jax_attention._qkv_plan(jx, n_head, DH, 512, 512,
                                                 True, bias=jb)
    assert ok and interp  # the fused kernels run, not the composed path
    w3 = jax_attention._prep_w_qkv(jw, n_head, DH)
    wo = jax_attention._prep_w_out(jo, n_head, DH)
    seed = jnp.zeros((1,), jnp.uint32)
    y, ctx, lse = jax_attention._qkv_forward(
        jx, w3, wo, jb, seed, SCALE, causal, n_head, DH, bq, bk, True, 0.0,
        False)
    dx_q, dx_kv, dwq, dwk, dwv, dwo = jax_attention._qkv_backward(
        jx, w3, wo, jb, seed, ctx, lse, jg, SCALE, causal, n_head, DH, bq,
        bk, True, 0.0, False)
    dw_qkv = jax_attention._unpack_dw_qkv(dwq, dwk, dwv, jnp.float32)
    return (y, ctx, lse, dx_q, dx_kv, dw_qkv,
            dwo.reshape(n_head * DH, DM))


@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", CASES)
def test_forward_residuals_match_jax_kernel(name, n_head, t, bias_kind,
                                            causal):
    """(y, ctx, lse) of #1's twin against _qkv_fwd_kernel (interpret); the
    port keeps ctx as [b, t, h, dh].  A masked row gets ctx 0 and lse =
    +inf in both."""
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind)
    want_y, want_ctx, want_lse = _jax_kernels(x, w_qkv, w_out, g, bias,
                                              n_head, causal)[:3]
    y, ctx, lse = ka.qkv_attention_fwd(*(_t(a) for a in (x, w_qkv, w_out,
                                                          bias)),
                                       n_head=n_head, scale=SCALE,
                                       causal=causal)
    assert y.shape == (B, t, DM) and ctx.shape == (B, t, n_head, DH)
    assert lse.shape == (B, n_head, t) and lse.dtype == torch.float32
    _close(y, want_y)
    _close(ctx, np.asarray(want_ctx).transpose(0, 2, 1, 3))
    _close(lse, want_lse)
    hidden = np.isinf(np.asarray(want_lse))
    assert hidden.any() == (name == "masked_row")
    assert torch.count_nonzero(ctx.transpose(1, 2)[torch.from_numpy(
        hidden)]) == 0


@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", CASES)
def test_backward_twins_match_jax_kernels(name, n_head, t, bias_kind,
                                          causal):
    """#2's twin (dx_q, dW_q, dW_out) and #3's (dx_kv, dW_k, dW_v), from the
    reference's own ctx and lse, against _qkv_bwd_dq_kernel and
    _qkv_bwd_dkv_kernel (interpret); dW_qkv after the port's packing."""
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind, seed=1)
    _, ctx, lse, *want = _jax_kernels(x, w_qkv, w_out, g, bias, n_head,
                                      causal)
    args = [_t(a) for a in (x, w_qkv, w_out, bias, g)]
    args += [torch.from_numpy(np.array(ctx).transpose(0, 2, 1, 3)),
             torch.from_numpy(np.array(lse))]
    kw = dict(n_head=n_head, scale=SCALE, causal=causal)
    dx_q, dw_q, dw_out = ka.qkv_bwd_dq(*args, **kw)
    dx_kv, dw_k, dw_v = ka.qkv_bwd_dkv(*args, **kw)
    hd = n_head * DH
    assert dw_q.shape == dw_k.shape == dw_v.shape == (DM, hd)
    assert dw_out.shape == (hd, DM)
    got = (dx_q, dx_kv, torch.cat([dw_q, dw_k, dw_v], dim=1), dw_out)
    for a, w in zip(got, want):
        _close(a, w)


@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", CASES)
def test_autograd_matches_jax_vjp(name, n_head, t, bias_kind, causal):
    """flash_qkv_attention's output and gradients (x, w_qkv, w_out, and the
    bias where it requires grad) against jax.vjp of the reference's
    flash_qkv_attention(interpret=True)."""
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind, seed=2)
    trainable = bias_kind == "dense"
    kw = dict(n_head=n_head, scale=SCALE, causal=causal)

    def f(x_, w_, o_, b_):
        return jax_attention.flash_qkv_attention(x_, w_, o_, b_,
                                                 interpret=True, **kw)

    primals = [_j(a) for a in (x, w_qkv, w_out)]
    if trainable:
        want, vjp = jax.vjp(f, *primals, _j(bias))
    else:
        want, vjp = jax.vjp(lambda *p: f(*p, _j(bias)), *primals)
    want_grads = vjp(_j(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w_qkv, w_out)]
    b = None if bias is None else _t(bias).requires_grad_(trainable)
    out = ka.flash_qkv_attention(*args, b, **kw)
    out.backward(_t(g))
    _close(out.detach(), want)
    if trainable:
        args.append(b)
    else:
        assert b is None or b.grad is None
    assert len(args) == len(want_grads)
    for a, w in zip(args, want_grads):
        assert a.grad.shape == a.shape
        _close(a.grad, w)


def _composed64(x, w_qkv, w_out, bias, n_head, causal):
    """flash_qkv_attention's function through a plain float64 softmax;
    rows whose max score is <= -1e29 give 0, as the kernels do."""
    b, t, _ = x.shape
    q, k, v = (a.reshape(b, t, n_head, DH)
               for a in torch.split(x @ w_qkv, n_head * DH, dim=-1))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * SCALE
    if bias is not None:
        s = s + bias
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -1e30)
    w = torch.softmax(s, dim=-1).masked_fill(
        s.amax(dim=-1, keepdim=True) <= -1e29, 0.0)
    ctx = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return ctx.reshape(b, t, -1) @ w_out


@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", CASES)
def test_twins_run_float64(name, n_head, t, bias_kind, causal):
    """In float64 the Function's twins agree with autograd through a plain
    float64 softmax to 1e-10: the twins' arithmetic is exact, and only f32
    rounding separates the port from the reference above."""
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind, seed=3)
    trainable = bias_kind == "dense"
    kw = dict(n_head=n_head, causal=causal)
    grads = []
    for fn in (lambda *a: ka.flash_qkv_attention(*a, scale=SCALE, **kw),
               lambda *a: _composed64(*a, **kw)):
        args = [torch.from_numpy(a).double().requires_grad_()
                for a in (x, w_qkv, w_out)]
        b = (None if bias is None
             else torch.from_numpy(bias).double().requires_grad_(trainable))
        out = fn(*args, b)
        assert out.dtype == torch.float64
        out.backward(_t(g).double())
        grads.append([out.detach()] + [a.grad for a in args]
                     + ([b.grad] if trainable else []))
    for got, want in zip(*grads):
        _close(got, want, rtol=1e-10, atol=1e-12)


def test_training_and_serving_paths_give_the_same_output():
    """Under no_grad (serving) and in grad mode (training) the port returns
    the same y, and only grad mode records a backward."""
    x, w_qkv, w_out, _, bias = _inputs(2, 64, "decoder", seed=4)
    args = [_t(a) for a in (x, w_qkv, w_out, bias)]
    with torch.no_grad():
        served = ka.flash_qkv_attention(*args, n_head=2, scale=SCALE)
    assert served.grad_fn is None
    args[0].requires_grad_()
    trained = ka.flash_qkv_attention(*args, n_head=2, scale=SCALE)
    assert trained.grad_fn is not None
    _close(trained.detach(), served, rtol=0, atol=0)


def test_qkv_kernel_wrappers_refuse_non_cpu_tensors():
    """No fallback off the CPU: tensors the kernels cannot take raise, in
    the forward with residuals and in both backward kernels."""
    x, w_qkv, w_out, g, _ = _inputs(2, 64, None)
    meta = [torch.from_numpy(a).to("meta") for a in (x, w_qkv, w_out, g)]
    ctx = torch.zeros(B, 64, 2, DH, device="meta")
    lse = torch.zeros(B, 2, 64, device="meta")
    with pytest.raises(ValueError):
        ka.qkv_attention_fwd(*meta[:3], n_head=2)
    for fn in (ka.qkv_bwd_dq, ka.qkv_bwd_dkv):
        with pytest.raises(ValueError):
            fn(*meta[:3], None, meta[3], ctx, lse, n_head=2)
