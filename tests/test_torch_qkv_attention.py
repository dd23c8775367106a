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
from paddle_tpu_torch.kernels import hash_rng
from test_torch_flash_attention import _split

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


def _inputs(n_head, t, bias_kind, seed=0, dh=DH):
    """x, w_qkv, w_out, g = dL/dy and the case's bias, as numpy f32, at the
    reference test's scales (x 0.3, weights 0.08), for which its atol was
    chosen; heads of width dh."""
    rng = np.random.RandomState(seed)
    hd = n_head * dh
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


def _jax_kernels(x, w_qkv, w_out, g, bias, n_head, causal, rate=0.0,
                 seed=0):
    """(y, ctx [b, h, t, dh], lse, dx_q, dx_kv, dW_qkv, dW_out) from the
    reference's interpret-mode kernels, dW packed as its VJP packs it; at
    weights-dropout ``rate`` under the uint32 ``seed`` (hash masks)."""
    jx, jw, jo, jg, jb = (_j(a) for a in (x, w_qkv, w_out, g, bias))
    ok, bq, bk, interp = jax_attention._qkv_plan(jx, n_head, DH, 512, 512,
                                                 True, bias=jb)
    assert ok and interp  # the fused kernels run, not the composed path
    w3 = jax_attention._prep_w_qkv(jw, n_head, DH)
    wo = jax_attention._prep_w_out(jo, n_head, DH)
    jseed = jnp.asarray([seed], jnp.uint32)
    y, ctx, lse = jax_attention._qkv_forward(
        jx, w3, wo, jb, jseed, SCALE, causal, n_head, DH, bq, bk, True,
        rate, False)
    dx_q, dx_kv, dwq, dwk, dwv, dwo = jax_attention._qkv_backward(
        jx, w3, wo, jb, jseed, ctx, lse, jg, SCALE, causal, n_head, DH, bq,
        bk, True, rate, False)
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


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", CASES)
def test_pair_twin_matches_jax_kernels(name, n_head, t, bias_kind, causal,
                                       rate):
    """The pair's twin (dx, the packed dW_qkv, dW_out), from the
    reference's own ctx and lse, against _qkv_bwd_dq_kernel and
    _qkv_bwd_dkv_kernel together (interpret): dx against dx_q + dx_kv,
    dW_qkv against the reference's _unpack_dw_qkv of dW_q, dW_k, dW_v, at
    rate 0 and at rate 0.1 under one seed (the same hash mask)."""
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind, seed=6)
    seed = 0x9E3779B9 + n_head * t
    _, ctx, lse, dx_q, dx_kv, dw_qkv, dw_out = _jax_kernels(
        x, w_qkv, w_out, g, bias, n_head, causal, rate, seed)
    args = [_t(a) for a in (x, w_qkv, w_out, bias, g)]
    args += [torch.from_numpy(np.array(ctx).transpose(0, 2, 1, 3)),
             torch.from_numpy(np.array(lse))]
    dx, dw, dwo = ka.qkv_bwd(*args, n_head=n_head, scale=SCALE,
                             causal=causal, dropout_rate=rate,
                             dropout_seed=seed)
    hd = n_head * DH
    assert dx.shape == (B, t, DM) and dw.shape == (DM, 3 * hd)
    assert dwo.shape == (hd, DM)
    _close(dx, np.asarray(dx_q) + np.asarray(dx_kv))
    _close(dw, dw_qkv)
    _close(dwo, dw_out)


@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", CASES)
def test_pair_twin_runs_float64(name, n_head, t, bias_kind, causal):
    """In float64, from the float64 twin's ctx and lse, the pair's twin
    gives the gradients of x, w_qkv and w_out that autograd gives through
    a plain float64 softmax, to 1e-10."""
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind, seed=7)
    xd, wd, od, gd = (torch.from_numpy(a).double()
                      for a in (x, w_qkv, w_out, g))
    bd = None if bias is None else torch.from_numpy(bias).double()
    kw = dict(n_head=n_head, scale=SCALE, causal=causal)
    _, ctx, lse = ka.reference_qkv_fwd(xd, wd, od, bd, **kw)
    got = ka.qkv_bwd(xd, wd, od, bd, gd, ctx, lse, **kw)
    params = [a.clone().requires_grad_() for a in (xd, wd, od)]
    want = torch.autograd.grad(
        _composed64(*params, bd, n_head=n_head, causal=causal), params, gd)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        _close(a, w, rtol=1e-10, atol=1e-12)


def _stand_in_library(monkeypatch, b, t, dm, n_head):
    """A recording stand-in for the kernel library, with the operand
    checks stubbed for meta tensors (whose data pointers are 0): returns
    the list of (entry, args) calls it sees."""
    from paddle_tpu_torch.kernels import _build

    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 1 if name.endswith("scratch") else 0
            return entry

    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    monkeypatch.setattr(ka, "sm_count", lambda device: 132)
    monkeypatch.setattr(ka, "_qkv_args", lambda what, x, w_qkv, w_out,
                        bias, n_head, **more: (b, t, dm, n_head * DH,
                                               (0,) * 4, None))
    return calls


def test_backward_makes_one_pair_call(monkeypatch):
    """Off the CPU the autograd backward makes exactly one ptt_qkv_bwd call,
    with both walks, and counts one launch of each of #2 and #3;
    qkv_bwd_dq and qkv_bwd_dkv each call the same entry with their own
    walk and count their own kernel.  A recording stand-in for the
    library sees the calls (meta tensors stand in for the card's)."""
    from paddle_tpu_torch import kernels

    b, t, dm, n_head = 2, 64, 128, 2
    hd = n_head * DH
    calls = _stand_in_library(monkeypatch, b, t, dm, n_head)
    kernels.reset_launches()
    meta = dict(device="meta")
    x = torch.zeros(b, t, dm, **meta, requires_grad=True)
    w_qkv = torch.zeros(dm, 3 * hd, **meta, requires_grad=True)
    w_out = torch.zeros(hd, dm, **meta, requires_grad=True)
    g = torch.zeros(b, t, dm, **meta)
    ka.flash_qkv_attention(x, w_qkv, w_out, None, n_head=n_head,
                           scale=SCALE).backward(g)
    pair = [args for name, args in calls if name == "ptt_qkv_bwd"]
    assert len(pair) == 1
    assert pair[0][0] == ka.WALK_DQ | ka.WALK_DKV == 3
    assert pair[0][16:22] == (b, t, dm, n_head, DH, 132)
    assert ("ptt_qkv_bwd_scratch", (3, b, t, dm, n_head, DH, 132)) in calls
    assert kernels.launches == dict(kernels.launches, qkv_attention_fwd=1,
                                    qkv_bwd_dq=1, qkv_bwd_dkv=1)
    assert not any(n for k, n in kernels.launches.items()
                   if k not in ("qkv_attention_fwd", "qkv_bwd_dq",
                                "qkv_bwd_dkv"))
    assert x.grad.shape == x.shape and w_qkv.grad.shape == w_qkv.shape
    assert w_out.grad.shape == w_out.shape

    ctx = torch.zeros(b, t, n_head, DH, **meta)
    lse = torch.zeros(b, n_head, t, **meta)
    args = (x.detach(), w_qkv.detach(), w_out.detach(), None, g, ctx, lse)
    for fn, walk, name, shapes in (
            (ka.qkv_bwd_dq, ka.WALK_DQ, "qkv_bwd_dq",
             [(b, t, dm), (dm, hd), (hd, dm)]),
            (ka.qkv_bwd_dkv, ka.WALK_DKV, "qkv_bwd_dkv",
             [(b, t, dm), (dm, hd), (dm, hd)])):
        calls.clear()
        kernels.reset_launches()
        out = fn(*args, n_head=n_head, scale=SCALE)
        assert [a[0] for n, a in calls if n == "ptt_qkv_bwd"] == [walk]
        assert {k: n for k, n in kernels.launches.items() if n} == {name: 1}
        assert [tuple(a.shape) for a in out] == shapes
    kernels.reset_launches()


def test_pair_refuses_non_cpu_tensors():
    """No fallback off the CPU: the pair's wrapper raises on tensors the
    kernels cannot take, as #2's and #3's do."""
    x, w_qkv, w_out, g, _ = _inputs(2, 64, None)
    meta = [torch.from_numpy(a).to("meta") for a in (x, w_qkv, w_out, g)]
    ctx = torch.zeros(B, 64, 2, DH, device="meta")
    lse = torch.zeros(B, 2, 64, device="meta")
    with pytest.raises(ValueError):
        ka.qkv_bwd(*meta[:3], None, meta[3], ctx, lse, n_head=2)


#: the pair's three GEMM layouts at a small size: (name, a [M, K] given
#: row-major or as a transposed view, b likewise, a k-major, b k-major)
GEMM_LAYOUTS = [("dx = dqkv w_qkv^T", False, True, False, False),
                ("dW = x^T dqkv", True, False, True, True),
                ("qkv = x w_qkv", False, False, False, True)]


@pytest.mark.parametrize("name,a_t,b_t,a_km,b_km", GEMM_LAYOUTS)
def test_gemm_passes_layouts_to_the_entry_point(monkeypatch, name, a_t, b_t,
                                                a_km, b_km):
    """The exported GEMM's wrapper reads each operand's layout from its
    strides and hands ptt_gemm the operand's row stride and whether it is
    k-major, the shape and the card's SM count, and counts one launch; on
    CPU tensors it is a @ b."""
    from paddle_tpu_torch import kernels
    from paddle_tpu_torch.kernels import gemm as kg

    m, n, k = 96, 80, 48
    rng = np.random.RandomState(8)
    a_np = rng.randn(m, k).astype(np.float32)
    b_np = rng.randn(k, n).astype(np.float32)
    a = torch.from_numpy(a_np.T.copy()).t() if a_t else _t(a_np)
    b = torch.from_numpy(b_np.T.copy()).t() if b_t else _t(b_np)
    _close(kg.gemm(a, b), a_np.astype(np.float64) @ b_np, atol=1e-5)
    assert kg.operands(a, b)[3:] == ((m if a_km else k, a_km),
                                     (n if b_km else k, b_km))
    calls = _stand_in_library(monkeypatch, 1, 1, 1, 1)
    monkeypatch.setattr(ka, "sm_count", lambda device: 114)
    monkeypatch.setattr(kg, "_require_card", lambda a, b: None)
    kernels.reset_launches()
    c = kg.gemm(a.to("meta"), b.to("meta"))
    assert c.shape == (m, n) and c.device.type == "meta"
    (entry, args), = [c for c in calls if c[0] == "ptt_gemm"]
    assert args[1:3] == ((m if a_km else k), int(a_km))
    assert args[4:6] == ((n if b_km else k), int(b_km))
    assert args[7:11] == (n, m, n, k) and args[12] == 114
    assert {k_: v for k_, v in kernels.launches.items() if v} == {"gemm": 1}
    kernels.reset_launches()


def test_gemm_refuses_what_is_not_compiled():
    """Both operands transposed (A k-major with B not) has no kernel, a
    shape mismatch none either, and a device other than the CPU or a
    card raises: no fallback."""
    from paddle_tpu_torch.kernels import gemm as kg

    with pytest.raises(ValueError, match="not compiled"):
        kg.operands(torch.zeros(48, 96).t(), torch.zeros(80, 48).t())
    with pytest.raises(ValueError, match="shapes"):
        kg.operands(torch.zeros(4, 5), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        kg.gemm(torch.zeros(4, 4, device="meta"),
                torch.zeros(4, 4, device="meta"))


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


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("n_head", [8, 12])
@pytest.mark.parametrize("b", [1, 64])
def test_qkv_fwd_plan_covers_every_length(b, n_head, sms):
    """#1's plan for every t in 1..1024 on a card of ``sms`` SMs (the
    H100 SXM's 132, the PCIe's 114): a cluster of C <= 8 blocks of R in
    {32, 64} rows that covers t with a last block holding at least one row
    up to t = 512, R = 32 exactly where the 64-row grid would fill fewer
    than the card's SMs and 32-row blocks still fit a cluster, and the
    tiles route beyond."""
    for t in range(1, 1025):
        plan = ka.qkv_fwd_plan(b, t, n_head, sms)
        if t > 512:
            assert plan == ("tiles",), (t, plan)
            continue
        route, c, r = plan
        assert route == "cluster" and r in (32, 64), (t, plan)
        assert 1 <= c <= ka.CLUSTER_MAX, (t, plan)
        assert c * r >= t and c * r - t < r, (t, plan)
        small = (b * n_head * -(-t // 64) < sms
                 and -(-t // 32) <= ka.CLUSTER_MAX)
        assert (r == 32) == small, (t, plan)
    assert ka.qkv_fwd_plan(1, 256, 8, sms) == ("cluster", 8, 32)
    assert ka.qkv_fwd_plan(64, 256, 8, sms) == ("cluster", 4, 64)


@pytest.mark.parametrize("b,t,rows", [(1, 256, 32), (64, 256, 64),
                                      (2, 512, 64), (2, 640, 0)])
def test_launch_passes_the_plan_to_the_entry_point(monkeypatch, b, t, rows):
    """#1's wrapper chooses the route from the shape and the device's SM
    count before the launch and hands it to the C entry point (the
    cluster's rows; 0 for the tiles route): a recording stand-in for the
    library sees the plan."""
    from paddle_tpu_torch.kernels import _build

    n_head, dm = 8, 512
    seen = []

    class Lib:
        def ptt_qkv_fwd_scratch(self, *args):
            return 1

        def ptt_qkv_attention_fwd(self, *args):
            seen.append(args)
            return 0

    monkeypatch.setattr(_build, "lib", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda x: 0)
    monkeypatch.setattr(ka, "sm_count", lambda device: 132)
    monkeypatch.setattr(ka, "_qkv_args", lambda what, x, w_qkv, w_out,
                        bias, n_head: (b, t, dm, n_head * DH, (0,) * 4,
                                       None))
    x = torch.zeros(b, t, dm)
    ka._launch_qkv_fwd(x, torch.zeros(dm, 3 * dm), torch.zeros(dm, dm),
                       None, n_head, SCALE, False, 0.0, 0)
    assert len(seen) == 1
    assert seen[0][12:18] == (b, t, dm, n_head, DH, rows)


#: head width 128 (C2): (name, t, bias kind, causal) at 2 heads
W128_CASES = [("pad", 32, "pad", False), ("causal_decoder", 32, "decoder",
                                          True)]


@pytest.mark.parametrize("name,t,bias_kind,causal", W128_CASES)
def test_head_width_128_matches_jax_kernels(name, t, bias_kind, causal):
    """At head width 128 the reference's plan launches its fused kernels
    (interpret mode here), and the port's twins, which its wrappers run on
    CPU tensors, give their result: the output and the gradients of x,
    w_qkv and w_out against jax.vjp of the reference's
    flash_qkv_attention, at the reference's tolerance.  (On the card #1's
    f32 forward is compiled for this width, and serving launches it; the
    pair #2 + #3 is not, so a call that needs a gradient raises.)"""
    dh, n_head = 128, 2
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind, seed=5, dh=dh)
    kw = dict(n_head=n_head, scale=dh ** -0.5, causal=causal)
    ok = jax_attention._qkv_plan(_j(x), n_head, dh, 512, 512, True,
                                 bias=_j(bias))[0]
    assert ok  # the reference's fused kernels run, not its composition

    def f(*p):
        return jax_attention.flash_qkv_attention(*p, _j(bias),
                                                 interpret=True, **kw)

    want, vjp = jax.vjp(f, *(_j(a) for a in (x, w_qkv, w_out)))
    want_grads = vjp(_j(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w_qkv, w_out)]
    out = ka.flash_qkv_attention(*args, _t(bias), **kw)
    out.backward(_t(g))
    _close(out.detach(), want)
    for a, w in zip(args, want_grads):
        _close(a.grad, w)


#: bf16 (amp): the same bf16 operands on both sides, f32 arithmetic in
#: other orders, each output rounded to bf16 (8 significant bits): one
#: bf16 step apart at most, 2^-7 of the value.  Intermediates are rounded
#: too (the ctx y reads; the reference's dx in two halves dx_q, dx_kv
#: before their sum), and where a sum cancels such a step stays at the
#: scale of the terms: so each element is held within RTOL_BF16 of its
#: value plus one bf16 step (2^-8) of the tensor's largest element; dx
#: (rounded twice in the reference) within two.  lse is f32 on both sides.
RTOL_BF16 = 2.0 ** -7


def _close_bf16(got, want, steps=1):
    want = np.asarray(want, np.float64)
    _close(got, want, steps * RTOL_BF16,
           steps * 2.0 ** -8 * np.abs(want).max())


BF16_CASES = [("pad", 2, 128, "pad", False), ("causal", 3, 64, None, True),
              ("masked_row", 2, 64, "masked", False)]


def _bf16(*arrays):
    """numpy f32 -> (torch bf16, jax bf16) pairs of the same values."""
    return [(None, None) if a is None else
            (torch.from_numpy(a).bfloat16(),
             jnp.asarray(a).astype(jnp.bfloat16)) for a in arrays]


@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", BF16_CASES)
def test_bf16_twins_match_jax_kernels(name, n_head, t, bias_kind, causal):
    """#1's twin (y, ctx, lse) and the pair's (dx, dW_qkv, dW_out) on bf16
    operands (the bias too, as amp casts it) against _qkv_forward and
    _qkv_backward in interpret mode on the same bf16 operands: y, ctx, dx,
    dW in bf16 by _close_bf16 (dx two steps), lse f32 within 1e-5."""
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind, seed=3)
    (tx, jx), (tw, jw), (to, jo), (tg, jg), (tb, jb) = _bf16(
        x, w_qkv, w_out, g, bias)
    ok, bq, bk, _ = jax_attention._qkv_plan(jx, n_head, DH, 512, 512, True,
                                            bias=jb)
    assert ok
    w3 = jax_attention._prep_w_qkv(jw, n_head, DH)
    wo = jax_attention._prep_w_out(jo, n_head, DH)
    zero = jnp.zeros((1,), jnp.uint32)
    y, ctx, lse = jax_attention._qkv_forward(
        jx, w3, wo, jb, zero, SCALE, causal, n_head, DH, bq, bk, True, 0.0,
        False)
    dx_q, dx_kv, dwq, dwk, dwv, dwo = jax_attention._qkv_backward(
        jx, w3, wo, jb, zero, ctx, lse, jg, SCALE, causal, n_head, DH, bq,
        bk, True, 0.0, False)
    assert y.dtype == ctx.dtype == dx_q.dtype == jnp.bfloat16
    kw = dict(n_head=n_head, scale=SCALE, causal=causal)
    got_y, got_ctx, got_lse = ka.qkv_attention_fwd(tx, tw, to, tb, **kw)
    assert got_y.dtype == got_ctx.dtype == torch.bfloat16
    assert got_lse.dtype == torch.float32

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    _close_bf16(got_y.float(), f32(y))
    _close_bf16(got_ctx.float().transpose(1, 2), f32(ctx))
    live = ~np.isinf(f32(lse))
    _close(got_lse.numpy()[live], f32(lse)[live], 1e-5, 1e-5)
    dx, dw_qkv, dw_out = ka.qkv_bwd(tx, tw, to, tb, tg, got_ctx, got_lse,
                                    **kw)
    assert dx.dtype == dw_qkv.dtype == dw_out.dtype == torch.bfloat16
    want_dx = (dx_q.astype(jnp.float32) + dx_kv.astype(jnp.float32)).astype(
        jnp.bfloat16)
    _close_bf16(dx.float(), f32(want_dx), 2)
    _close_bf16(dw_qkv.float(), f32(jax_attention._unpack_dw_qkv(
        dwq, dwk, dwv, jnp.float32)))
    _close_bf16(dw_out.float(), f32(dwo.reshape(n_head * DH, DM)))


def test_bf16_autograd_matches_jax_vjp():
    """The Function on bf16 leaves (causal, padding bias) against jax.vjp
    of the reference's flash_qkv_attention in interpret mode: y and the
    gradients of x, w_qkv and w_out in bf16, within the tolerances
    above."""
    x, w_qkv, w_out, g, bias = _inputs(2, 64, "pad", seed=4)
    (tx, jx), (tw, jw), (to, jo), (tg, jg), (tb, jb) = _bf16(
        x, w_qkv, w_out, g, bias)
    want, vjp = jax.vjp(lambda a, w, o: jax_attention.flash_qkv_attention(
        a, w, o, jb, n_head=2, scale=SCALE, causal=True, interpret=True),
        jx, jw, jo)
    want_grads = vjp(jg)
    leaves = [a.clone().requires_grad_() for a in (tx, tw, to)]
    y = ka.flash_qkv_attention(*leaves, tb, n_head=2, scale=SCALE,
                               causal=True)
    y.backward(tg)
    assert y.dtype == torch.bfloat16

    def f32(a):
        return np.asarray(a.astype(jnp.float32))

    _close_bf16(y.detach().float(), f32(want))
    for leaf, w, steps in zip(leaves, want_grads, (2, 1, 1)):
        assert leaf.grad.dtype == torch.bfloat16
        _close_bf16(leaf.grad.float(), f32(w), steps)


# ---------------------------------------------------------------------------
# #1 in bf16 on tensor cores (csrc/qkv_attention.cu qkv_cluster_tc_kernel,
# csrc/gemm.cuh gemm_tc): its numerics, emulated
# ---------------------------------------------------------------------------


def _tc_qkv_forward(x, w_qkv, w_out, bias, n_head, scale, causal, rate,
                    seed, rows):
    """#1's arithmetic on the card, in PyTorch: the projections of the
    bf16 x and W (exact products, f32 sums); q * scale, k and v split
    into hi/lo bf16s; s = q_lo k_hi + q_hi k_lo + q_hi k_hi, plus the
    bias; the online softmax over key tiles of ``rows`` (the plan's R) in
    f32 (l over the undropped p); each tile's p, dropped, split, and p v =
    p_lo v_hi + p_hi v_lo + p_hi v_hi; ctx = acc / l rounded to bf16; y =
    ctx W_out (exact products, f32 sums) rounded to bf16.  Returns (y, ctx
    [b, t, h, dh], lse [b, h, t])."""
    b, t, _ = x.shape
    hd = w_qkv.shape[1] // 3
    q, k, v = (a.reshape(b, t, n_head, hd // n_head).transpose(1, 2)
               for a in (x.float() @ w_qkv.float()).split(hd, -1))
    (qh, ql), (kh, kl), (vh, vl) = _split(q * scale), _split(k), _split(v)
    s = (ql @ kh.transpose(-1, -2) + qh @ kl.transpose(-1, -2)
         + qh @ kh.transpose(-1, -2))
    if bias is not None:
        s = s + bias.float()
    if causal:
        s = s.masked_fill(~ka._causal_keep(t, t, s.device), ka.MASK_VALUE)
    keep = hash_rng.keep_mask_attn(seed, s.shape, rate) if rate else None
    m = torch.full(s.shape[:-1] + (1,), -np.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (vh.shape[-1],))
    for k0 in range(0, t, rows):
        st = s[..., k0:k0 + rows]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + rows], p, 0.0)
        p_hi, p_lo = _split(p)
        tile = slice(k0, k0 + rows)
        acc = (acc * alpha + p_lo @ vh[..., tile, :] + p_hi @ vl[..., tile, :]
               + p_hi @ vh[..., tile, :])
        m = m_new
    masked = (l == 0) | (m <= -1e29)
    ctx = (acc * ((1.0 / (1.0 - rate) if rate else 1.0) / l)).masked_fill(
        masked, 0.0).transpose(1, 2).bfloat16()
    lse = (m + torch.log(l)).masked_fill(masked, np.inf)[..., 0]
    y = ctx.float().reshape(b, t, hd) @ w_out.float()
    return y.bfloat16(), ctx, lse


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", BF16_CASES)
def test_tensor_core_numerics_match_jax_kernel(name, n_head, t, bias_kind,
                                               causal, rate):
    """The emulated arithmetic of #1's tensor-core kernels (exact bf16
    products for the projections and y; q, k, v and p split into hi/lo
    for the three-term s and p v), key tiles of the plan's R, against
    _qkv_forward in interpret mode on the same bf16 operands and hash
    mask: y and ctx within _close_bf16, lse within 1e-5, the same masked
    rows."""
    x, w_qkv, w_out, _, bias = _inputs(n_head, t, bias_kind, seed=3)
    (tx, jx), (tw, jw), (to, jo), (tb, jb) = _bf16(x, w_qkv, w_out, bias)
    seed = 0x2545F491
    ok, bq, bk, _ = jax_attention._qkv_plan(jx, n_head, DH, 512, 512, True,
                                            bias=jb)
    assert ok
    y, ctx, lse = jax_attention._qkv_forward(
        jx, jax_attention._prep_w_qkv(jw, n_head, DH),
        jax_attention._prep_w_out(jo, n_head, DH), jb,
        jnp.asarray([seed], jnp.uint32), SCALE, causal, n_head, DH, bq, bk,
        True, rate, False)
    plan = ka.qkv_fwd_plan(B, t, n_head, 132)
    assert plan[0] == "cluster"
    qkv = tx.float() @ tw.float()  # the f32 projections the kernel splits
    hi, lo = _split(qkv)
    assert ((hi + lo - qkv).abs() <= 2.0 ** -16 * qkv.abs()).all()
    got_y, got_ctx, got_lse = _tc_qkv_forward(
        tx, tw, to, tb, n_head, SCALE, causal, rate, seed, plan[2])

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    want_lse = f32(lse)
    live = ~np.isinf(want_lse)
    assert np.array_equal(np.isinf(got_lse.numpy()), ~live)
    _close(got_lse.numpy()[live], want_lse[live], 1e-5, 1e-5)
    _close_bf16(got_ctx.float().transpose(1, 2), f32(ctx))
    _close_bf16(got_y.float(), f32(y))


# ---------------------------------------------------------------------------
# the pair #2 + #3 in bf16 on tensor cores (csrc/qkv_attention_bwd.cu with
# csrc/flash_bwd_tc.cuh and gemm.cuh's gemm_tc): its numerics, emulated
# ---------------------------------------------------------------------------


def _mma3(a, b):
    """A product of two f32 operands as the walks take it: a and b split
    into hi/lo bf16s, hi hi + hi lo + lo hi summed in f32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def _tc_qkv_backward(x, w_qkv, w_out, bias, g, ctx, lse, n_head, scale,
                     causal, rate, seed):
    """The pair's arithmetic on the card, in PyTorch: the projections q |
    k | v = x W_qkv and dctx = g W_out^T of the bf16 operands (exact
    products, f32 sums), delta = rowsum(dctx * ctx) from the f32 dctx;
    q, k, v and dctx split into hi/lo bf16s; s = q k^T and dp = dctx v^T
    as three-term products; p = exp(s * scale + bias - lse) (0 at causally
    hidden keys), dp dropped and scaled, ds = p (dp - delta) * scale; dq =
    ds k, dk = ds^T q and dv = p_d^T dctx (p_d: p dropped and scaled) as
    three-term products; dq | dk | dv split, and dx = [dq | dk | dv]
    W_qkv^T and dW_qkv = x^T [dq | dk | dv] as two-term products (hi and
    lo times the bf16 operand); dW_out = ctx^T g.  dx, dW_qkv and dW_out
    rounded to bf16 once.  ctx [b, t, h, dh] bf16, lse [b, h, t] f32."""
    b, t, dm = x.shape
    hd = w_qkv.shape[1] // 3
    dh = hd // n_head

    def heads(a):  # [b, t, hd] -> [b, h, t, dh]
        return a.reshape(b, t, n_head, dh).transpose(1, 2)

    q, k, v = (heads(a) for a in (x.float() @ w_qkv.float()).split(hd, -1))
    dctx = heads(g.float() @ w_out.float().t())
    delta = (dctx * ctx.float().transpose(1, 2)).sum(-1, keepdim=True)
    s = _mma3(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~ka._causal_keep(t, t, p.device), 0.0)
    dp = _mma3(dctx, v.transpose(-1, -2))
    p_d = p
    if rate:
        keep = hash_rng.keep_mask_attn(seed, p.shape, rate)
        inv_keep = float(np.float32(1.0 / (1.0 - rate)))
        p_d = torch.where(keep, p * inv_keep, 0.0)
        dp = torch.where(keep, dp * inv_keep, 0.0)
    ds = p * (dp - delta) * scale
    dq = _mma3(ds, k)
    dk = _mma3(ds.transpose(-1, -2), q)
    dv = _mma3(p_d.transpose(-1, -2), dctx)
    dqkv = torch.cat([a.transpose(1, 2).reshape(b * t, hd)
                      for a in (dq, dk, dv)], 1)
    hi, lo = _split(dqkv)
    w = w_qkv.float()
    xt = x.float().reshape(b * t, dm).t()
    dx = hi @ w.t() + lo @ w.t()
    dw = xt @ hi + xt @ lo
    dw_out = ctx.float().reshape(b * t, hd).t() @ g.float().reshape(b * t,
                                                                    dm)
    return (dx.reshape(b, t, dm).bfloat16(), dw.bfloat16(),
            dw_out.bfloat16())


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", BF16_CASES)
def test_pair_tensor_core_numerics_match_jax_kernels(name, n_head, t,
                                                     bias_kind, causal,
                                                     rate):
    """The emulated arithmetic of the pair's tensor-core kernels (exact
    bf16 projections, dW_out and dctx; q, k, v, dctx, p, ds and dq | dk |
    dv split into hi/lo; three-term t x t products, two-term dx and dW)
    on bf16 operands and _qkv_forward's ctx and lse, against
    _qkv_backward in interpret mode on the same bf16 operands, residuals
    and hash mask: dx (two steps), dW_qkv and dW_out within
    _close_bf16."""
    x, w_qkv, w_out, g, bias = _inputs(n_head, t, bias_kind, seed=3)
    (tx, jx), (tw, jw), (to, jo), (tg, jg), (tb, jb) = _bf16(
        x, w_qkv, w_out, g, bias)
    seed = 0x2545F491
    ok, bq, bk, _ = jax_attention._qkv_plan(jx, n_head, DH, 512, 512, True,
                                            bias=jb)
    assert ok
    w3 = jax_attention._prep_w_qkv(jw, n_head, DH)
    wo = jax_attention._prep_w_out(jo, n_head, DH)
    seeds = jnp.asarray([seed], jnp.uint32)
    _, ctx, lse = jax_attention._qkv_forward(
        jx, w3, wo, jb, seeds, SCALE, causal, n_head, DH, bq, bk, True,
        rate, False)
    dx_q, dx_kv, dwq, dwk, dwv, dwo = jax_attention._qkv_backward(
        jx, w3, wo, jb, seeds, ctx, lse, jg, SCALE, causal, n_head, DH, bq,
        bk, True, rate, False)

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    t_ctx = torch.from_numpy(np.array(f32(ctx))).transpose(1, 2).bfloat16()
    t_lse = torch.from_numpy(np.array(f32(lse)))
    dx, dw_qkv, dw_out = _tc_qkv_backward(tx, tw, to, tb, tg, t_ctx, t_lse,
                                          n_head, SCALE, causal, rate, seed)
    want_dx = (dx_q.astype(jnp.float32) + dx_kv.astype(jnp.float32)).astype(
        jnp.bfloat16)
    _close_bf16(dx.float(), f32(want_dx), 2)
    _close_bf16(dw_qkv.float(), f32(jax_attention._unpack_dw_qkv(
        dwq, dwk, dwv, jnp.float32)))
    _close_bf16(dw_out.float(), f32(dwo.reshape(n_head * DH, DM)))
