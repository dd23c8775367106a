"""paddle_tpu_torch flash_attention (fmt="bthd") against the JAX package,
on the CPU.

On CPU tensors the port's autograd.Function runs the plain twins of its
three kernels (#4 forward, #6 dq, #7 dk/dv), so these tests hold that
arithmetic and the Function's wiring against the reference's Pallas
kernels in interpret mode (``_flash_forward``, ``_flash_backward`` and
``jax.vjp`` of ``flash_attention``) and against autograd through a plain
float64 softmax.  The CUDA kernels are held against the same twins on the
card by chip_smoke.py.  Inputs are numpy arrays from seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels import attention as jax_attention
from paddle_tpu_torch.kernels import attention as ka
from paddle_tpu_torch.kernels import hash_rng

#: f32 on both sides; the packages sum in different orders
TOL = 1e-5
B, H, D = 2, 2, 64
SCALE = D ** -0.5

#: (name, tq, tk, bias kind, causal): the reference's bias shapes, causal
#: with tq < tk and tq > tk (its first tq - tk rows see no key), a row
#: masked by a -1e30 bias, and three ragged cases (lengths that are
#: multiples of neither 64 nor 128, as the card's walks tile them; 129
#: crosses the forward's 128-row block by one)
CASES = [
    ("no_bias", 32, 32, None, False),
    ("key_padding", 32, 64, "pad", False),
    ("full_q_bias", 32, 32, "full", False),
    ("per_head", 32, 64, "head", False),
    ("causal_tq_lt_tk", 32, 64, None, True),
    ("causal_tq_gt_tk", 64, 32, "pad", True),
    ("masked_row", 64, 64, "masked", False),
    ("ragged_pad", 40, 72, "pad", False),
    ("ragged_causal_masked_row", 72, 40, "masked", True),
    ("ragged_causal_129", 129, 129, "full", True),
]


def _inputs(tq, tk, bias_kind, seed=0, d=D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, tq, H, d).astype(np.float32)
    k = rng.randn(B, tk, H, d).astype(np.float32)
    v = rng.randn(B, tk, H, d).astype(np.float32)
    g = rng.randn(B, tq, H, d).astype(np.float32)
    if bias_kind == "pad":  # [b, 1, 1, tk], lane 1 with a padded tail
        bias = np.zeros((B, 1, 1, tk), np.float32)
        bias[1, ..., tk - 7:] = -1e9
    elif bias_kind == "full":  # decoder-style [b, 1, tq, tk]
        bias = (rng.randn(B, 1, tq, tk) * 0.5).astype(np.float32)
        bias[:, :, :, -3:] = -1e9
    elif bias_kind == "head":
        bias = (rng.randn(1, H, tq, tk) * 0.5).astype(np.float32)
    elif bias_kind == "masked":  # row 5 of lane 1 sees nothing
        bias = np.zeros((B, 1, tq, tk), np.float32)
        bias[1, 0, 5, :] = -1e30
    else:
        bias = None
    return q, k, v, g, bias


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _jax_kernels(q, k, v, g, bias, causal):
    """(out, lse, dq, dk, dv) from the reference's interpret-mode
    kernels."""
    jq, jk, jv, jg, jb = (_j(a) for a in (q, k, v, g, bias))
    ok, bq, bk, interp = jax_attention._plan(jq, jk, 512, 512, True, "bthd")
    assert ok and interp  # d = 64: the kernels run, not the XLA fallback
    seed = jnp.zeros((1,), jnp.uint32)
    out, lse = jax_attention._flash_forward(jq, jk, jv, jb, seed, SCALE,
                                            causal, bq, bk, True, "bthd")
    dq, dk, dv = jax_attention._flash_backward(
        jq, jk, jv, jb, seed, out, lse, jg, SCALE, causal, bq, bk, True,
        "bthd")
    return out, lse, dq, dk, dv


@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", CASES)
def test_forward_matches_jax_kernel(name, tq, tk, bias_kind, causal):
    """Output and lse of #4's twin against _fwd_kernel_bthd (interpret),
    1e-5 abs and rel; masked rows give 0 and lse = +inf in both."""
    q, k, v, g, bias = _inputs(tq, tk, bias_kind)
    want_out, want_lse = _jax_kernels(q, k, v, g, bias, causal)[:2]
    out, lse = ka.flash_fwd(*(_t(a) for a in (q, k, v, bias)), SCALE,
                            causal)
    assert out.shape == (B, tq, H, D) and lse.shape == (B, H, tq)
    _close(out, want_out)
    _close(lse, want_lse)
    hidden = np.isinf(np.asarray(want_lse))
    assert (hidden.any() == (name in ("causal_tq_gt_tk", "masked_row",
                                      "ragged_causal_masked_row")))
    assert torch.count_nonzero(out.transpose(1, 2)[torch.from_numpy(
        hidden)]) == 0


@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", CASES)
def test_backward_matches_jax_kernels(name, tq, tk, bias_kind, causal):
    """dq (#6's twin) and dk, dv (#7's twin), from the same out, lse and
    dO, against _bwd_dq_kernel_bthd and _bwd_dkv_kernel_bthd (interpret),
    1e-5 abs and rel."""
    q, k, v, g, bias = _inputs(tq, tk, bias_kind, seed=1)
    out, lse, *want = _jax_kernels(q, k, v, g, bias, causal)
    tq_, tk_, tv_, tg_, tb_ = (_t(a) for a in (q, k, v, g, bias))
    o_, lse_ = (torch.from_numpy(np.array(a)) for a in (out, lse))
    delta = (tg_ * o_).sum(-1).transpose(1, 2).contiguous()
    dq = ka.flash_bwd_dq(tq_, tk_, tv_, tb_, tg_, lse_, delta, SCALE, causal)
    dk, dv = ka.flash_bwd_dkv(tq_, tk_, tv_, tb_, tg_, lse_, delta, SCALE,
                              causal)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w)


@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", CASES)
def test_autograd_matches_jax_vjp(name, tq, tk, bias_kind, causal):
    """The port's differentiable flash_attention against jax.vjp of the
    reference's flash_attention (kernels in interpret mode), output and
    dq, dk, dv, 1e-5 abs and rel."""
    q, k, v, g, bias = _inputs(tq, tk, bias_kind, seed=2)

    def f(q_, k_, v_):
        return jax_attention.flash_attention(
            q_, k_, v_, _j(bias), scale=SCALE, causal=causal, fmt="bthd",
            interpret=True)

    want, vjp = jax.vjp(f, *(_j(a) for a in (q, k, v)))
    want_grads = vjp(_j(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ka.flash_attention(*args, _t(bias), scale=SCALE, causal=causal,
                             fmt="bthd")
    out.backward(_t(g))
    _close(out.detach(), want)
    for a, w in zip(args, want_grads):
        _close(a.grad, w)


def _composed64(q, k, v, bias, causal):
    """softmax(q k^T * scale + bias) v in float64 autograd; rows whose
    max is <= -1e29 give 0, as the kernels do."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * SCALE
    if bias is not None:
        s = s + bias
    if causal:
        tq, tk = s.shape[-2:]
        keep = torch.ones(tq, tk, dtype=torch.bool).tril(tk - tq)
        s = s.masked_fill(~keep, -1e30)
    w = torch.softmax(s, dim=-1).masked_fill(
        s.amax(dim=-1, keepdim=True) <= -1e29, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", CASES)
def test_autograd_matches_float64_composition(name, tq, tk, bias_kind,
                                              causal):
    """The Function's gradients against torch autograd through a plain
    float64 softmax, 1e-5 abs and rel (the port runs f32).  A bias that
    requires grad gets dbias reduced to its own shape; a mask that does
    not gets none."""
    q, k, v, g, bias = _inputs(tq, tk, bias_kind, seed=3)
    trainable = bias_kind in ("full", "head")
    x32 = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    x64 = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    b32 = b64 = None
    if bias is not None:
        b32 = torch.from_numpy(bias).requires_grad_(trainable)
        b64 = torch.from_numpy(bias).double().requires_grad_(trainable)
    out = ka.flash_attention(*x32, b32, scale=SCALE, causal=causal,
                             fmt="bthd")
    out.backward(_t(g))
    want = _composed64(*x64, b64, causal)
    want.backward(_t(g).double())
    _close(out.detach(), want.detach())
    for a, w in zip(x32, x64):
        _close(a.grad, w.grad)
    if trainable:
        assert b32.grad.shape == b32.shape
        _close(b32.grad, b64.grad)
    elif b32 is not None:
        assert b32.grad is None


def test_trainable_bias_grad_matches_jax():
    """dbias of a per-head bias against the reference's _dbias_xla (through
    jax.vjp), 1e-5 abs and rel."""
    q, k, v, g, bias = _inputs(32, 64, "head", seed=4)
    _, vjp = jax.vjp(lambda b_: jax_attention.flash_attention(
        _j(q), _j(k), _j(v), b_, scale=SCALE, fmt="bthd", interpret=True),
        _j(bias))
    (want,) = vjp(_j(g))
    b = torch.from_numpy(bias).requires_grad_()
    ka.flash_attention(*(_t(a) for a in (q, k, v)), b,
                       scale=SCALE, fmt="bthd").backward(_t(g))
    _close(b.grad, want)


def test_bias_broadcasts_without_a_copy():
    """A [tk]-only bias gives what its [b, 1, 1, tk] broadcast gives."""
    q, k, v, g, bias = _inputs(32, 64, "pad", seed=5)
    args = [_t(a) for a in (q, k, v)]
    row = torch.from_numpy(bias[1, 0, 0])
    full = torch.from_numpy(bias[1:2]).expand(B, 1, 1, 64)
    _close(ka.flash_attention(*args, row, scale=SCALE, fmt="bthd"),
           ka.flash_attention(*args, full, scale=SCALE, fmt="bthd"), 0.0)
    with pytest.raises(ValueError):
        ka.flash_attention(*args, torch.zeros(3, 1, 1, 64), fmt="bthd")


def test_bhtd_format_raises():
    """fmt="bhtd" reads [b, h, t, d]: a bthd-shaped cross call (tq 32, tk
    64 on axis 1) passed as bhtd gives q and k different head counts and
    raises, as does an unknown layout; nothing attends over the wrong
    axis."""
    q, k, v, _, _ = _inputs(32, 64, None)
    with pytest.raises(ValueError, match="are not"):
        ka.flash_attention(*(_t(a) for a in (q, k, v)), fmt="bhtd")
    with pytest.raises(ValueError, match="unknown fmt"):
        ka.flash_attention(*(_t(a) for a in (q, k, v)), fmt="bt")


def test_reference_style_call_raises():
    """flash_attention(q, k, v, bias) on [B, H, T, D] tensors, as the
    reference is called (its default fmt is "bhtd"), gives the reference's
    bhtd result (its interpret-mode #5), 1e-5, and the [B, T, H, D]
    result transposed; only a bias that does not broadcast raises."""
    q, k, v, _, bias = _inputs(32, 32, "full")
    bhtd = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v)]
    want = jax_attention.flash_attention(
        *(_j(a) for a in bhtd), _j(bias), scale=SCALE, interpret=True)
    got = ka.flash_attention(*(_t(a) for a in bhtd), _t(bias), scale=SCALE)
    assert got.shape == (B, H, 32, D)
    _close(got, want)
    _close(got, ka.flash_attention(*(_t(a) for a in (q, k, v)), _t(bias),
                                   scale=SCALE, fmt="bthd").transpose(1, 2))
    with pytest.raises(ValueError, match="does not broadcast"):
        ka.flash_attention(*(_t(a) for a in bhtd), torch.zeros(3, 1, 1, 32))


def test_dropout_raises():
    """Weights dropout raises without a seed (no mask can be drawn);
    with one it drops: the output differs from the undropped one, and the
    same seed gives the same bits."""
    q, k, v, _, _ = _inputs(32, 32, None)
    args = [_t(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="needs dropout_seed"):
        ka.flash_attention(*args, dropout_rate=0.1, fmt="bthd")
    out = ka.flash_attention(*args, scale=SCALE, dropout_rate=0.1,
                             dropout_seed=7, fmt="bthd")
    assert not torch.equal(out, ka.flash_attention(*args, scale=SCALE,
                                                   fmt="bthd"))
    assert torch.equal(out, ka.flash_attention(*args, scale=SCALE,
                                               dropout_rate=0.1,
                                               dropout_seed=7, fmt="bthd"))


def test_fused_qkv_attention_refuses_to_train():
    """#1 refuses to train only with dropout and no seed: in grad mode
    with a trainable input and dropout_rate > 0 but no dropout_seed it
    raises, never returning a result without its gradient.  With a seed,
    and without dropout, it trains (the backward runs #2 and #3), and
    under no_grad it runs as the serving path does."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 16, 128).astype(np.float32))
    w_qkv = torch.from_numpy((rng.randn(128, 384) * 0.08).astype(np.float32))
    w_out = torch.from_numpy((rng.randn(128, 128) * 0.08).astype(np.float32))
    w_qkv.requires_grad_()
    with pytest.raises(ValueError, match="needs dropout_seed"):
        ka.flash_qkv_attention(x, w_qkv, w_out, n_head=2, dropout_rate=0.1)
    ka.flash_qkv_attention(x, w_qkv, w_out, n_head=2, dropout_rate=0.1,
                           dropout_seed=3).sum().backward()
    dropped = w_qkv.grad.clone()
    w_qkv.grad = None
    ka.flash_qkv_attention(x, w_qkv, w_out, n_head=2).sum().backward()
    assert not torch.equal(dropped, w_qkv.grad)
    assert w_qkv.grad.shape == w_qkv.shape
    assert torch.isfinite(w_qkv.grad).all() and w_qkv.grad.abs().sum() > 0
    with torch.no_grad():
        assert ka.flash_qkv_attention(x, w_qkv, w_out,
                                      n_head=2).shape == (2, 16, 128)


def test_kernel_wrappers_refuse_non_cpu_tensors():
    """No fallback off the CPU: a tensor the kernels cannot take raises."""
    q, k, v, g, _ = _inputs(32, 32, None)
    meta = [torch.from_numpy(a).to("meta") for a in (q, k, v, g)]
    lse = torch.zeros(B, H, 32, device="meta")
    with pytest.raises(ValueError):
        ka.flash_fwd(*meta[:3])
    with pytest.raises(ValueError):
        ka.flash_bwd_dq(*meta[:3], None, meta[3], lse, lse)
    with pytest.raises(ValueError):
        ka.flash_bwd_dkv(*meta[:3], None, meta[3], lse, lse)


#: head width 128: (name, tq, tk, bias kind, causal, layout, weights-dropout
#: rate); the bthd cases keep their first ids
W128_CASES = [
    pytest.param("key_padding", 32, 64, "pad", False, "bthd", 0.0,
                 id="key_padding-32-64-pad-False"),
    pytest.param("causal_tq_gt_tk", 64, 32, "pad", True, "bthd", 0.0,
                 id="causal_tq_gt_tk-64-32-pad-True"),
    pytest.param("key_padding", 32, 64, "pad", False, "bhtd", 0.0,
                 id="bhtd-key_padding"),
    pytest.param("causal_tq_gt_tk", 64, 32, "pad", True, "bhtd", 0.0,
                 id="bhtd-causal_tq_gt_tk"),
    pytest.param("ragged_pad_dropout", 40, 72, "pad", False, "bthd", 0.1,
                 id="bthd-ragged_pad-dropout"),
    pytest.param("causal_dropout", 72, 72, "full", True, "bhtd", 0.1,
                 id="bhtd-causal-dropout"),
]


@pytest.mark.parametrize("name,tq,tk,bias_kind,causal,fmt,rate", W128_CASES)
def test_head_width_128_matches_jax_kernels(name, tq, tk, bias_kind, causal,
                                            fmt, rate):
    """At head width 128 the reference's plan launches its flash kernels
    (interpret mode here) in both layouts, and the port's twins, which its
    wrappers run on CPU tensors, give their result: out and lse against
    _flash_forward, and the output and dq, dk, dv against jax.vjp of the
    reference's flash_attention, 1e-5 abs and rel; at rate 0.1 under one
    fixed seed, the same hash mask.  (On the card the same wrappers launch
    the f32 kernels compiled for this width: #4, #6, #7 in bthd, #5, #8, #9
    in bhtd.)"""
    d = 128
    scale = d ** -0.5
    seed = 0x2545F491
    arrays = _inputs(tq, tk, bias_kind, seed=6, d=d)
    if fmt == "bhtd":  # [b, t, h, d] -> [b, h, t, d]
        arrays = [a.transpose(0, 2, 1, 3).copy() for a in arrays[:4]] + [
            arrays[4]]
    q, k, v, g, bias = arrays
    jq, jk, jv = (_j(a) for a in (q, k, v))
    ok, bq, bk, _ = jax_attention._plan(jq, jk, 512, 512, True, fmt)
    assert ok  # the reference's kernels run, not its XLA fallback
    want_out, want_lse = jax_attention._flash_forward(
        jq, jk, jv, _j(bias), jnp.asarray([seed], jnp.uint32), scale,
        causal, bq, bk, True, fmt, dropout_rate=rate)
    fwd = ka.flash_fwd if fmt == "bthd" else ka.flash_fwd_bhtd
    kw = dict(scale=scale, causal=causal, dropout_rate=rate,
              dropout_seed=seed if rate else 0)
    out, lse = fwd(*(_t(a) for a in (q, k, v, bias)), **kw)
    _close(out, want_out)
    _close(lse, want_lse)

    def f(q_, k_, v_):
        return jax_attention.flash_attention(
            q_, k_, v_, _j(bias), scale=scale, causal=causal, fmt=fmt,
            interpret=True, dropout_rate=rate,
            dropout_seed=jnp.asarray(seed, jnp.uint32) if rate else None)

    want, vjp = jax.vjp(f, jq, jk, jv)
    want_grads = vjp(_j(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = ka.flash_attention(*args, _t(bias), fmt=fmt, **kw)
    got.backward(_t(g))
    _close(got.detach(), want)
    for a, w in zip(args, want_grads):
        _close(a.grad, w)


#: bf16 (amp): the same bf16 q, k, v, bias and dO on both sides, f32
#: arithmetic in other orders, each output rounded once to bf16 (8
#: significant bits): within 2^-7 of its value, plus, where a sum cancels,
#: one bf16 step (2^-8) of the tensor's largest element; lse f32 on both
RTOL_BF16 = 2.0 ** -7
BF16_CASES = [("key_padding", 32, 64, "pad", False),
              ("causal_tq_gt_tk", 64, 32, "pad", True),
              ("masked_row", 64, 64, "masked", False)]


def _close_bf16(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=RTOL_BF16,
                               atol=2.0 ** -8 * np.abs(want).max())


@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", BF16_CASES)
def test_bf16_matches_jax_kernels(name, tq, tk, bias_kind, causal):
    """#4's, #6's and #7's twins on bf16 operands (the bias too, as amp
    casts it) through the Function's autograd against _flash_forward and
    _flash_backward in interpret mode on the same bf16 operands: out, dq,
    dk, dv bf16 within _close_bf16, lse f32 within 1e-5."""
    arrays = _inputs(tq, tk, bias_kind, seed=6)
    tq_, tk_, tv, tg, tb = (None if a is None else
                            torch.from_numpy(a).bfloat16() for a in arrays)
    jq, jk, jv, jg, jb = (None if a is None else
                          jnp.asarray(a).astype(jnp.bfloat16)
                          for a in arrays)
    ok, bq, bk, _ = jax_attention._plan(jq, jk, 512, 512, True, "bthd")
    assert ok
    seed = jnp.zeros((1,), jnp.uint32)
    out, lse = jax_attention._flash_forward(jq, jk, jv, jb, seed, SCALE,
                                            causal, bq, bk, True, "bthd")
    dq, dk, dv = jax_attention._flash_backward(
        jq, jk, jv, jb, seed, out, lse, jg, SCALE, causal, bq, bk, True,
        "bthd")
    assert out.dtype == dq.dtype == jnp.bfloat16

    def f32(a):
        return np.asarray(a.astype(jnp.float32))

    got_out, got_lse = ka.flash_fwd(tq_, tk_, tv, tb, SCALE, causal)
    assert got_out.dtype == torch.bfloat16
    assert got_lse.dtype == torch.float32
    live = ~np.isinf(f32(lse))
    np.testing.assert_allclose(got_lse.numpy()[live], f32(lse)[live],
                               rtol=1e-5, atol=1e-5)
    leaves = [a.clone().requires_grad_() for a in (tq_, tk_, tv)]
    o = ka.flash_attention(*leaves, tb, scale=SCALE, causal=causal,
                           fmt="bthd")
    assert torch.equal(o, got_out)
    o.backward(tg)
    _close_bf16(o.detach().float(), f32(out))
    for leaf, want in zip(leaves, (dq, dk, dv)):
        assert leaf.grad.dtype == torch.bfloat16
        _close_bf16(leaf.grad.float(), f32(want))


# ---------------------------------------------------------------------------
# #4 in bf16 on tensor cores (csrc/flash_tc.cuh): its numerics, emulated
# ---------------------------------------------------------------------------


def _split(a):
    """(hi, lo) = (bf16(a), bf16(a - hi)) of an f32 tensor, as f32 values:
    the tensor-core kernels' split of an f32 operand (csrc/mma.cuh)."""
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def _tc_flash_forward(q, k, v, bias, scale, causal, rate=0.0, seed=0,
                      tile=64):
    """#4's arithmetic on the card, in PyTorch: s = q k^T of the bf16
    operands (exact products, f32 sums), scaled and biased in f32; the
    online softmax over 64-key tiles in f32 (l over the undropped p); each
    tile's p, dropped, split into hi/lo bf16s and p v = p_hi v + p_lo v
    summed in f32; o = acc / l rounded to bf16 once.  q, k, v [b, t, h,
    d] bf16; returns (o bf16, lse f32 [b, h, tq])."""
    qh, kh, vh = (a.float().transpose(1, 2) for a in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    tq, tk = s.shape[-2:]
    if causal:
        s = s.masked_fill(~ka._causal_keep(tq, tk, s.device), ka.MASK_VALUE)
    keep = hash_rng.keep_mask_attn(seed, s.shape, rate) if rate else None
    m = torch.full(s.shape[:-1] + (1,), -np.inf)
    l = torch.zeros_like(m)
    acc = torch.zeros(s.shape[:-1] + (vh.shape[-1],))
    for k0 in range(0, tk, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + tile], p, 0.0)
        p_hi, p_lo = _split(p)
        vt = vh[..., k0:k0 + tile, :]
        acc = acc * alpha + p_hi @ vt + p_lo @ vt
        m = m_new
    masked = (l == 0) | (m <= -1e29)
    o = (acc * ((1.0 / (1.0 - rate) if rate else 1.0) / l)).masked_fill(
        masked, 0.0)
    lse = (m + torch.log(l)).masked_fill(masked, np.inf)[..., 0]
    return o.transpose(1, 2).bfloat16(), lse


def test_hi_lo_split_rebuilds_f32_to_2_pow_minus_16():
    """hi + lo is the f32 value to 2^-16 of its magnitude, over values of
    magnitudes 2^-60..2^60 (|lo| <= 2^-8 |a|, itself rounded to 8
    significant bits); a bf16 value splits into itself and 0."""
    rng = np.random.RandomState(0)
    a = torch.from_numpy((rng.randn(1 << 16) * 2.0 ** rng.randint(
        -60, 60, 1 << 16)).astype(np.float32))
    hi, lo = _split(a)
    assert ((hi + lo - a).abs() <= 2.0 ** -16 * a.abs()).all()
    assert ((hi - a).abs() > 2.0 ** -16 * a.abs()).any()
    b = a.bfloat16().float()
    assert torch.equal(_split(b)[0], b) and not _split(b)[1].any()


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", BF16_CASES)
def test_tensor_core_numerics_match_jax_kernel(name, tq, tk, bias_kind,
                                               causal, rate):
    """The emulated arithmetic of #4's tensor-core kernel (exact bf16
    products for s, p split into hi/lo for p v) against _flash_forward in
    interpret mode on the same bf16 operands and hash mask: o within
    _close_bf16, lse within 1e-5, the same masked rows."""
    arrays = _inputs(tq, tk, bias_kind, seed=6)
    tq_, tk_, tv, _, tb = (None if a is None else
                           torch.from_numpy(a).bfloat16() for a in arrays)
    jq, jk, jv, _, jb = (None if a is None else
                         jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    seed = 0x2545F491
    ok, bq, bk, _ = jax_attention._plan(jq, jk, 512, 512, True, "bthd")
    assert ok
    out, lse = jax_attention._flash_forward(
        jq, jk, jv, jb, jnp.asarray([seed], jnp.uint32), SCALE, causal, bq,
        bk, True, "bthd", dropout_rate=rate)
    got_o, got_lse = _tc_flash_forward(tq_, tk_, tv, tb, SCALE, causal,
                                       rate, seed)
    want_lse = np.asarray(lse)
    live = ~np.isinf(want_lse)
    assert np.array_equal(np.isinf(got_lse.numpy()), ~live)
    np.testing.assert_allclose(got_lse.numpy()[live], want_lse[live],
                               rtol=1e-5, atol=1e-5)
    _close_bf16(got_o.float(), np.asarray(out.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# #6 and #7 in bf16 on tensor cores (csrc/flash_bwd_tc.cuh, one bf16
# plane): their numerics, emulated
# ---------------------------------------------------------------------------


def _tc_flash_backward(q, k, v, bias, dout, lse, delta, scale, causal,
                       rate=0.0, seed=0):
    """#6's and #7's arithmetic on the card, in PyTorch: s = q k^T and dp
    = dO v^T of the bf16 operands (exact products, f32 sums); p =
    exp(s * scale + bias - lse), masked as the kernels mask it (causal
    keys, and rows whose lse is +inf), and ds = p (dp - delta) * scale in
    f32, dp dropped and scaled where the hash drops; dq = ds_hi k + ds_lo
    k, dv = (p keep inv_keep)_hi^T dO + (...)_lo^T dO and dk = ds_hi^T q +
    ds_lo^T q, summed in f32 and rounded to bf16 once.  q, dout [b, tq, h,
    d] and k, v [b, tk, h, d] bf16, lse and delta f32 [b, h, tq]; returns
    (dq, dk, dv) bf16 in the operands' layout."""
    qh, kh, vh, dh = (a.float().transpose(1, 2) for a in (q, k, v, dout))
    s = (qh @ kh.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.exp(s - lse[..., None])
    tq, tk = s.shape[-2:]
    if causal:
        p = torch.where(ka._causal_keep(tq, tk, p.device), p, 0.0)
    dp = dh @ vh.transpose(-1, -2)
    pv = p
    if rate:
        keep = hash_rng.keep_mask_attn(seed, p.shape, rate)
        inv_keep = float(np.float32(1.0 / (1.0 - rate)))
        dp = torch.where(keep, dp * inv_keep, 0.0)
        pv = torch.where(keep, p * inv_keep, 0.0)
    ds = p * (dp - delta[..., None]) * scale
    ds_hi, ds_lo = _split(ds)
    pv_hi, pv_lo = _split(pv)
    dq = ds_hi @ kh + ds_lo @ kh
    dk = ds_hi.transpose(-1, -2) @ qh + ds_lo.transpose(-1, -2) @ qh
    dv = pv_hi.transpose(-1, -2) @ dh + pv_lo.transpose(-1, -2) @ dh
    return tuple(a.transpose(1, 2).bfloat16() for a in (dq, dk, dv))


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", BF16_CASES)
def test_backward_tensor_core_numerics_match_jax_kernels(name, tq, tk,
                                                         bias_kind, causal,
                                                         rate):
    """The emulated arithmetic of #6's and #7's tensor-core walks (exact
    bf16 products for s and dp, p and ds split into hi/lo for dq, dk and
    dv) against _flash_backward in interpret mode on the same bf16
    operands, out, lse and hash mask: dq, dk, dv within _close_bf16, and
    zero gradients on a row the forward masked."""
    arrays = _inputs(tq, tk, bias_kind, seed=6)
    tq_, tk_, tv, tg, tb = (None if a is None else
                            torch.from_numpy(a).bfloat16() for a in arrays)
    jq, jk, jv, jg, jb = (None if a is None else
                          jnp.asarray(a).astype(jnp.bfloat16)
                          for a in arrays)
    seed = 0x2545F491
    jseed = jnp.asarray([seed], jnp.uint32)
    ok, bq, bk, _ = jax_attention._plan(jq, jk, 512, 512, True, "bthd")
    assert ok
    out, lse = jax_attention._flash_forward(
        jq, jk, jv, jb, jseed, SCALE, causal, bq, bk, True, "bthd",
        dropout_rate=rate)
    want = jax_attention._flash_backward(
        jq, jk, jv, jb, jseed, out, lse, jg, SCALE, causal, bq, bk, True,
        "bthd", dropout_rate=rate)
    o_ = torch.from_numpy(np.array(out.astype(jnp.float32)))
    lse_ = torch.from_numpy(np.array(lse))
    delta = (tg.float() * o_).sum(-1).transpose(1, 2).contiguous()
    got = _tc_flash_backward(tq_, tk_, tv, tb, tg, lse_, delta, SCALE,
                             causal, rate, seed)
    for g_, w in zip(got, want):
        assert g_.dtype == torch.bfloat16
        _close_bf16(g_.float(), np.asarray(w.astype(jnp.float32)))
    hidden = torch.isinf(lse_)  # [b, h, tq]
    assert bool(hidden.any()) == (name != "key_padding")
    assert not got[0].transpose(1, 2)[hidden].any()
