"""paddle_tpu_torch flash_attention (fmt="bhtd") and
layers.contrib.fused_attention against the JAX package, on the CPU.

On CPU tensors the port's wrappers of #5 (forward), #8 (dq) and #9 (dk,
dv) run their plain twins, so these tests hold that arithmetic, the
autograd wiring and the layer against the reference's own bhtd Pallas
kernels in interpret mode (``_flash_forward`` / ``_flash_backward`` with
``fmt="bhtd"``: ``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``),
against ``jax.vjp`` of its ``flash_attention(fmt="bhtd")`` and against a
small program of its ``layers.contrib.fused_attention``.  The CUDA kernels
are held against the same twins on the card by chip_smoke.py.  Inputs are
numpy arrays from seeds; dropout runs at the reference's hash masks under
the same seed on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core.executor import prng_key
from paddle_tpu.kernels import attention as jax_attention
from paddle_tpu_torch.interop import dropout_seeds
from paddle_tpu_torch.kernels import attention as ka
from paddle_tpu_torch.layers import contrib

#: f32 on both sides, abs and rel: the packages sum in other orders (the
#: reference's tiles are whole 32- or 64-row blocks, the twins' one
#: product), so results differ by summation order only
TOL = 1e-5
B, H, D = 2, 2, 64
SCALE = D ** -0.5
RATE, SEED = 0.1, 0x2545F491

#: (name, tq, tk, bias kind, causal): every bias shape the reference
#: broadcasts ([b,1,1,tk] key padding, [b,1,tq,tk], [b,h,tq,tk],
#: [1,1,tq,tk]), tq != tk both ways, causal, and causal with tq > tk (its
#: first tq - tk rows see no key) beside a row masked to -1e30; the three
#: ragged cases take lengths that are multiples of neither 64 nor 128, as
#: the card's walks tile them (129 crosses the forward's 128-row block by
#: one)
CASES = [
    ("no_bias", 32, 32, None, False),
    ("key_padding", 32, 64, "pad", False),
    ("full_q_bias", 32, 32, "full", False),
    ("per_head", 64, 32, "head", False),
    ("shared", 32, 64, "shared", False),
    ("causal", 64, 64, "pad", True),
    ("causal_tq_gt_tk_masked_row", 64, 32, "masked", True),
    ("ragged_pad", 40, 72, "pad", False),
    ("ragged_causal_masked_row", 72, 40, "masked", True),
    ("ragged_129_72", 129, 72, "pad", False),
]
RATES = [0.0, RATE]


def _inputs(tq, tk, bias_kind, seed=0):
    """q [b, h, tq, d], k, v [b, h, tk, d], g like q, and the bias."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, tq, D).astype(np.float32)
    k = rng.randn(B, H, tk, D).astype(np.float32)
    v = rng.randn(B, H, tk, D).astype(np.float32)
    g = rng.randn(B, H, tq, D).astype(np.float32)
    if bias_kind == "pad":  # lane 1 with a padded tail
        bias = np.zeros((B, 1, 1, tk), np.float32)
        bias[1, ..., tk - 7:] = -1e9
    elif bias_kind == "full":
        bias = (rng.randn(B, 1, tq, tk) * 0.5).astype(np.float32)
        bias[:, :, :, -3:] = -1e9
    elif bias_kind == "head":
        bias = (rng.randn(B, H, tq, tk) * 0.5).astype(np.float32)
    elif bias_kind == "shared":
        bias = (rng.randn(1, 1, tq, tk) * 0.5).astype(np.float32)
    elif bias_kind == "masked":  # row 40 of lane 1 sees nothing
        bias = np.zeros((B, 1, tq, tk), np.float32)
        bias[1, 0, 40, :] = -1e30
    else:
        bias = None
    return q, k, v, g, bias


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _kw(causal, rate):
    return dict(scale=SCALE, causal=causal, dropout_rate=rate,
                dropout_seed=SEED if rate else 0)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", CASES)
def test_kernels_match_jax_kernels(name, tq, tk, bias_kind, causal, rate):
    """#5's twin (out, lse) against _fwd_kernel, and #8's (dq) and #9's
    (dk, dv) from the same out, lse and dO against _bwd_dq_kernel and
    _bwd_dkv_kernel, all in interpret mode, 1e-5; rows that see no key
    give 0 and lse = +inf in both."""
    q, k, v, g, bias = _inputs(tq, tk, bias_kind)
    jq, jk, jv, jg, jb = (_j(a) for a in (q, k, v, g, bias))
    ok, bq, bk, interp = jax_attention._plan(jq, jk, 512, 512, True, "bhtd")
    assert ok and interp  # d = 64: the kernels run, not the XLA fallback
    seed = jnp.asarray([SEED], jnp.uint32)
    out, lse = jax_attention._flash_forward(
        jq, jk, jv, jb, seed, SCALE, causal, bq, bk, True, "bhtd",
        dropout_rate=rate)
    want = jax_attention._flash_backward(
        jq, jk, jv, jb, seed, out, lse, jg, SCALE, causal, bq, bk, True,
        "bhtd", dropout_rate=rate)
    args = [_t(a) for a in (q, k, v, bias)]
    kw = _kw(causal, rate)
    got_out, got_lse = ka.flash_fwd_bhtd(*args, **kw)
    assert got_out.shape == (B, H, tq, D) and got_lse.shape == (B, H, tq)
    _close(got_out, out)
    _close(got_lse, lse)
    hidden = np.isinf(np.asarray(lse))
    assert hidden.any() == (bias_kind == "masked")
    assert torch.count_nonzero(got_out[torch.from_numpy(hidden)]) == 0
    o, tg = _t(np.array(out)), _t(g)
    delta = (tg * o).sum(-1).contiguous()
    bw = (*args, tg, _t(np.array(lse)), delta)
    dq = ka.flash_bwd_dq_bhtd(*bw, **kw)
    dk, dv = ka.flash_bwd_dkv_bhtd(*bw, **kw)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", CASES)
def test_autograd_matches_jax_vjp(name, tq, tk, bias_kind, causal, rate):
    """The port's differentiable flash_attention(fmt="bhtd") against
    jax.vjp of the reference's (kernels in interpret mode): output, dq,
    dk, dv and, for a bias that is not a mask, dbias (the reference's
    _dbias_xla, under the same dropout mask), 1e-5."""
    q, k, v, g, bias = _inputs(tq, tk, bias_kind, seed=2)
    trainable = bias_kind in ("full", "head", "shared")
    jseed = jnp.asarray(SEED, jnp.uint32)

    def f(q_, k_, v_, b_):
        return jax_attention.flash_attention(
            q_, k_, v_, b_, scale=SCALE, causal=causal, fmt="bhtd",
            interpret=True, dropout_rate=rate,
            dropout_seed=jseed if rate else None)

    want, vjp = jax.vjp(f, *(_j(a) for a in (q, k, v, bias)))
    want_grads = vjp(_j(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else _t(bias).requires_grad_(trainable)
    out = ka.flash_attention(*args, tb, fmt="bhtd", **_kw(causal, rate))
    out.backward(_t(g))
    _close(out.detach(), want)
    for a, w in zip(args, want_grads):
        _close(a.grad, w)
    if trainable:
        assert tb.grad.shape == tb.shape
        _close(tb.grad, want_grads[3])
    elif tb is not None:
        assert tb.grad is None


@pytest.mark.parametrize("rate", RATES)
def test_bhtd_is_bthd_transposed(rate):
    """The two layouts compute one function with one mask: bhtd on q, k, v
    equals bthd on their transposes, output and gradients, bit for bit on
    the CPU (the twins share their arithmetic)."""
    q, k, v, g, bias = _inputs(32, 64, "pad", seed=3)
    outs = []
    for fmt in ("bhtd", "bthd"):
        args = [torch.from_numpy(a if fmt == "bhtd" else a.transpose(
            0, 2, 1, 3).copy()).requires_grad_() for a in (q, k, v)]
        tg = _t(g) if fmt == "bhtd" else _t(g).transpose(1, 2)
        out = ka.flash_attention(*args, _t(bias), fmt=fmt,
                                 **_kw(False, rate))
        out.backward(tg)
        grads = [a.grad for a in args]
        if fmt == "bthd":
            out, grads = out.transpose(1, 2), [a.transpose(1, 2)
                                               for a in grads]
        outs.append([out.detach(), *grads])
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_wrappers_refuse_non_cpu_tensors():
    """No fallback off the CPU: a tensor the kernels cannot take raises in
    each of #5's, #8's and #9's wrappers, and an unknown layout raises."""
    q, k, v, g, _ = _inputs(32, 32, None)
    meta = [torch.from_numpy(a).to("meta") for a in (q, k, v, g)]
    lse = torch.zeros(B, H, 32, device="meta")
    with pytest.raises(ValueError):
        ka.flash_fwd_bhtd(*meta[:3])
    with pytest.raises(ValueError):
        ka.flash_bwd_dq_bhtd(*meta[:3], None, meta[3], lse, lse)
    with pytest.raises(ValueError):
        ka.flash_bwd_dkv_bhtd(*meta[:3], None, meta[3], lse, lse)
    with pytest.raises(ValueError, match="unknown fmt"):
        ka.flash_attention(*(_t(a) for a in (q, k, v)), fmt="tbhd")


# ---------------------------------------------------------------------------
# layers.contrib.fused_attention against the reference's layer
# ---------------------------------------------------------------------------

#: the layer's program: q, k, v [B, H, T, D] fed, a key-padding bias fed
LAYER_T = 32


def _reference_layer(weights_dropout):
    """(out, grads of q, k, v, the seed of the site) of the reference's
    ``fused_attention`` layer at dropout RATE, in one program run under a
    forced run id; the site's seed is the one of its dropout-drawing op
    (the fused op with weights dropout, else the appended ``dropout``)."""
    prog, startup = pt.Program(), pt.Program()
    shape = [H, LAYER_T, D]
    with pt.program_guard(prog, startup):
        with pt.core.framework.guard_unique_name():
            qv, kv, vv = (pt.layers.data(name=n, shape=shape,
                                         dtype="float32")
                          for n in ("q", "k", "v"))
            for var in (qv, kv, vv):
                var.stop_gradient = False
            bias = pt.layers.data(name="bias", shape=[1, 1, LAYER_T],
                                  dtype="float32")
            out = pt.layers.contrib.fused_attention(
                qv, kv, vv, bias, scale=SCALE, dropout_rate=RATE,
                weights_dropout=weights_dropout)
            loss = pt.layers.reduce_sum(pt.layers.elementwise_mul(
                out, pt.layers.data(name="g", shape=shape,
                                    dtype="float32")))
            grads = pt.gradients(loss, [qv, kv, vv])
    ops = prog.global_block().ops
    rng_ids = [op.attrs["rng_id"] for op in ops
               if op.type in ("dropout", "fused_attention")
               and op.attrs.get("rng_id")]
    assert len(rng_ids) == 1
    assert [op.type for op in ops].count("dropout") == (
        0 if weights_dropout else 1)
    q, k, v, g, bias_np = _inputs(LAYER_T, LAYER_T, "pad", seed=4)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    run_id = 7
    exe._forced_run_id = run_id
    key = jax.random.fold_in(prng_key(prog.random_seed or 0), run_id)
    seed = dropout_seeds(np.asarray(jax.random.key_data(key)), rng_ids)[0]
    fetched = exe.run(prog, feed=dict(q=q, k=k, v=v, g=g, bias=bias_np),
                      fetch_list=[out] + grads, scope=scope)
    return [np.asarray(a) for a in fetched], seed, (q, k, v, g, bias_np)


@pytest.mark.parametrize("weights_dropout", [True, False])
def test_contrib_fused_attention_matches_reference_layer(weights_dropout):
    """contrib.fused_attention with the reference's defaults (bhtd) at rate
    0.1 against the reference's layer in a program, under that site's
    seed: the output and the gradients of q, k and v, 1e-5.  With
    ``weights_dropout`` the kernels drop the weights; without it the
    output is dropped by ``dropout`` (#16) under the ``dropout`` op's
    seed.  The TPU tile hints are accepted and change nothing."""
    want, seed, (q, k, v, g, bias) = _reference_layer(weights_dropout)
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = contrib.fused_attention(*args, _t(bias), scale=SCALE,
                                  dropout_rate=RATE, block_q=128,
                                  block_k=256,
                                  weights_dropout=weights_dropout,
                                  dropout_seed=seed)
    out.backward(_t(g))
    _close(out.detach(), want[0])
    for a, w in zip(args, want[1:]):
        _close(a.grad, w)
    undropped = contrib.fused_attention(*(a.detach() for a in args),
                                        _t(bias), scale=SCALE)
    assert not torch.allclose(out.detach(), undropped, atol=1e-3)
    with pytest.raises(ValueError, match="needs dropout_seed"):
        contrib.fused_attention(*args, dropout_rate=RATE,
                                weights_dropout=weights_dropout)
