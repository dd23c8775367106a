"""paddle_tpu_torch's bf16 training kernels at head width 128 (amp), and
amp training at 2 heads of 128, on the CPU, against the JAX package.

The reference launches its fused (#1-#3) and flash (#4-#9) kernels at any
d_head % 64 == 0; the port compiles their bf16 instantiations for 128
(``kernels.HEAD_WIDTHS``).  On CPU tensors each wrapper runs its plain
twin, held here against the reference's Pallas kernels in interpret mode
on the same bf16 operands at 2 heads of 128: #1 and the pair #2 + #3
(``_qkv_forward``, ``_qkv_backward``), the flash forward and both backward
walks in bthd and bhtd (``_flash_forward``, ``_flash_backward``).  Then
the whole slice: a 2 + 2-layer Transformer of 2 heads of 128 (d_model
256) under ``amp.enable`` at dropout 0.1, its weights carried across by
``load_paddle_tpu_params``, takes 3 Adam steps on each attention route
against the reference's program under ``pt.amp.enable``, held as
``test_torch_training.py`` holds the 64-wide model.  The CUDA kernels are
held against the same twins on the card by chip_smoke.py (phase 2's
``check_head128_amp_kernels``, phase 3 (n)).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import test_torch_training as tt
from paddle_tpu.kernels import attention as jax_attention
from paddle_tpu_torch import Adam, amp, export_paddle_tpu_params
from paddle_tpu_torch.interop import paddle_tpu_param_names
from paddle_tpu_torch.kernels import attention as ka
from test_torch_flash_attention import _close_bf16 as _close_flash_bf16
from test_torch_qkv_attention import _bf16, _close, _close_bf16
from test_torch_qkv_attention import _inputs as _qkv_inputs

DH = 128
SCALE = DH ** -0.5

# ---------------------------------------------------------------------------
# #1 and the pair #2 + #3 in bf16
# ---------------------------------------------------------------------------

#: (name, t, bias kind, causal) at 2 heads of 128, batch 2
QKV_CASES = [("pad", 64, "pad", False), ("causal_masked_row", 32, "masked",
                                         True)]


@pytest.mark.parametrize("name,t,bias_kind,causal", QKV_CASES)
def test_qkv_bf16_at_128_matches_jax_kernels(name, t, bias_kind, causal):
    """#1's twin (y, ctx, lse) and the pair's (dx, dW_qkv, dW_out) on bf16
    operands at 2 heads of 128 against _qkv_forward and _qkv_backward in
    interpret mode on the same bf16 operands, as the 64-wide bf16 test
    holds them: y, ctx, dW in bf16 within one bf16 step (2^-7 of the value
    plus 2^-8 of the largest), dx within two (the reference rounds dx_q
    and dx_kv before their sum), lse f32 within 1e-5."""
    n_head = 2
    x, w_qkv, w_out, g, bias = _qkv_inputs(n_head, t, bias_kind, seed=7,
                                           dh=DH)
    (tx, jx), (tw, jw), (to, jo), (tg, jg), (tb, jb) = _bf16(
        x, w_qkv, w_out, g, bias)
    ok, bq, bk, _ = jax_attention._qkv_plan(jx, n_head, DH, 512, 512, True,
                                            bias=jb)
    assert ok  # the reference's fused kernels run, not its composition
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
    assert got_ctx.shape == (2, t, n_head, DH)

    def f32(a):
        return np.asarray(jnp.asarray(a).astype(jnp.float32))

    _close_bf16(got_y.float(), f32(y))
    _close_bf16(got_ctx.float().transpose(1, 2), f32(ctx))
    live = ~np.isinf(f32(lse))
    assert live.all() == (bias_kind != "masked")
    _close(got_lse.numpy()[live], f32(lse)[live], 1e-5, 1e-5)
    dx, dw_qkv, dw_out = ka.qkv_bwd(tx, tw, to, tb, tg, got_ctx, got_lse,
                                    **kw)
    assert dx.dtype == dw_qkv.dtype == dw_out.dtype == torch.bfloat16
    want_dx = (dx_q.astype(jnp.float32) + dx_kv.astype(jnp.float32)).astype(
        jnp.bfloat16)
    _close_bf16(dx.float(), f32(want_dx), 2)
    _close_bf16(dw_qkv.float(), f32(jax_attention._unpack_dw_qkv(
        dwq, dwk, dwv, jnp.float32)))
    _close_bf16(dw_out.float(), f32(dwo.reshape(n_head * DH, -1)))
    # #2 and #3 alone: the dq walk's dx_q and dW_q, the dkv walk's dx_kv
    # and dW_k, dW_v
    dxq, dwq_, _ = ka.qkv_bwd_dq(tx, tw, to, tb, tg, got_ctx, got_lse, **kw)
    _close_bf16(dxq.float(), f32(dx_q))
    _close_bf16(dwq_.float(), f32(jax_attention._unpack_dw_qkv(
        dwq, dwk, dwv, jnp.float32))[:, :n_head * DH])
    dxkv, _, _ = ka.qkv_bwd_dkv(tx, tw, to, tb, tg, got_ctx, got_lse, **kw)
    _close_bf16(dxkv.float(), f32(dx_kv))


# ---------------------------------------------------------------------------
# #4-#9 in bf16
# ---------------------------------------------------------------------------

#: (name, tq, tk, bias kind, causal) at batch 2, 2 heads of 128
FLASH_CASES = [("key_padding", 32, 64, "pad", False),
               ("causal_tq_gt_tk", 64, 32, "pad", True)]


def _flash_inputs(tq, tk, bias_kind, seed):
    """q, dO [2, tq, 2, 128], k, v [2, tk, 2, 128] and a key-padding bias
    [2, 1, 1, tk], numpy f32."""
    rng = np.random.RandomState(seed)
    q, do = (rng.randn(2, tq, 2, DH).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, tk, 2, DH).astype(np.float32) for _ in range(2))
    bias = np.zeros((2, 1, 1, tk), np.float32)
    bias[1, ..., tk - 7:] = -1e9
    return q, k, v, do, bias if bias_kind else None


@pytest.mark.parametrize("fmt", ["bthd", "bhtd"])
@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", FLASH_CASES)
def test_flash_bf16_at_128_matches_jax_kernels(name, tq, tk, bias_kind,
                                               causal, fmt):
    """#4's, #6's and #7's twins (bthd) and #5's, #8's and #9's (bhtd) on
    bf16 operands at 2 heads of 128, through the Function's autograd,
    against _flash_forward and _flash_backward in interpret mode on the
    same bf16 operands in the same layout: out, dq, dk, dv bf16 within one
    bf16 step, lse f32 within 1e-5."""
    arrays = _flash_inputs(tq, tk, bias_kind, seed=8)
    if fmt == "bhtd":
        arrays = tuple(a.transpose(0, 2, 1, 3).copy() for a in arrays[:4]) \
            + arrays[4:]
    (tq_, jq), (tk_, jk), (tv, jv), (tg, jg), (tb, jb) = _bf16(*arrays)
    ok, bq, bk, _ = jax_attention._plan(jq, jk, 512, 512, True, fmt)
    assert ok  # the reference's kernels run, not its XLA fallback
    seed = jnp.zeros((1,), jnp.uint32)
    out, lse = jax_attention._flash_forward(jq, jk, jv, jb, seed, SCALE,
                                            causal, bq, bk, True, fmt)
    dq, dk, dv = jax_attention._flash_backward(
        jq, jk, jv, jb, seed, out, lse, jg, SCALE, causal, bq, bk, True,
        fmt)
    assert out.dtype == dq.dtype == jnp.bfloat16

    def f32(a):
        return np.asarray(a.astype(jnp.float32))

    fwd = ka.flash_fwd if fmt == "bthd" else ka.flash_fwd_bhtd
    got_out, got_lse = fwd(tq_, tk_, tv, tb, SCALE, causal)
    assert got_out.dtype == torch.bfloat16
    live = ~np.isinf(f32(lse))
    _close(got_lse.numpy()[live], f32(lse)[live], 1e-5, 1e-5)
    leaves = [a.clone().requires_grad_() for a in (tq_, tk_, tv)]
    o = ka.flash_attention(*leaves, tb, scale=SCALE, causal=causal, fmt=fmt)
    assert torch.equal(o, got_out)
    o.backward(tg)
    _close_flash_bf16(o.detach().float(), f32(out))
    for leaf, want in zip(leaves, (dq, dk, dv)):
        assert leaf.grad.dtype == torch.bfloat16
        _close_flash_bf16(leaf.grad.float(), f32(want))


# ---------------------------------------------------------------------------
# the slice: amp training at 2 heads of 128
# ---------------------------------------------------------------------------

#: test_torch_training's 2 + 2-layer model with its 1024 split as the
#: big configuration's is: 2 heads of 128, d_model 256 (d_inner 512)
WIDTHS_128 = dict(tt.WIDTHS, d_key=128, d_value=128, d_model=256,
                  d_inner_hid=512)
#: The free-running losses drift further apart at these widths than at
#: test_torch_training's (TOL_AMP_LOSS, measured there 1.05e-3 at step
#: 3): here the reference's own step-1 bf16 loss sits 1.09e-3 from the
#: float64 loss on the default route (the port's 1.5e-6) and 3.0e-4 on
#: the flag-off route (the port's 6.2e-4), and after two updates from
#: bf16 gradients the two sides are 2.9e-3 (default route) and 4.1e-3
#: (flag-off) apart at step 3.  So each side's step-1 loss is held to
#: float64 within TOL_AMP_LOSS, and the two sides' losses to each other
#: within twice it.
TOL_AMP_LOSS_128 = 2 * tt.TOL_AMP_LOSS


@pytest.fixture(scope="module")
def widths_128():
    """test_torch_training's helpers build their models and programs at
    WIDTHS_128 meanwhile."""
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(tt, "WIDTHS", WIDTHS_128)
        yield


@pytest.fixture(scope="module", params=[True, False],
                ids=["fused", "flag_off"])
def ref_amp_128(request, widths_128):
    """The reference's dropout program at WIDTHS_128 under
    ``pt.amp.enable`` on the default route (``fused``) or with
    ``FLAGS_fused_qkv_attention`` off, built at rng-id counter 0."""
    return request.param, tt._Reference(fused=request.param,
                                        dropout_rate=tt.DROPOUT, amp=True,
                                        rng_base=tt.AMP_RNG_BASES[0])


def test_amp_three_adam_steps_at_128_match_reference(ref_amp_128,
                                                     monkeypatch):
    """The port under ``amp.enable`` at 2 heads of 128, dropout 0.1, on
    each route against the reference's program under ``pt.amp.enable``,
    each step under the reference step's seeds, by test_torch_training's
    bounds for the 64-wide model but the losses': each side's step-1 loss
    within TOL_AMP_LOSS of the float64 step's, the two sides' losses
    within TOL_AMP_LOSS_128 of each other; every
    step-1 gradient f32, and each side's within TOL_AMP_GRAD_F64 of the
    float64 step a tensor and TOL_AMP_GRAD_F64_ALL over all of them; on
    the replayed step every gradient within TOL_AMP_GRAD of the
    reference's, and the port's distance to float64 over all of them at
    most AMP_F64_RATIO times the reference's; the parameters after 3 steps
    within TOL_AMP_PARAM (all but AMP_SHARE_BEYOND within
    TOL_AMP_PARAM_MOST); the position tables never move."""
    fused, ref = ref_amp_128
    names = dict(paddle_tpu_param_names(2))
    assert tt.WIDTHS["d_key"] == 128
    exact = tt._f64_grads(ref, names)
    with torch.no_grad():
        loss64 = tt._port(ref.start, fused_qkv_attention=fused,
                          dropout_rate=tt.DROPOUT).to(torch.float64)(
            **tt._padded_feed(), dropout_seeds=ref.seeds[0])[0].item()
    assert abs(ref.losses[0] - loss64) <= tt.TOL_AMP_LOSS * loss64
    replayed = tt._replayed_grads(ref, names, monkeypatch, fused=fused)
    model = tt._port(ref.start, fused_qkv_attention=fused,
                     dropout_rate=tt.DROPOUT)
    amp.enable(model)
    opt = Adam(model.parameters(), learning_rate=tt.LR)
    for step in range(tt.STEPS):
        loss, predict = model(**tt._padded_feed(),
                              dropout_seeds=ref.seeds[step])
        assert predict.dtype == torch.bfloat16
        want = ref.losses[step]
        assert abs(loss.item() - want) <= TOL_AMP_LOSS_128 * abs(want), (
            step, loss.item(), want)
        params_grads = opt.minimize(loss)
        if step:
            continue
        assert abs(loss.item() - loss64) <= tt.TOL_AMP_LOSS * loss64
        got = dict(params_grads)
        port = {}
        for n in ref.trained:
            p = model.get_parameter(names[n])
            assert p.dtype == got[p].dtype == torch.float32, n
            port[n] = got[p].numpy().astype(np.float64)
            for side in (port[n], ref.grads[n]):
                assert tt._rel(side, exact[n]) <= tt.TOL_AMP_GRAD_F64, n
            assert tt._rel(replayed[n], ref.grads[n]) <= tt.TOL_AMP_GRAD, n

        def whole(grads):
            return np.concatenate([np.ravel(grads[n]) for n in ref.trained])

        far = [tt._rel(whole(g), whole(exact))
               for g in (port, ref.grads, replayed)]
        assert max(far[:2]) <= tt.TOL_AMP_GRAD_F64_ALL, far
        assert far[2] <= tt.AMP_F64_RATIO * far[1], far
    exported = export_paddle_tpu_params(model)
    beyond = total = 0
    for n, got in exported.items():
        want = ref.after[-1][n]
        np.testing.assert_allclose(got, want, atol=tt.TOL_AMP_PARAM, rtol=0,
                                   err_msg=n)
        beyond += int((np.abs(got - want) > tt.TOL_AMP_PARAM_MOST).sum())
        total += got.size
    assert beyond <= tt.AMP_SHARE_BEYOND * total, (beyond, total)
    for n in ("src_pos_enc_table", "trg_pos_enc_table"):
        np.testing.assert_array_equal(exported[n], ref.start[n])
