"""paddle_tpu_torch kernels: the plain PyTorch versions against the JAX
package, on the CPU.

On a CPU tensor each wrapper of the port runs its plain version, so these
tests hold that plain arithmetic against the reference's Pallas kernels
(interpret mode) and their XLA compositions.  The CUDA kernels themselves
are held against the same plain versions on the card by chip_smoke.py.
Inputs are drawn from numpy seeds and handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import attention as jax_attention
from paddle_tpu.kernels import decode_step as jax_decode_step
from paddle_tpu_torch.kernels import attention as ka
from paddle_tpu_torch.kernels import decode_step as kds
from paddle_tpu_torch.ops.generation_ops import sample_token

#: f32 on both sides; the packages sum in different orders
TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# flash_qkv_attention
# ---------------------------------------------------------------------------


def _qkv_inputs(bias_kind, b=2, t=16, h=2, dh=64, dm=128, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, t, dm) * 0.5).astype(np.float32)
    w_qkv = (rng.randn(dm, 3 * h * dh) * 0.08).astype(np.float32)
    w_out = (rng.randn(h * dh, dm) * 0.08).astype(np.float32)
    if bias_kind == "pad":
        # the prefill's key-padding bias: lane 1 has a padded tail
        pad = np.zeros((b, t), np.float32)
        pad[1, t - 5:] = 1.0
        bias = (-1e9 * pad).reshape(b, 1, 1, t)
    else:
        bias = (rng.randn(b, h, t, t) * 0.5).astype(np.float32)
    return x, w_qkv, w_out, bias


@pytest.mark.parametrize("causal,bias_kind", [(False, "pad"), (True, "pad"),
                                              (False, "dense")])
def test_flash_qkv_attention_matches_jax(causal, bias_kind):
    x, w_qkv, w_out, bias = _qkv_inputs(bias_kind)
    kw = dict(n_head=2, scale=64 ** -0.5, causal=causal)
    want = jax_attention.flash_qkv_attention(
        jnp.asarray(x), jnp.asarray(w_qkv), jnp.asarray(w_out),
        jnp.asarray(bias), interpret=True, **kw)
    got = ka.flash_qkv_attention(torch.from_numpy(x),
                                 torch.from_numpy(w_qkv),
                                 torch.from_numpy(w_out),
                                 torch.from_numpy(bias), **kw)
    assert got.shape == (2, 16, 128) and got.dtype == torch.float32
    _close(got, want)


def test_flash_qkv_attention_broadcast_bias_and_masked_rows():
    """A [t]-only bias broadcasts like the reference's; a row whose keys
    are all causally hidden by -1e30 scores gets a zero context."""
    x, w_qkv, w_out, bias = _qkv_inputs("pad")
    kw = dict(n_head=2, scale=0.125)
    t = x.shape[1]
    row = torch.from_numpy(bias[1, 0, 0])            # [t]
    full = torch.from_numpy(bias[1:2]).expand(2, 1, 1, t)
    args = [torch.from_numpy(a) for a in (x, w_qkv, w_out)]
    _close(ka.flash_qkv_attention(*args, row, **kw),
           ka.flash_qkv_attention(*args, full, **kw), 0.0)
    hidden = torch.full((2, 1, t, t), -1e30)
    out = ka.reference_qkv_attention(*args, hidden, **kw)
    assert torch.count_nonzero(out) == 0


def test_flash_qkv_attention_refuses_what_it_cannot_compute():
    x, w_qkv, w_out, bias = _qkv_inputs("pad")
    args = [torch.from_numpy(a) for a in (x, w_qkv, w_out)]
    with pytest.raises(NotImplementedError):
        ka.flash_qkv_attention(*args, n_head=2, dropout_rate=0.1)
    with pytest.raises(ValueError):
        ka.flash_qkv_attention(*args, torch.zeros(3, 1, 1, 16), n_head=2)
    # no fallback off the CPU: a tensor the kernel cannot take raises
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        ka.flash_qkv_attention(*meta, n_head=2)


# ---------------------------------------------------------------------------
# fused_decode_step
# ---------------------------------------------------------------------------

_LAYERS, _LAYER = 2, 1


def _decode_inputs(dm, di, b=4, h=8, dh=64, max_t=128, cross_t=128, seed=0):
    rng = np.random.RandomState(seed)
    hd = h * dh

    def f(*shape, scale=0.1):
        return (rng.randn(*shape) * scale).astype(np.float32)

    weights = [f(b, 1, dm, scale=1.0), f(dm, 3 * hd), f(hd, dm),
               f(dm) + 1, f(dm), f(dm, hd), f(hd, dm), f(dm) + 1, f(dm),
               f(dm, di), f(di), f(di, dm), f(dm), f(dm) + 1, f(dm)]
    caches = [f(_LAYERS, b, max_t, h, dh, scale=1.0),
              f(_LAYERS, b, max_t, h, dh, scale=1.0),
              f(_LAYERS, b, cross_t, h, dh, scale=1.0),
              f(_LAYERS, b, cross_t, h, dh, scale=1.0)]
    # ragged self lengths (mid-block and a full buffer), lane 2 inactive,
    # lane 3 with an empty cross cache
    pos = np.array([0, 4, 36, 127], np.int32)
    active = np.array([1, 1, 0, 1], np.int32)
    ints = [pos, pos + active, np.array([3, 128, 60, 0], np.int32), active]
    return weights, caches, ints


def _run_port(weights, caches, ints, h):
    t = [torch.from_numpy(a.copy()) for a in weights + caches + ints]
    out, ck, cv = kds.fused_decode_step(*t, layer=_LAYER, n_head=h,
                                        scale=64 ** -0.5)
    assert ck is t[15] and cv is t[16]  # the self cache is written in place
    return out, ck, cv


@pytest.mark.parametrize("dm,di,fuse_ffn", [(128, 256, True),
                                            (128, 9216, False)])
def test_fused_decode_step_matches_jax(dm, di, fuse_ffn):
    """Both plan modes of the reference megastep (fused FFN and the split
    _ffn_kernel launch), ragged lengths, an inactive and an empty lane."""
    plan = jax_decode_step._megastep_plan(dm, 8, 64, di, 128, 128,
                                          "float32")
    assert plan.ok and plan.fuse_ffn == fuse_ffn
    weights, caches, ints = _decode_inputs(dm, di)
    got = _run_port(weights, caches, ints, h=8)

    jw = [jnp.asarray(a) for a in weights + caches + ints]
    kw = dict(layer=_LAYER, n_head=8, scale=64 ** -0.5)
    kernel = jax_decode_step.fused_decode_step(*jw, interpret=True, **kw)
    composed = jax_decode_step.reference_decode_step(*jw, **kw)
    for g, k in zip(got, kernel):
        _close(g, k)
    # the composition's plain softmax spreads an empty lane uniformly
    # over the cache where the kernel (and the port) give it 0: hold the
    # lanes with a non-empty cross cache against it
    _close(got[0][:3], composed[0][:3])
    _close(got[1], composed[1])
    _close(got[2], composed[2])


def test_inactive_lane_keeps_its_cache_rows():
    weights, caches, ints = _decode_inputs(128, 256, seed=3)
    _, ck, cv = _run_port(weights, caches, ints, h=8)
    np.testing.assert_array_equal(ck[:, 2].numpy(), caches[0][:, 2])
    np.testing.assert_array_equal(cv[:, 2].numpy(), caches[1][:, 2])
    changed = (ck[_LAYER].numpy() != caches[0][_LAYER]).any(axis=(2, 3))
    assert changed.sum() == 3 and not changed[2].any()  # one row per lane


def test_decode_wrappers_refuse_non_cpu_tensors():
    weights, caches, ints = _decode_inputs(128, 256)
    t = [torch.from_numpy(a).to("meta") for a in weights + caches + ints]
    with pytest.raises(ValueError):
        kds.fused_decode_step(*t, layer=_LAYER, n_head=8, scale=0.125)
    with pytest.raises(ValueError):
        kds.ffn_epilogue(t[0], *t[9:15])


def test_sample_token_first_max_like_jax():
    logits = np.array([[0.1, 3.0, 3.0, -1.0], [2.0, 2.0, 2.0, 2.0],
                       [-5.0, -4.0, -4.5, -4.0]], np.float32)
    got = sample_token(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(logits, -1)))
    assert got.tolist() == [1, 0, 1]
