"""paddle_tpu_torch dropout against the JAX package, on the CPU.

The port's hash PRNG (``kernels/hash_rng.py``) must give the reference's
bits for the same seeds: ``mix32``, ``mix32_fast``, ``keep_mask``,
``keep_mask_attn`` and the per-site seed of a step key
(``seed_from_key_data``, rbg and threefry keys) are compared bit for bit.
On CPU tensors the dropout-add Function (kernels #16, #17) and the
attention Functions (#1-#4, #6, #7 with weights dropout) run their plain
twins, which are held against the reference's ``dropout_add`` (its Pallas
kernel in interpret mode at 128 columns, its XLA fallback at 32) and its
flash kernels in interpret mode with ``dropout_rate=0.1``.  The model's
dropout sites, its seeding, the agreement of its two attention routes
under the same seeds and a serving path untouched by ``dropout_rate`` are
checked on the port alone.  Inputs are numpy arrays from seeds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.executor import prng_key
from paddle_tpu.kernels import attention as jax_attention
from paddle_tpu.kernels import dropout_epilogue as jax_dropout
from paddle_tpu.kernels import hash_rng as jax_hash
from paddle_tpu_torch import GenerationSession, Transformer, make_batch
from paddle_tpu_torch.interop import dropout_seeds
from paddle_tpu_torch.kernels import attention as ka
from paddle_tpu_torch.kernels import dropout_epilogue as kde
from paddle_tpu_torch.kernels import hash_rng

RATE = 0.1
#: f32 on both sides; one multiply and one add per element
TOL_ELEMENTWISE = 1e-6
#: f32 attention on both sides, summed in different orders
TOL_ATTN = 1e-5
#: the fused kernels' own tolerance against the composed path (as
#: tests/test_torch_qkv_attention.py)
RTOL_QKV, ATOL_QKV = 2e-4, 1e-6


def _u32(rng, *shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jseed(seed):
    return jnp.asarray([seed], jnp.uint32)


# ---------------------------------------------------------------------------
# the hash
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mix32", "mix32_fast"])
def test_mixers_bit_equal(name):
    """Both mixers over 4096 seeded uint32s, and the extremes, bit for
    bit."""
    x = np.concatenate([_u32(np.random.RandomState(0), 4096),
                        np.array([0, 1, 0xFFFFFFFF, 0x80000000], np.uint32)])
    want = np.asarray(getattr(jax_hash, name)(jnp.asarray(x)))
    got = getattr(hash_rng, name)(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("rate", [0.1, 0.5, 1e-9, 0.999])
def test_keep_threshold(rate):
    assert hash_rng.keep_threshold(rate) == jax_hash.keep_threshold(rate)


@pytest.mark.parametrize("shape,rate", [((4, 33), 0.1), ((2, 3, 128), 0.3),
                                        ((1000,), 0.5)])
def test_keep_mask_bit_equal(shape, rate):
    """The flat-index mask of the dropout and dropout-add sites."""
    for seed in _u32(np.random.RandomState(1), 3):
        want = np.asarray(jax_hash.keep_mask(jnp.uint32(seed), shape, rate))
        got = hash_rng.keep_mask(int(seed), shape, rate)
        assert got.shape == shape
        assert torch.equal(got, torch.from_numpy(np.array(want)))


@pytest.mark.parametrize("shape", [(2, 3, 17, 29), (1, 2, 64, 64),
                                   (3, 1, 5, 40)])
def test_keep_mask_attn_bit_equal(shape):
    """The attention-weights mask: (seed, b*H + h, q*Tk + k)."""
    for seed in _u32(np.random.RandomState(2), 3):
        want = np.asarray(jax_hash.keep_mask_attn(jnp.uint32(seed), shape,
                                                  RATE))
        got = hash_rng.keep_mask_attn(int(seed), shape, RATE)
        assert torch.equal(got, torch.from_numpy(np.array(want)))
    with pytest.raises(ValueError, match="2\\^32"):
        hash_rng.keep_mask_attn(1, (1, 1, 2 ** 17, 2 ** 16), RATE)


@pytest.mark.parametrize("impl", ["rbg", "threefry2x32"])
def test_seed_from_key_data_bit_equal(impl):
    """A step key as the executor makes it (fold_in of the program's key
    and the run id) and the rng_ids of a program give the reference's
    per-site seeds; interop.dropout_seeds maps a list of them."""
    rng_ids = [1_000_001, 1_000_017, 7, 0xFFFFFFFF]
    for run_id in (1, 2, 1234):
        key = jax.random.fold_in(jax.random.key(0, impl=impl), run_id)
        data = np.asarray(jax.random.key_data(key))
        want = [int(jax_hash.seed_from_key(key, r)) for r in rng_ids]
        assert [hash_rng.seed_from_key_data(data, r)
                for r in rng_ids] == want
        assert dropout_seeds(data, rng_ids) == want
    key = jax.random.fold_in(prng_key(0), 3)  # the executor's own key
    assert dropout_seeds(np.asarray(jax.random.key_data(key)), [5]) == [
        int(jax_hash.seed_from_key(key, 5))]


# ---------------------------------------------------------------------------
# dropout_add (#16, #17) and dropout
# ---------------------------------------------------------------------------


def _dropout_inputs(d, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 24, d).astype(np.float32)
    res = rng.randn(2, 24, d).astype(np.float32)
    g = rng.randn(2, 24, d).astype(np.float32)
    return x, res, g, int(_u32(rng, 1)[0])


@pytest.mark.parametrize("d,route", [(128, "interpret"), (32, "xla")])
def test_dropout_add_matches_reference(d, route):
    """Forward and jax.vjp of the reference's dropout_add (its Pallas
    kernel in interpret mode where the columns are a multiple of 128, its
    XLA fallback at 32) against the port's Function: the keep pattern
    bit for bit, values within 1e-6, dres = g."""
    x, res, g, seed = _dropout_inputs(d)
    ok = jax_dropout._plan(x.shape, x.dtype, None)[0]
    assert ok == (route == "interpret")
    want, vjp = jax.vjp(lambda a, r: jax_dropout.dropout_add(
        a, r, RATE, _jseed(seed)), _j(x), _j(res))
    want_dx, want_dres = vjp(_j(g))
    tx = torch.from_numpy(x).requires_grad_()
    tr = torch.from_numpy(res).requires_grad_()
    out = kde.dropout_add(tx, tr, RATE, seed)
    out.backward(_t(g))
    kept = np.asarray(want) != np.asarray(res)
    assert torch.equal(out.detach() != tr.detach(), torch.from_numpy(kept))
    _close(out.detach(), want, TOL_ELEMENTWISE, TOL_ELEMENTWISE)
    _close(tx.grad, want_dx, TOL_ELEMENTWISE, 0)
    np.testing.assert_array_equal(tr.grad.numpy(), np.asarray(want_dres))
    np.testing.assert_array_equal(tx.grad.numpy() != 0, kept)
    share = kept.mean()
    assert abs(share - (1 - RATE)) < 0.03, share


def test_dropout_matches_reference_keep_mask():
    """The embedding sites' dropout (#16 without a residual, #17 for its
    gradient) is the reference's lower_dropout: keep_mask of the seed over
    the flat index, x / (1 - p) where kept."""
    x, _, g, seed = _dropout_inputs(128, seed=1)
    keep = np.asarray(jax_hash.keep_mask(jnp.uint32(seed), x.shape, RATE))
    want = np.where(keep, x * np.float32(1 / (1 - RATE)), 0)
    tx = torch.from_numpy(x).requires_grad_()
    out = kde.dropout(tx, RATE, seed)
    out.backward(_t(g))
    np.testing.assert_array_equal(out.detach().numpy(), want)
    np.testing.assert_array_equal(
        tx.grad.numpy(), np.where(keep, g * np.float32(1 / (1 - RATE)), 0))


def test_dropout_add_plain_at_rate_zero_and_guards():
    """Rate 0 is a plain add (and dropout the identity); a rate outside
    [0, 1) and mismatched shapes raise; the backward regenerates the mask
    (two calls, same bits); the twins run float64."""
    x, res, _, seed = _dropout_inputs(32, seed=2)
    tx, tr = torch.from_numpy(x), torch.from_numpy(res)
    assert torch.equal(kde.dropout_add(tx, tr, 0.0, seed), tx + tr)
    assert kde.dropout(tx, 0.0, seed) is tx
    with pytest.raises(ValueError, match="outside"):
        kde.dropout_add(tx, tr, 1.0, seed)
    with pytest.raises(ValueError, match="must match"):
        kde.dropout_add(tx, tr[:, :1], RATE, seed)
    assert torch.equal(kde.dropout_add_bwd(tx, RATE, seed),
                       kde.dropout_add_bwd(tx, RATE, seed))
    out64 = kde.dropout_add(tx.double(), tr.double(), RATE, seed)
    assert out64.dtype == torch.float64
    _close(out64, kde.dropout_add(tx, tr, RATE, seed), 1e-6, 1e-6)


@pytest.mark.parametrize("rate", [RATE, 0.0])
@pytest.mark.parametrize("residual", [True, False])
def test_dropout_add_bf16_bit_equal_to_pallas(residual, rate):
    """bf16 (amp): the port's #16 twin (with a residual, and without one,
    the embedding sites' dropout) and #17's twin (its backward) against
    the reference's dropout_add in interpret mode on the same bf16 inputs,
    bit for bit: inv_keep, each product and each sum rounded to bf16 as
    the Pallas bodies compute them in x's dtype.  Without a residual the
    reference is given a zero one (adding +0 changes no value).  At rate
    0 it is a bf16 add, and dropout the identity."""
    x, res, g, seed = _dropout_inputs(128, seed=5)
    xb, rb, gb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, res, g))
    if not residual:
        rb = jnp.zeros_like(rb)
    assert jax_dropout._plan(xb.shape, xb.dtype, True)[0]
    want, vjp = jax.vjp(lambda a: jax_dropout.dropout_add(
        a, rb, rate, _jseed(seed), interpret=True), xb)
    (want_dx,) = vjp(gb)
    tx = torch.from_numpy(x).bfloat16().requires_grad_()
    if residual:
        out = kde.dropout_add(tx, torch.from_numpy(res).bfloat16(), rate,
                              seed)
    else:
        out = kde.dropout(tx, rate, seed)
    out.backward(torch.from_numpy(g).bfloat16())
    assert out.dtype == tx.grad.dtype == torch.bfloat16

    def bits(a):
        return np.asarray(a.astype(jnp.float32))

    np.testing.assert_array_equal(out.detach().float().numpy(), bits(want))
    np.testing.assert_array_equal(tx.grad.float().numpy(), bits(want_dx))
    if rate:
        np.testing.assert_array_equal(
            kde.reference_dropout_add_bwd(
                torch.from_numpy(g).bfloat16(), rate, seed).float().numpy(),
            bits(want_dx))


@pytest.mark.parametrize("shape,offset", [((8 * 37 + 5,), 0), ((7, 43), 0),
                                          ((8 * 37 + 5,), 1), ((7, 43), 1)])
def test_dropout_add_bf16_odd_sizes_bit_equal_to_reference(shape, offset):
    """bf16 at a numel that is not a multiple of 8 (the kernels' scalar
    tail) and on a view that starts at an odd element (their element-by-
    element path): the port's twins of #16 (with and without a residual)
    and #17 against the reference's dropout_add (its XLA fallback: the
    columns are no multiple of 128) and jax.vjp, bit for bit."""
    n = int(np.prod(shape))
    rng = np.random.RandomState(11 + offset)
    x, res, g = (rng.randn(n + offset).astype(np.float32) for _ in range(3))
    seed = int(_u32(rng, 1)[0])
    tx, tr, tg = (torch.from_numpy(a).bfloat16()[offset:].view(shape)
                  for a in (x, res, g))
    assert offset == 0 or tx.storage_offset() == offset
    xb, rb, gb = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                  for t in (tx, tr, tg))
    assert not jax_dropout._plan(xb.shape, xb.dtype, True)[0]
    want, vjp = jax.vjp(lambda a: jax_dropout.dropout_add(
        a, rb, RATE, _jseed(seed), interpret=True), xb)
    (want_dx,) = vjp(gb)
    plain = jax_dropout.dropout_add(xb, jnp.zeros_like(rb), RATE,
                                    _jseed(seed), interpret=True)

    def bits(a):
        return np.asarray(a.astype(jnp.float32))

    for got, ref in ((kde.reference_dropout_add(tx, tr, RATE, seed), want),
                     (kde.reference_dropout_add(tx, None, RATE, seed), plain),
                     (kde.reference_dropout_add_bwd(tg, RATE, seed),
                      want_dx)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), bits(ref))
        np.testing.assert_array_equal(np.signbit(got.float().numpy()),
                                      np.signbit(bits(ref)))


# ---------------------------------------------------------------------------
# the premise of the bf16 kernels' packed arithmetic: PyTorch's bf16 x and
# + (f32, then rounded to bf16), which the twins compute, round the exact
# value once, as mul.rn.bf16x2 and add.rn.bf16x2 do on the card
# ---------------------------------------------------------------------------


def _bf16_parts(bits):
    """(sign, m, e) of finite bf16 patterns (int arrays): the value is
    (-1)^sign * m * 2^e, m an integer below 2^8."""
    bits = np.asarray(bits, np.int64)
    exp, frac = (bits >> 7) & 0xFF, bits & 0x7F
    m = np.where(exp == 0, frac, frac | 0x80)
    return bits >> 15, m, np.where(exp == 0, 1, exp) - 134


def _round_bf16(a, e):
    """The integers a >= 0 times 2^e (int64 arrays, a < 2^53) rounded once
    to bf16, to nearest even, with bf16's subnormals (steps of 2^-133) and
    overflow to inf: float64 magnitudes."""
    _, length = np.frexp(a.astype(np.float64))  # a's bit length (0 at 0)
    step = np.maximum(e + length - 1 - 7, -133)  # the result's bf16 step
    shift = np.clip(step - e, 0, 62)
    q = a >> shift
    rem = a - (q << shift)
    half = np.where(shift > 0, np.int64(1) << np.maximum(shift - 1, 0), 1)
    q = q + ((rem > half) | ((rem == half) & (shift > 0) & (q % 2 == 1)))
    value = np.ldexp(q.astype(np.float64), e + shift)
    return np.where(value >= 2.0 ** 128, np.inf, value)


def _bf16_tensor(bits):
    return torch.from_numpy(np.asarray(bits, np.uint16).view(np.int16)).view(
        torch.bfloat16)


def _assert_same_values(got, want):
    """bf16 ``got`` equals the float64 ``want`` everywhere, the sign of
    zero included; a NaN matches a NaN."""
    got = got.double().numpy()
    np.testing.assert_array_equal(got, want)
    number = ~np.isnan(want)
    np.testing.assert_array_equal(np.signbit(got[number]),
                                  np.signbit(want[number]))


@pytest.mark.parametrize("rate", [RATE, 0.5])
def test_bf16_product_rounds_the_exact_product_once(rate):
    """Every bf16 x (all 65,536 patterns: subnormals, +-0, +-inf, NaN and
    products that overflow included) times the bf16 inv_keep, as the twin
    multiplies: equal to the exact product rounded once to bf16."""
    bits = np.arange(2 ** 16)
    scale = kde._scale(rate, torch.bfloat16)
    got = _bf16_tensor(bits) * scale
    s_sign, s_m, s_e = _bf16_parts(int(scale.view(torch.int16)) & 0xFFFF)
    sign, m, e = _bf16_parts(bits)
    exact = _round_bf16(m * s_m, e + s_e)
    exact = np.where(sign ^ s_sign, -exact, exact)
    x = _bf16_tensor(bits).double().numpy()
    special = ~np.isfinite(x)
    want = np.where(special, x * float(scale), exact)
    _assert_same_values(got, want)


def _sum_inputs(kind, rng):
    """bf16 pattern pairs (a, b) of one kind: 2^20 random patterns of
    each; ties (b half a step of a's bf16 grid, or 1.5, 2.5 steps, or just
    off a half step); b 9-30 binades below a."""
    if kind == "random":
        return rng.randint(0, 2 ** 16, size=(2, 2 ** 20))
    n = 2 ** 16
    a = (rng.randint(0, 2, n) << 15) | (rng.randint(40, 227, n) << 7) | \
        rng.randint(0, 128, n)
    lead = ((a >> 7) & 0xFF) - 127  # a's binade: its step is 2^(lead - 7)
    sign = np.where(rng.rand(n) < 0.5, -1.0, 1.0)
    if kind == "ties":
        size = np.array([1.0, 3.0, 5.0, 1 + 2 ** -7, 1 - 2 ** -8])[
            rng.randint(0, 5, n)]
        b = sign * np.ldexp(size, lead - 8)
    else:
        b = sign * np.ldexp(1 + rng.randint(0, 128, n) / 128,
                            lead - rng.randint(9, 31, n))
    b_bits = (b.astype(np.float32).view(np.uint32) >> 16).astype(np.int64)
    assert np.array_equal(_bf16_tensor(b_bits).double().numpy(), b)
    return np.stack([a, b_bits])


@pytest.mark.parametrize("kind", ["random", "ties", "gaps"])
def test_bf16_sum_rounds_the_exact_sum_once(kind):
    """bf16 a + b, as the twin adds the residual: equal to the exact sum
    rounded once to bf16, on 2^20 random pattern pairs (specials
    included), on ties at the last bit and on exponent gaps of 9-30."""
    a_bits, b_bits = _sum_inputs(kind, np.random.RandomState(21))
    got = _bf16_tensor(a_bits) + _bf16_tensor(b_bits)
    (sa, ma, ea), (sb, mb, eb) = _bf16_parts(a_bits), _bf16_parts(b_bits)
    # align on the smaller exponent, at most 40 binades apart: a smaller
    # operand further down only decides which side of the larger one the
    # sum falls, which a unit 40 binades down decides the same way
    hi = np.maximum(ea, eb)
    low = hi - np.minimum(hi - np.minimum(ea, eb), 40)

    def scaled(sign, m, e):  # the operand in units of 2^low
        m = np.where(sign == 1, -m, m)
        return np.where(e >= low, m << np.maximum(e - low, 0), np.sign(m))

    total = scaled(sa, ma, ea) + scaled(sb, mb, eb)
    exact = _round_bf16(np.abs(total), low)
    zero_sign = np.where((sa == 1) & (sb == 1), -1.0, 1.0)
    exact = np.where(total < 0, -exact,
                     np.where(total == 0, zero_sign * 0.0, exact))
    a = _bf16_tensor(a_bits).double().numpy()
    b = _bf16_tensor(b_bits).double().numpy()
    special = ~(np.isfinite(a) & np.isfinite(b))
    with np.errstate(invalid="ignore"):
        want = np.where(special, a + b, exact)
    _assert_same_values(got, want)
    if kind == "ties":  # most of them sit exactly on a half step
        step = np.ldexp(1.0, np.frexp(a + b)[1] - 8)
        assert np.mean(np.mod(a + b, step) == step / 2) > 0.5


# ---------------------------------------------------------------------------
# weights dropout in the attention kernels' twins
# ---------------------------------------------------------------------------

B, H, D = 2, 2, 64
SCALE = D ** -0.5
#: (name, tq, tk, bias kind, causal), as tests/test_torch_flash_attention.py
FLASH_CASES = [
    ("no_bias", 32, 32, None, False),
    ("key_padding", 32, 64, "pad", False),
    ("causal_tq_gt_tk", 64, 32, "pad", True),
    ("masked_row", 64, 64, "masked", False),
]


def _flash_inputs(tq, tk, bias_kind, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, tq, H, D).astype(np.float32)
    k = rng.randn(B, tk, H, D).astype(np.float32)
    v = rng.randn(B, tk, H, D).astype(np.float32)
    g = rng.randn(B, tq, H, D).astype(np.float32)
    bias = None
    if bias_kind in ("pad", "masked"):
        bias = np.zeros((B, 1, 1 if bias_kind == "pad" else tq, tk),
                        np.float32)
        bias[1, ..., tk - 7:] = -1e9
        if bias_kind == "masked":
            bias[1, 0, 5, :] = -1e30
    elif bias_kind == "head":
        bias = (rng.randn(1, H, tq, tk) * 0.5).astype(np.float32)
    return q, k, v, g, bias, int(_u32(rng, 1)[0])


@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", FLASH_CASES)
def test_flash_twins_with_dropout_match_jax_kernels(name, tq, tk, bias_kind,
                                                    causal):
    """#4's, #6's and #7's twins at rate 0.1 against _fwd_kernel_bthd,
    _bwd_dq_kernel_bthd and _bwd_dkv_kernel_bthd (interpret, hash masks):
    output, lse, dq, dk, dv within 1e-5; the output differs from the
    undropped one."""
    q, k, v, g, bias, seed = _flash_inputs(tq, tk, bias_kind)
    jq, jk, jv, jg, jb = (_j(a) for a in (q, k, v, g, bias))
    ok, bq, bk, _ = jax_attention._plan(jq, jk, 512, 512, True, "bthd")
    assert ok
    out, lse = jax_attention._flash_forward(
        jq, jk, jv, jb, _jseed(seed), SCALE, causal, bq, bk, True, "bthd",
        dropout_rate=RATE)
    want = jax_attention._flash_backward(
        jq, jk, jv, jb, _jseed(seed), out, lse, jg, SCALE, causal, bq, bk,
        True, "bthd", dropout_rate=RATE)
    args = [_t(a) for a in (q, k, v, bias)]
    kw = dict(scale=SCALE, causal=causal, dropout_rate=RATE,
              dropout_seed=seed)
    got_out, got_lse = ka.flash_fwd(*args, **kw)
    _close(got_out, out, TOL_ATTN, TOL_ATTN)
    _close(got_lse, lse, TOL_ATTN, TOL_ATTN)
    assert not np.allclose(got_out.numpy(), ka.flash_fwd(
        *args, scale=SCALE, causal=causal)[0].numpy(), atol=1e-3)
    o, tg = _t(np.array(out)), _t(g)
    delta = (tg * o).sum(-1).transpose(1, 2).contiguous()
    bw = (*args, tg, _t(np.array(lse)), delta)
    dq = ka.flash_bwd_dq(*bw, **kw)
    dk, dv = ka.flash_bwd_dkv(*bw, **kw)
    for got, w in zip((dq, dk, dv), want):
        _close(got, w, TOL_ATTN, TOL_ATTN)


@pytest.mark.parametrize("name,tq,tk,bias_kind,causal", FLASH_CASES + [
    ("trainable_head_bias", 32, 64, "head", False)])
def test_flash_attention_with_dropout_matches_jax_vjp(name, tq, tk,
                                                      bias_kind, causal):
    """The port's differentiable flash_attention at rate 0.1 against
    jax.vjp of the reference's (interpret): output and dq, dk, dv, and
    dbias of a bias that requires grad (the plain recompute under the same
    mask), within 1e-5."""
    q, k, v, g, bias, seed = _flash_inputs(tq, tk, bias_kind, seed=1)
    trainable = bias_kind == "head"
    kw = dict(scale=SCALE, causal=causal, dropout_rate=RATE)

    def f(*a):
        b_ = a[3] if trainable else _j(bias)
        return jax_attention.flash_attention(
            *a[:3], b_, fmt="bthd", interpret=True, dropout_seed=_jseed(seed),
            **kw)

    primals = [_j(a) for a in (q, k, v)] + ([_j(bias)] if trainable else [])
    want, vjp = jax.vjp(f, *primals)
    want_grads = vjp(_j(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tb = _t(bias)
    if trainable:
        tb.requires_grad_()
    out = ka.flash_attention(*args, tb, dropout_seed=seed, fmt="bthd", **kw)
    out.backward(_t(g))
    _close(out.detach(), want, TOL_ATTN, TOL_ATTN)
    grads = [a.grad for a in args] + ([tb.grad] if trainable else [])
    for got, w in zip(grads, want_grads):
        _close(got, w, TOL_ATTN, TOL_ATTN)


DM = 128
#: (name, n_head, t, bias kind, causal) of the fused-projection route
QKV_CASES = [
    ("pad", 2, 64, "pad", False),
    ("decoder", 2, 64, "decoder", False),
    ("causal", 3, 128, None, True),
    ("trainable_bias", 2, 64, "dense", False),
]


def _qkv_inputs(n_head, t, bias_kind, seed=0):
    rng = np.random.RandomState(seed)
    hd = n_head * D
    x = (rng.randn(B, t, DM) * 0.3).astype(np.float32)
    w_qkv = (rng.randn(DM, 3 * hd) * 0.08).astype(np.float32)
    w_out = (rng.randn(hd, DM) * 0.08).astype(np.float32)
    g = (rng.randn(B, t, DM) * 0.3).astype(np.float32)
    pad = np.zeros((B, 1, 1, t), np.float32)
    pad[1, ..., t - 7:] = -1e9
    bias = None
    if bias_kind == "pad":
        bias = pad
    elif bias_kind == "decoder":
        bias = pad + np.triu(np.full((t, t), -1e9, np.float32), 1)[None,
                                                                    None]
    elif bias_kind == "dense":
        bias = (rng.randn(B, 1, t, t) * 0.5).astype(np.float32)
    return x, w_qkv, w_out, g, bias, int(_u32(rng, 1)[0])


@pytest.mark.parametrize("name,n_head,t,bias_kind,causal", QKV_CASES)
def test_qkv_attention_with_dropout_matches_jax_vjp(name, n_head, t,
                                                    bias_kind, causal):
    """flash_qkv_attention at rate 0.1 (#1's twin forward, #2's and #3's
    in the backward) against jax.vjp of the reference's (its fused kernels
    in interpret mode, hash masks): y and the gradients of x, w_qkv,
    w_out (and of a bias that requires grad), at the fused kernels'
    tolerance."""
    x, w_qkv, w_out, g, bias, seed = _qkv_inputs(n_head, t, bias_kind)
    trainable = bias_kind == "dense"
    kw = dict(n_head=n_head, scale=SCALE, causal=causal, dropout_rate=RATE)

    def f(*a):
        b_ = a[3] if trainable else _j(bias)
        return jax_attention.flash_qkv_attention(
            *a[:3], b_, interpret=True, dropout_seed=_jseed(seed), **kw)

    primals = [_j(a) for a in (x, w_qkv, w_out)] + (
        [_j(bias)] if trainable else [])
    want, vjp = jax.vjp(f, *primals)
    want_grads = vjp(_j(g))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w_qkv, w_out)]
    tb = _t(bias)
    if trainable:
        tb.requires_grad_()
    y = ka.flash_qkv_attention(*args, tb, dropout_seed=seed, **kw)
    y.backward(_t(g))
    _close(y.detach(), want, RTOL_QKV, ATOL_QKV)
    grads = [a.grad for a in args] + ([tb.grad] if trainable else [])
    for got, w in zip(grads, want_grads):
        _close(got, w, RTOL_QKV, ATOL_QKV)


def test_qkv_and_bthd_routes_draw_the_same_mask():
    """flash_qkv_attention and the composition x W -> flash_attention(bthd)
    -> W_out at the same seed give the same output and gradients (the
    masks key on the same (seed, b*H + h, q*Tk + k)); another seed moves
    the output."""
    x, w_qkv, w_out, g, bias, seed = _qkv_inputs(2, 64, "decoder", seed=3)
    outs = []
    for fused in (True, False):
        args = [torch.from_numpy(a).requires_grad_()
                for a in (x, w_qkv, w_out)]
        if fused:
            y = ka.flash_qkv_attention(*args, _t(bias), n_head=2,
                                       scale=SCALE, dropout_rate=RATE,
                                       dropout_seed=seed)
        else:
            q, k, v = (a.reshape(B, 64, 2, D) for a in torch.split(
                args[0] @ args[1], 2 * D, dim=-1))
            ctx = ka.flash_attention(q, k, v, _t(bias), scale=SCALE,
                                     dropout_rate=RATE, dropout_seed=seed,
                                     fmt="bthd")
            y = ctx.reshape(B, 64, 2 * D) @ args[2]
        y.backward(_t(g))
        outs.append([y.detach()] + [a.grad for a in args])
    for got, want in zip(*outs):
        _close(got, want, 1e-5, 1e-6)
    other = ka.flash_qkv_attention(*(_t(a) for a in (x, w_qkv, w_out)),
                                   _t(bias), n_head=2, scale=SCALE,
                                   dropout_rate=RATE, dropout_seed=seed + 1)
    assert not torch.allclose(other, outs[0][0], atol=1e-4)


# ---------------------------------------------------------------------------
# the model: sites, seeds, routes, eval and serving
# ---------------------------------------------------------------------------

WIDTHS = dict(src_vocab_size=64, trg_vocab_size=64, max_length=32,
              n_layer=2, n_head=2, d_key=64, d_value=64, d_model=128,
              d_inner_hid=256)


def _model(**kw):
    return Transformer(**{**WIDTHS, **kw}, device="cpu").init_params(seed=0)


def _feed():
    return {k: torch.from_numpy(v) for k, v in make_batch(
        2, 32, 16, 2, 64, 64, np.random.RandomState(0)).items()}


def test_dropout_sites_follow_the_reference_op_order():
    """Transformer-base has 50 sites: per step one seed for each
    embedding, 3 per encoder layer and 5 per decoder layer, in the order
    the reference program draws its rng_ids."""
    model = Transformer(**{**WIDTHS, "n_layer": 6}, device="cpu")
    sites = model.dropout_sites()
    assert len(sites) == 50 and len(set(sites)) == 50
    assert sites[:4] == ["src_emb_dropout", "encoder.0.attn",
                         "encoder.0.attn_dropout_add",
                         "encoder.0.ffn_dropout_add"]
    assert sites[19:25] == ["trg_emb_dropout", "decoder.0.self_attn",
                            "decoder.0.self_dropout_add",
                            "decoder.0.cross_attn",
                            "decoder.0.cross_dropout_add",
                            "decoder.0.ffn_dropout_add"]
    assert len(_model().dropout_sites()) == 18


def test_routes_agree_under_the_same_seeds():
    """The fused-qkv and flag-off routes at rate 0.1 with the same seeds:
    loss within 1e-6 relative, step-1 gradients within 1e-5 relative per
    tensor (the same masks at every site)."""
    seeds = list(range(1000, 1018))
    results = []
    for fused in (True, False):
        model = _model(dropout_rate=RATE, fused_qkv_attention=fused)
        loss, _ = model(**_feed(), dropout_seeds=seeds)
        loss.backward()
        results.append((loss.item(), {n: p.grad.numpy() for n, p in
                                      model.named_parameters()
                                      if p.grad is not None}))
    (loss_f, grads_f), (loss_u, grads_u) = results
    assert abs(loss_f - loss_u) <= 1e-6 * abs(loss_u)
    for n, g in grads_f.items():
        rel = np.linalg.norm(g - grads_u[n]) / np.linalg.norm(grads_u[n])
        assert rel <= 1e-5, n


def test_seeds_from_a_generator_and_eval_mode():
    """Without dropout_seeds the step draws its seeds from the generator
    (same generator seed, same loss; another, another loss); eval mode
    gives the undropped loss of a rate-0 model whatever the seeds."""
    model = _model(dropout_rate=RATE)
    losses = [model(**_feed(), generator=torch.Generator().manual_seed(s))[0]
              .item() for s in (5, 5, 6)]
    assert losses[0] == losses[1] != losses[2]
    plain = _model()(**_feed())[0].item()
    assert abs(losses[0] - plain) > 1e-4
    model.eval()
    assert model(**_feed(), dropout_seeds=[1] * 18)[0].item() == plain


def test_serving_never_drops(monkeypatch):
    """A model built with dropout_rate 0.1 and left in training mode
    serves the tokens of a rate-0 model: prefill, the cross-cache fill and
    the decoder step never reach a dropout kernel or its mask."""
    src = _feed()["src_word"][..., 0].numpy()
    plain = GenerationSession(_model(), 2, 32, 8, bos_id=0, eos_id=-1)
    want = plain.generate(src)[0]

    def boom(*a, **k):
        raise AssertionError("serving drew a dropout mask")

    monkeypatch.setattr(hash_rng, "keep_mask", boom)
    monkeypatch.setattr(hash_rng, "keep_mask_attn", boom)
    model = _model(dropout_rate=RATE)
    assert model.training
    for fused in (True, False):
        model.fused_decode_step = fused
        sess = GenerationSession(model, 2, 32, 8, bos_id=0, eos_id=-1)
        np.testing.assert_array_equal(sess.generate(src)[0], want)
