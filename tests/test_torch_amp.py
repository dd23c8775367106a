"""paddle_tpu_torch.amp against the JAX package's paddle_tpu.amp, on the CPU.

The cast policy is applied to the same numpy inputs on both sides, for
every op type of the four sets (WHITE, BLACK, GRAY_FOLLOW, SLOT_WHITE), as
a forward op and as its grad op, and the dtypes must match slot by slot;
the dynamic loss scaler must follow the reference's scale and counts over
a seeded overflow sequence; enable, disable, bf16_guard and the policy's
scope act on a model as the reference's act on a Program.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import amp as ref_amp
from paddle_tpu_torch import Transformer, amp

#: op types of every set, and one the policy leaves alone
OPS = sorted(ref_amp.WHITE_OPS | ref_amp.BLACK_OPS | ref_amp.GRAY_FOLLOW_OPS
             | set(ref_amp.SLOT_WHITE_OPS)) + ["layer_norm"]


def test_op_sets_are_the_reference_sets():
    assert amp.WHITE_OPS == ref_amp.WHITE_OPS
    assert amp.BLACK_OPS == ref_amp.BLACK_OPS
    assert amp.GRAY_FOLLOW_OPS == ref_amp.GRAY_FOLLOW_OPS
    assert amp.SLOT_WHITE_OPS == ref_amp.SLOT_WHITE_OPS


def _inputs(slots, kinds, rng):
    """{slot: [numpy array or None]} of the given kinds ("f32", "bf16",
    "i32", None), on both sides: (torch dict, jax dict)."""
    torch_ins, jax_ins = {}, {}
    for slot, kind in zip(slots, kinds):
        a = rng.randn(3, 4).astype(np.float32)
        if kind is None:
            torch_ins[slot], jax_ins[slot] = [None], [None]
        elif kind == "i32":
            a = a.astype(np.int32)
            torch_ins[slot] = [torch.from_numpy(a)]
            jax_ins[slot] = [jnp.asarray(a)]
        elif kind == "f32":
            torch_ins[slot] = [torch.from_numpy(a)]
            jax_ins[slot] = [jnp.asarray(a)]
        else:
            torch_ins[slot] = [torch.from_numpy(a).bfloat16()]
            jax_ins[slot] = [jnp.asarray(a).astype(jnp.bfloat16)]
    return torch_ins, jax_ins


def _name(v):
    if v is None:
        return None
    return str(v.dtype).replace("torch.", "")


#: input mixes: every float f32, one input bf16, and ints beside floats
MIXES = [("f32", "f32", "i32", None), ("f32", "bf16", "i32", None),
         ("bf16", "bf16", "f32", "f32")]


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("op", OPS)
def test_cast_policy_matches_reference(op, grad):
    """For each input mix, the slots' dtypes after the port's
    apply_cast_policy are the reference's, with conv2d_bn's slots by name
    (Input, Filter, Residual cast; Scale stays)."""
    rng = np.random.RandomState(len(op))
    slots = (("Input", "Filter", "Residual", "Scale") if op == "conv2d_bn"
             else ("X", "Y", "Label", "Bias"))
    op_type = op + "_grad" if grad else op
    for kinds in MIXES:
        t_ins, j_ins = _inputs(slots, kinds, rng)
        got = amp.apply_cast_policy(op_type, t_ins)
        want = ref_amp.apply_cast_policy(op_type, j_ins)
        assert got.keys() == want.keys()
        for slot in slots:
            assert [_name(v) for v in got[slot]] == [
                _name(v) for v in want[slot]], (op_type, kinds, slot)


def test_cast_is_the_policy_only_inside_an_enabled_forward():
    """amp.cast is the identity outside a policy scope and under a disabled
    model's scope; inside an enabled model's it applies the policy."""
    model = torch.nn.Linear(2, 2)
    x, w = torch.ones(2, 2), torch.ones(2, 2)
    assert amp.cast("mul", x, w) == (x, w)
    with amp.policy_scope(model):
        assert not amp.active()
        assert amp.cast("mul", x, w)[0].dtype == torch.float32
    amp.enable(model)
    with amp.policy_scope(model):
        assert amp.active()
        got = amp.cast("mul", x, w)
        assert [a.dtype for a in got] == [torch.bfloat16] * 2
        assert amp.cast("elementwise_add", x, w)[1].dtype == torch.float32
        mixed = amp.cast("elementwise_add", got[0], w)
        assert [a.dtype for a in mixed] == [torch.bfloat16] * 2
        assert amp.cast("mean", got[0])[0].dtype == torch.float32
        assert amp.cast("mul", x, None)[1] is None
    assert not amp.active()


def test_enable_disable_and_bf16_guard_on_a_model():
    model = Transformer(src_vocab_size=16, trg_vocab_size=16, max_length=8,
                        n_layer=1, n_head=1, d_model=64, d_inner_hid=64,
                        device="cpu")
    assert not amp.is_enabled(model)
    with amp.bf16_guard(model):
        assert amp.is_enabled(model)
    assert not amp.is_enabled(model)
    amp.enable(model)
    assert amp.is_enabled(model)
    with amp.bf16_guard(model):
        assert amp.is_enabled(model)
    assert amp.is_enabled(model)
    amp.disable(model)
    assert not amp.is_enabled(model)


@pytest.mark.parametrize("interval", [1, 3, 2000])
def test_loss_scaler_matches_reference(interval):
    """Over a seeded overflow sequence (a few bursts near the min and max
    scales) the port's scaler gives the reference's scale, good steps and
    overflow count after every update."""
    rng = np.random.RandomState(interval)
    found = rng.rand(400) < 0.3
    found[100:140] = True    # down to min_scale
    found[200:260] = False   # growth toward max_scale
    kw = dict(init_scale=2.0 ** 4, growth_factor=4.0, backoff_factor=0.25,
              growth_interval=interval, min_scale=0.5, max_scale=2.0 ** 10)
    got, want = amp.LossScaler(**kw), ref_amp.LossScaler(**kw)
    for f in found:
        assert got.update(bool(f)) == want.update(bool(f))
        assert (got.scale, got.good_steps, got.overflow_steps) == (
            want.scale, want.good_steps, want.overflow_steps)
    assert got.overflow_steps == int(found.sum())


def test_active_loss_scaler_is_host_state():
    assert amp.active_loss_scaler() is None
    scaler = amp.LossScaler()
    amp.set_loss_scaler(scaler)
    try:
        assert amp.active_loss_scaler() is scaler
    finally:
        amp.set_loss_scaler(None)
    assert amp.active_loss_scaler() is None
