"""Automatic mixed precision (bf16) for the port's models.

Counterpart of ``paddle_tpu/amp.py``: the same cast policy, applied op by
op while an enabled model's ``forward`` runs, as the reference applies it
to each op's inputs at trace time.

* WHITE ops (matmul and attention: ``mul``, ``fused_qkv_attention``,
  ``fused_attention``, ...) cast every float input to bf16, an attention
  bias included;
* BLACK ops (reductions, losses, optimizer updates) cast to f32;
* GRAY_FOLLOW ops (``dropout_add``, the ``elementwise_*`` ops) cast the
  rest down to bf16 when any input is bf16, and leave f32 inputs alone;
* SLOT_WHITE ops cast only the named slots (``conv2d_bn``'s convolution
  operands and residual; its scale, bias and statistics stay f32), which
  :func:`cast_slots` takes by name;
* every other op takes its inputs as they come: ``layer_norm`` keeps its
  input's dtype (statistics in f32), ``relu`` follows its input,
  ``softmax_with_cross_entropy`` shifts bf16 logits in bf16 and
  exponentiates in f32, ``lookup_table`` and ``dropout`` stay f32.

A grad op (``<op>_grad``) takes its forward op's policy; on the port
autograd runs each cast's backward, so a parameter's gradient comes back
in the parameter's dtype, f32, and the optimizers see f32 gradients and
f32 master weights.  This is not ``torch.autocast``, whose lists differ
(it runs layer norm and softmax in f32 and leaves a bias add to type
promotion).

Usage::

    amp.enable(model)          # every later forward runs under the policy
    with amp.bf16_guard(model):
        loss, _ = model(**batch)

bf16 keeps f32's exponent range, so the policy needs no loss scaling;
:class:`LossScaler` is the reference's dynamic scaler for recipes that
want one, host state only.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

#: ops whose work is matrix products: computed in bf16
WHITE_OPS = frozenset({
    "conv2d",
    "depthwise_conv2d",
    "conv2d_transpose",
    "conv3d",
    "mul",
    "matmul",
    "fused_attention",
    "fused_qkv_attention",
    "ring_attention",
})

#: numerically sensitive ops (reductions over many elements, exponentials,
#: running statistics, parameter updates): computed in f32
BLACK_OPS = frozenset({
    "group_norm",
    "data_norm",
    "lrn",
    "softmax",
    "log_softmax",
    "cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "bpr_loss",
    "huber_loss",
    "log_loss",
    "hinge_loss",
    "margin_rank_loss",
    "mean",
    "sum",
    "reduce_sum",
    "reduce_mean",
    "reduce_prod",
    "exp",
    "log",
    "cumsum",
    "accuracy",
    "auc",
    "fused_layer_norm_gelu",
    "sgd",
    "momentum",
    "lars_momentum",
    "adam",
    "adamax",
    "adagrad",
    "decayed_adagrad",
    "adadelta",
    "rmsprop",
    "ftrl",
    "proximal_gd",
    "proximal_adagrad",
})

#: ops that mix matrix products with f32 state in one op: only these slots
#: are cast to bf16
SLOT_WHITE_OPS = {
    "conv2d_bn": frozenset({"Input", "Filter", "Residual"}),
}

#: multi-input elementwise ops follow their activations: with any float
#: input in bf16 the rest are cast down
GRAY_FOLLOW_OPS = frozenset({
    "dropout_add",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
})

#: True while an enabled model's forward runs (see :func:`policy_scope`)
_ACTIVE = contextvars.ContextVar("paddle_tpu_torch_amp", default=False)


def enable(model) -> None:
    """Mark ``model`` for bf16 autocast: its later forwards run under the
    policy."""
    model._amp_bf16 = True


def disable(model) -> None:
    model._amp_bf16 = False


def is_enabled(model) -> bool:
    return bool(getattr(model, "_amp_bf16", False))


@contextlib.contextmanager
def bf16_guard(model):
    """``model`` under the policy inside the block, as it was after."""
    prev = getattr(model, "_amp_bf16", False)
    model._amp_bf16 = True
    try:
        yield
    finally:
        model._amp_bf16 = prev


@contextlib.contextmanager
def policy_scope(model):
    """The policy on while the block runs if ``model`` is enabled (a
    model's forward runs inside this); a disabled model leaves the state
    as it found it."""
    if not is_enabled(model):
        yield
        return
    token = _ACTIVE.set(True)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> bool:
    """Whether the policy applies to the ops running now."""
    return _ACTIVE.get()


def _cast_value(v, dtype):
    if not isinstance(v, torch.Tensor):
        return v
    if v.dtype == torch.float32 and dtype == torch.bfloat16:
        return v.to(torch.bfloat16)
    if v.dtype == torch.bfloat16 and dtype == torch.float32:
        return v.float()
    return v


def apply_cast_policy(op_type: str, ins: dict) -> dict:
    """The reference's policy over one op's inputs ``{slot: [tensor or
    None, ...]}``: a new dict with the float inputs cast.  A grad op
    (``X_grad``) takes X's policy, so forward and backward agree."""
    base = op_type[:-5] if op_type.endswith("_grad") else op_type
    slots = SLOT_WHITE_OPS.get(base)
    if slots is not None:
        return {slot: ([_cast_value(v, torch.bfloat16) for v in vals]
                       if slot in slots else list(vals))
                for slot, vals in ins.items()}
    if base in WHITE_OPS:
        target = torch.bfloat16
    elif base in BLACK_OPS:
        target = torch.float32
    elif base in GRAY_FOLLOW_OPS:
        if any(isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
               for vals in ins.values() for v in vals):
            target = torch.bfloat16
        else:
            return ins
    else:
        return ins
    return {slot: [_cast_value(v, target) for v in vals]
            for slot, vals in ins.items()}


def cast(op_type: str, *tensors):
    """The inputs of one op as the policy casts them while it is
    :func:`active` (each argument a slot of its own), else unchanged:
    ``x, w = amp.cast("mul", x, w)``."""
    if not active():
        return tensors
    ins = apply_cast_policy(op_type, {i: [t] for i, t in enumerate(tensors)})
    return tuple(ins[i][0] for i in range(len(tensors)))


def cast_slots(op_type: str, **slots):
    """The named inputs of one op as the policy casts them while it is
    :func:`active`, else unchanged, in the order given: ``x, w, r =
    amp.cast_slots("conv2d_bn", Input=x, Filter=w, Residual=r)``.  The
    slot names are the reference's, so ``SLOT_WHITE_OPS`` applies."""
    if not active():
        return tuple(slots.values())
    ins = apply_cast_policy(op_type, {k: [v] for k, v in slots.items()})
    return tuple(ins[k][0] for k in slots)


class LossScaler:
    """Dynamic loss scaling (the reference's ``DynamicLossScale``): the
    grow/backoff policy over each step's overflow verdict.  bf16 needs
    none; fp16-style recipes and user-driven scaling do.  Host state
    only: the caller multiplies the loss by :attr:`scale`, un-scales the
    gradients and drops a step that overflowed; :attr:`overflow_steps`
    counts those."""

    def __init__(self, init_scale: float = 2.0 ** 15,
                 growth_factor: float = 2.0, backoff_factor: float = 0.5,
                 growth_interval: int = 2000,
                 min_scale: float = 1.0, max_scale: float = 2.0 ** 24):
        self.scale = float(init_scale)
        self.growth_factor = float(growth_factor)
        self.backoff_factor = float(backoff_factor)
        self.growth_interval = int(growth_interval)
        self.min_scale = float(min_scale)
        self.max_scale = float(max_scale)
        self.good_steps = 0
        self.overflow_steps = 0

    def update(self, found_overflow: bool) -> float:
        """Advance the policy one step; returns the new scale."""
        if found_overflow:
            self.overflow_steps += 1
            self.good_steps = 0
            self.scale = max(self.scale * self.backoff_factor,
                             self.min_scale)
        else:
            self.good_steps += 1
            if self.good_steps >= self.growth_interval:
                self.good_steps = 0
                self.scale = min(self.scale * self.growth_factor,
                                 self.max_scale)
        return self.scale


_loss_scaler = None


def set_loss_scaler(scaler) -> None:
    """Install (or clear, with None) the process's dynamic loss scaler."""
    global _loss_scaler
    _loss_scaler = scaler


def active_loss_scaler():
    return _loss_scaler
