"""Counterparts of ``paddle_tpu/ops/nn_ops.py`` ``layer_norm``,
``lookup_table``, ``softmax_with_cross_entropy``, ``dropout`` and
``dropout_add``, and of ``paddle_tpu/ops/math_ops.py`` ``mul``.  Each
differentiates through torch autograd as the reference's lowering does
through ``jax.vjp``."""

from __future__ import annotations

import torch

#: ``dropout`` (upscale_in_train, the only mode the models use: the
#: reference's ``keep_mask`` bits of the site's uint32 seed) and the fused
#: ``dropout_add`` (``lower_dropout_add``) are the kernels' own entry
#: points, #16 forward and #17 backward; rate 0 is the identity and a
#: plain add
from ..kernels.dropout_epilogue import dropout, dropout_add  # noqa: F401


def layer_norm(x, scale, bias, eps=1e-5):
    """Normalize over the last axis: statistics in f32 or wider
    (``layer_norm_core`` with ``begin_norm_axis`` = last), result in x's
    dtype."""
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xs.mean(dim=-1, keepdim=True)
    var = (xs - mean).square().mean(dim=-1, keepdim=True)
    y = (xs - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def lookup_table(table, ids):
    """Embedding rows of ``table`` [V, d] for integer ``ids`` of any shape;
    a trailing id axis of size 1 is dropped, as the reference does."""
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return table[ids.long()]


def mul(x, w):
    """The reference's reshape-matmul (``x_num_col_dims`` = all but the
    last axis): x [..., K] flattened to one [rows, K] product with
    w [K, N], leading axes restored."""
    return (x.reshape(-1, w.shape[0]) @ w).reshape(*x.shape[:-1], w.shape[1])


def softmax_with_cross_entropy(logits, label):
    """Hard-label cross entropy [N, 1] of logits [N, V] and integer label
    [N, 1] (``softmax_with_cross_entropy_op``): ``log sum exp(shifted) -
    shifted[label]`` with ``shifted = logits - max`` (the max a constant to
    autograd, as the reference stops its gradient), summed in f32 or
    wider."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    shifted = logits - logits.detach().amax(-1, keepdim=True)
    log_z = torch.log(torch.exp(shifted).sum(-1, keepdim=True))
    return log_z - torch.gather(shifted, -1, label.reshape(-1, 1).long())
