"""Counterparts of ``paddle_tpu/ops/nn_ops.py`` ``layer_norm`` and
``lookup_table``, and of ``paddle_tpu/ops/math_ops.py`` ``mul``."""

from __future__ import annotations

import torch


def layer_norm(x, scale, bias, eps=1e-5):
    """Normalize over the last axis: statistics in f32 (``layer_norm_core``
    with ``begin_norm_axis`` = last), result in x's dtype."""
    xs = x.float()
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
