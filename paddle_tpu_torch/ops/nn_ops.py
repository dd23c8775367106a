"""Counterparts of ``paddle_tpu/ops/nn_ops.py`` ``layer_norm``,
``lookup_table``, ``softmax_with_cross_entropy``, ``dropout``,
``dropout_add``, ``conv2d_bn``, ``batch_norm``, ``pool2d`` and
``cross_entropy``, of ``paddle_tpu/ops/math_ops.py`` ``mul`` and of
``paddle_tpu/ops/metric_ops.py`` ``accuracy``.  Each differentiates
through torch autograd as the reference's lowering does through
``jax.vjp``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.conv_bn import (bn_apply, bn_fold, channel_stats,
                               conv2d_nhwc, conv_bn_stats,
                               reference_ssa_fwd)

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


def _batch_stats(y, s1, s2, mean_in, var_in, momentum):
    """(mean, var, mean_out, var_out) from the f32 sums of y [..., C]:
    var = s2 / n - mean^2 (neither clamped nor Welford's, as the
    reference forms it), differentiable into s1 and s2; the running
    statistics move by ``momentum`` toward the batch's, which they see as
    constants."""
    n = y.numel() // y.shape[-1]
    mean = s1 / n
    var = s2 / n - mean.square()
    m, v = mean.detach(), var.detach()
    return (mean, var, mean_in * momentum + m * (1 - momentum),
            var_in * momentum + v * (1 - momentum))


def _global_stats_apply(y, scale, bias, mean, var, residual, eps, act):
    """The reference's composition with given statistics, in plain
    PyTorch: y * wv + bv [+ residual] [relu] with (wv, bv) of
    ``bn_fold``."""
    wv, bv = bn_fold(scale, bias, mean, var, eps)
    return reference_ssa_fwd(y, wv.to(y.dtype), bv.to(y.dtype), residual,
                             act == "relu")


def conv2d_bn(x, w, scale, bias, mean, var, residual=None, strides=(1, 1),
              paddings=(0, 0), dilations=(1, 1), groups=1, eps=1e-5,
              momentum=0.9, act="", use_global_stats=False):
    """The fused conv2d (no bias) + batch_norm [+ residual] [+ ReLU] of
    NHWC x [N, H, W, C_in] with the OIHW filter w: (out, mean_out,
    var_out), the new running statistics beside the output.

    Training (``use_global_stats`` False) takes the fused route:
    ``conv_bn_stats`` (#19 for 1x1 convolutions, ``F.conv2d`` and #18
    otherwise), the batch statistics, and ``bn_apply`` (#20, #21).  With
    ``use_global_stats`` (the reference's ``is_test``) it is the
    reference's composition over (mean, var), ``F.conv2d`` and plain
    PyTorch, and the running statistics stay."""
    if act not in ("", "relu", None):
        raise ValueError(f"conv2d_bn: unsupported act {act!r}")
    act = act or ""
    if use_global_stats:
        y = conv2d_nhwc(x, w, strides, paddings, dilations, groups)
        return (_global_stats_apply(y, scale, bias, mean, var, residual,
                                    eps, act), mean, var)
    y, s1, s2 = conv_bn_stats(x, w, strides, paddings, dilations, groups)
    bmean, bvar, mean_out, var_out = _batch_stats(y, s1, s2, mean, var,
                                                  momentum)
    out = bn_apply(y, scale, bias, bmean, bvar, residual=residual, eps=eps,
                   act=act)
    return out, mean_out, var_out


def batch_norm(x, scale, bias, mean, var, eps=1e-5, momentum=0.9,
               use_global_stats=False):
    """Batch norm of NHWC x over every axis but the channel: (y,
    mean_out, var_out).  Training is the reference's fused NHWC route,
    #18 for the statistics and #20 / #21 for the normalization; with
    ``use_global_stats`` the composition over (mean, var)."""
    if use_global_stats:
        return (_global_stats_apply(x, scale, bias, mean, var, None, eps,
                                    ""), mean, var)
    s1, s2 = channel_stats(x)
    bmean, bvar, mean_out, var_out = _batch_stats(x, s1, s2, mean, var,
                                                  momentum)
    return bn_apply(x, scale, bias, bmean, bvar, eps=eps), mean_out, var_out


def pool2d(x, pool_type="max", pool_size=2, pool_stride=1, pool_padding=0,
           global_pooling=False):
    """NHWC pooling as ResNet runs it: the global average (the mean over H
    and W, kept as 1 x 1), or a max window whose padding counts as
    -inf."""
    if global_pooling and pool_type == "avg":
        return x.mean(dim=(1, 2), keepdim=True)
    if global_pooling or pool_type != "max":
        raise NotImplementedError(
            f"pool2d: {'global ' if global_pooling else ''}{pool_type!r} "
            "pooling is not ported; the global average and max windows are")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), pool_size, pool_stride,
                     pool_padding)
    return y.permute(0, 2, 3, 1)


def cross_entropy(prob, label):
    """Hard-label cross entropy [N, 1] of probabilities prob [N, K] and
    integer label [N, 1]: -log(max(p[label], 1e-12)), the clip giving no
    gradient where it binds."""
    logp = torch.log(torch.clamp_min(prob, 1e-12))
    return -torch.gather(logp, -1, label.reshape(-1, 1).long())


def accuracy(prob, label):
    """Top-1 accuracy [1] f32 of prob [N, K] against label [N, 1]: the
    share of rows whose first maximum sits at the label."""
    hit = prob.argmax(dim=-1) == label.reshape(-1)
    return hit.float().mean().reshape(1)
