"""Counterparts of ``paddle_tpu/ops/nn_ops.py`` ``layer_norm``,
``lookup_table``, ``fused_lookup_table``, ``softmax_with_cross_entropy``,
``dropout``, ``dropout_add``, ``conv2d_bn``, ``batch_norm``, ``pool2d``
and ``cross_entropy``, of ``paddle_tpu/ops/math_ops.py`` ``mul`` and
``gelu`` (with the ``fc`` layer around them and BERT's masked-LM loss) and
of ``paddle_tpu/ops/metric_ops.py`` ``accuracy``.  Each differentiates
through torch autograd as the reference's lowering does through
``jax.vjp``.  While an amp-enabled model runs (``paddle_tpu_torch.amp``),
``mul``, ``elementwise_add``, ``dropout_add`` and ``conv2d_bn`` (its
``Input``, ``Filter`` and ``Residual`` slots) cast their inputs by the
reference's policy; the other ops take their inputs' dtypes."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import amp
from ..kernels import dropout_epilogue
from ..kernels.conv_bn import (_wide, bn_apply, bn_fold, channel_stats,
                               conv2d_nhwc, conv_bn_stats,
                               reference_ssa_fwd)

#: ``dropout`` (upscale_in_train, the only mode the models use: the
#: reference's ``keep_mask`` bits of the site's uint32 seed) is the
#: kernel's own entry point, #16 forward and #17 backward; rate 0 is the
#: identity
from ..kernels.dropout_epilogue import dropout  # noqa: F401
from ..kernels.embedding import multi_table_gather, multi_table_scatter_add
from ..selected_rows import SelectedRows


def dropout_add(x, residual, rate, seed):
    """The fused ``dropout(x) + residual`` (``lower_dropout_add``) through
    #16 and #17; rate 0 is a plain add.  Under amp a GRAY_FOLLOW op: with
    either input in bf16 both are cast to bf16."""
    x, residual = amp.cast("dropout_add", x, residual)
    return dropout_epilogue.dropout_add(x, residual, rate, seed)


def elementwise_add(x, y):
    """``x + y`` (``elementwise_add``, a bias broadcast along the last
    axis); under amp a GRAY_FOLLOW op, so an f32 bias added to a bf16
    activation is cast down rather than promoting it."""
    x, y = amp.cast("elementwise_add", x, y)
    return x + y


def layer_norm(x, scale, bias, eps=1e-5):
    """Normalize over the last axis: statistics in f32 or wider
    (``layer_norm_core`` with ``begin_norm_axis`` = last), result in x's
    dtype."""
    xs = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xs.mean(dim=-1, keepdim=True)
    var = (xs - mean).square().mean(dim=-1, keepdim=True)
    y = (xs - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _padding(padding_idx):
    """The reference's ``padding_idx`` attribute: None or < 0 is none."""
    return None if padding_idx is None or padding_idx < 0 else padding_idx


def _unpadded(ids, padding_idx, dtype):
    """1 where ids differ from padding_idx, 0 where they match, [..., 1]."""
    return (ids != padding_idx).to(dtype)[..., None]


class _SparseLookup(torch.autograd.Function):
    """out = table[ids] whose gradient is the reference's row-sparse one:
    the cotangent rows at the ids (zero at padding_idx), as an uncoalesced
    sparse COO tensor."""

    @staticmethod
    def forward(ctx, table, ids, padding_idx):
        out = table[ids.long()]
        if padding_idx is not None:
            out = out * _unpadded(ids, padding_idx, out.dtype)
        ctx.save_for_backward(ids)
        ctx.padding_idx, ctx.height = padding_idx, table.shape[0]
        return out

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if ctx.padding_idx is not None:
            g = g * _unpadded(ids, ctx.padding_idx, g.dtype)
        rows = g.reshape(-1, g.shape[-1])
        return (SelectedRows(ids.reshape(-1), rows, ctx.height).to_sparse(),
                None, None)


def lookup_table(table, ids, padding_idx=None, is_sparse=False):
    """Embedding rows of ``table`` [V, d] for integer ``ids`` of any shape;
    a trailing id axis of size 1 is dropped, as the reference does, and
    rows at ``padding_idx`` are zero.  With ``is_sparse`` the table's
    gradient is row-sparse (``lookup_table_grad``'s SelectedRows, here an
    uncoalesced sparse COO tensor); otherwise dense."""
    if ids.dim() and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    padding_idx = _padding(padding_idx)
    if is_sparse:
        return _SparseLookup.apply(table, ids, padding_idx)
    out = table[ids.long()]
    if padding_idx is not None:
        out = out * _unpadded(ids, padding_idx, out.dtype)
    return out


def stacked_slot_ids(ids):
    """[S, B] int32 of the S slots' ids: a sequence of id tensors (each [B]
    or [B, 1]) stacked and cast once, or an [S, B] tensor cast."""
    if isinstance(ids, torch.Tensor):
        return ids.reshape(ids.shape[0], -1).to(torch.int32)
    return torch.stack([i.reshape(-1) for i in ids]).to(torch.int32)


class _FusedLookup(torch.autograd.Function):
    """out [S, B, D] = the group's rows at ids [S, B] through #22; each
    table's gradient is its slot's cotangent rows as an uncoalesced sparse
    COO tensor (``is_sparse``), or dense through #23's scatter-add."""

    @staticmethod
    def forward(ctx, ids, padding_idx, is_sparse, *tables):
        out = multi_table_gather(tables, ids)
        if padding_idx is not None:
            out = out * _unpadded(ids, padding_idx, out.dtype)
        ctx.save_for_backward(ids)
        ctx.padding_idx, ctx.is_sparse = padding_idx, is_sparse
        ctx.table_shape = tables[0].shape
        return out

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if ctx.padding_idx is not None:
            g = g * _unpadded(ids, ctx.padding_idx, g.dtype)
        v = ctx.table_shape[0]
        if ctx.is_sparse:
            grads = [SelectedRows(ids[s], g[s], v).to_sparse()
                     for s in range(ids.shape[0])]
        else:
            grads = multi_table_scatter_add(
                [torch.zeros(ctx.table_shape, dtype=g.dtype, device=g.device)
                 for _ in range(ids.shape[0])], ids, g.contiguous(), 1.0)
        return (None, None, None, *grads)


def fused_lookup_table(tables, ids, padding_idx=None, is_sparse=True):
    """The reference's ``fused_lookup_table``: the rows of S same-shape
    [V, D] tables at the S slots' ids (a sequence of [B] or [B, 1] id
    tensors, or one [S, B] tensor), gathered by one #22 launch into
    out [S, B, D]; rows at ``padding_idx`` are zero.  Each table's
    gradient is ``fused_lookup_table_grad``'s: row-sparse with
    ``is_sparse`` (the cotangent slices, no kernel), else dense through
    one #23 scatter-add launch for the group."""
    return _FusedLookup.apply(stacked_slot_ids(ids), _padding(padding_idx),
                              bool(is_sparse), *tables)


def mul(x, w):
    """The reference's reshape-matmul (``x_num_col_dims`` = all but the
    last axis): x [..., K] flattened to one [rows, K] product with
    w [K, N], leading axes restored.  Under amp both operands are cast to
    bf16 (a WHITE op)."""
    x, w = amp.cast("mul", x, w)
    return (x.reshape(-1, w.shape[0]) @ w).reshape(*x.shape[:-1], w.shape[1])


#: sqrt(1/2) rounded to bf16, as the reference's bf16 gelu takes it
_SQRT_HALF_BF16 = 0.70703125


class _GeluBf16(torch.autograd.Function):
    """gelu of a bf16 x in the reference's bf16 arithmetic (see
    :func:`gelu`).  Its backward is gelu's derivative at x computed in f32
    and rounded once (``F.gelu``'s backward, one kernel): the reference
    differentiates its bf16 steps, which round at other points, so the
    two agree to bf16 roundings.  Only x is saved."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        # 0.5 x is exact in bf16, and so is the f32 product of two bf16
        # values, so the bf16 product rounds the reference's f32 product
        # once, as it does
        return (0.5 * x) * torch.special.erfc(
            x.float().mul_(-_SQRT_HALF_BF16)).bfloat16()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.ops.aten.gelu_backward(g, x, approximate="none")


def gelu(x):
    """The reference's ``gelu`` with ``approximate=False``: the exact erf
    form x * (1 + erf(x / sqrt(2))) / 2.

    In bf16 (amp) it follows the reference's arithmetic rather than
    ``F.gelu``'s, which computes in f32 and rounds once: the reference
    (``jax.nn.gelu`` on bf16, as XLA compiles it) takes 0.5 * x in bf16
    (exact), -x * sqrt(1/2) in f32 with sqrt(1/2) rounded to bf16, erfc
    in f32 rounded to bf16, and their product rounded to bf16.  On the
    CPU this gives the reference's bits for every bf16 input whose
    result XLA does not flush to zero as a subnormal; ``F.gelu`` differs
    on about a quarter of normally distributed inputs."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="none")
    return _GeluBf16.apply(x)


#: fc activations the models use
_ACTS = {None: None, "": None, "relu": torch.relu, "gelu": gelu}


def fc(x, w, b=None, act=None):
    """The reference's ``fc`` over the last axis: ``mul`` by w [K, N], the
    bias [N] added (``elementwise_add``), then the activation op (None,
    "relu" or "gelu")."""
    if act not in _ACTS:
        raise ValueError(f"fc: unsupported act {act!r}")
    out = mul(x, w)
    if b is not None:
        out = elementwise_add(out, b)
    return _ACTS[act](out) if _ACTS[act] else out


def softmax_with_cross_entropy(logits, label):
    """Hard-label cross entropy [N, 1] of logits [N, V] and integer label
    [N, 1] (``softmax_with_cross_entropy_op``): ``log sum exp(shifted) -
    shifted[label]`` with ``shifted = logits - max`` (the max a constant to
    autograd, as the reference stops its gradient), summed in f32 or
    wider.  bf16 logits (amp) are shifted in bf16 and cast to f32 before
    the exp, as the reference's lowering does, so no f32 copy of the
    logits is kept for the backward; the loss is f32."""
    shifted = logits - logits.detach().amax(-1, keepdim=True)
    wide = shifted.to(torch.promote_types(shifted.dtype, torch.float32))
    log_z = torch.log(torch.exp(wide).sum(-1, keepdim=True))
    return log_z - torch.gather(shifted, -1, label.reshape(-1, 1).long()).to(
        wide.dtype)


def masked_lm_loss(logits, label, weight):
    """BERT's masked-LM objective (``build_pretrain_net``): the per-token
    ``softmax_with_cross_entropy`` of logits [N, vocab] and label [N, 1],
    weighted by weight [N, 1] and summed (``reduce_sum``), over the
    weights' sum; a 0-dim tensor."""
    loss = softmax_with_cross_entropy(logits, label)
    w = weight.reshape(-1, 1).to(loss.dtype)
    return (loss * w).sum() / w.sum()


def _batch_stats(n, s1, s2, mean_in, var_in, momentum):
    """(mean, var, mean_out, var_out) from the f32 sums s1, s2 of n values
    per channel: var = s2 / n - mean^2 (neither clamped nor Welford's, as
    the reference forms it), differentiable into s1 and s2; the running
    statistics move by ``momentum`` toward the batch's, which they see as
    constants."""
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
    PyTorch, and the running statistics stay.

    Under amp (a SLOT_WHITE op) x, w and the residual are cast to bf16,
    so the convolution, y and the output are bf16 and the kernels run
    their bf16 instantiations; scale, bias, the running statistics, the
    batch statistics (f32 sums) and the folded wv, bv stay f32.  Without
    amp every tensor keeps its dtype (f32, or float64 on the CPU)."""
    if act not in ("", "relu", None):
        raise ValueError(f"conv2d_bn: unsupported act {act!r}")
    act = act or ""
    x, w, residual = amp.cast_slots("conv2d_bn", Input=x, Filter=w,
                                    Residual=residual)
    if use_global_stats:
        y = conv2d_nhwc(x, w, strides, paddings, dilations, groups)
        return (_global_stats_apply(y, scale, bias, mean, var, residual,
                                    eps, act), mean, var)
    y, s1, s2 = conv_bn_stats(x, w, strides, paddings, dilations, groups)
    bmean, bvar, mean_out, var_out = _batch_stats(
        y.numel() // y.shape[-1], s1, s2, mean, var, momentum)
    out = bn_apply(y, scale, bias, bmean, bvar, residual=residual, eps=eps,
                   act=act)
    return out, mean_out, var_out


def batch_norm(x, scale, bias, mean, var, eps=1e-5, momentum=0.9,
               use_global_stats=False):
    """Batch norm of NHWC x over every axis but the channel: (y,
    mean_out, var_out).  Training is the reference's fused NHWC route,
    #18 for the statistics and #20 / #21 for the normalization; with
    ``use_global_stats`` the composition over (mean, var).  The unfused
    training route (NCHW, FLAGS_fused_bn off) is
    :func:`batch_norm_composed`."""
    if use_global_stats:
        return (_global_stats_apply(x, scale, bias, mean, var, None, eps,
                                    ""), mean, var)
    s1, s2 = channel_stats(x)
    bmean, bvar, mean_out, var_out = _batch_stats(
        x.numel() // x.shape[-1], s1, s2, mean, var, momentum)
    return bn_apply(x, scale, bias, bmean, bvar, eps=eps), mean_out, var_out


def batch_norm_composed(x, scale, bias, mean, var, eps=1e-5, momentum=0.9,
                        use_global_stats=False, data_layout="NHWC"):
    """The reference's unfused ``batch_norm`` lowering in plain PyTorch:
    in training the batch mean and mean(x^2) - mean^2 in f32 (or wider),
    the running statistics moved by ``momentum``; with
    ``use_global_stats`` the running ones, unmoved.  Then w = scale /
    sqrt(var + eps) and b = bias - mean w (``bn_fold``) and y = x w + b.
    Returns (y, mean_out, var_out)."""
    c_axis = 1 if data_layout == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[c_axis] = x.shape[c_axis]
    if use_global_stats:
        bmean, bvar, mean_out, var_out = mean, var, mean, var
    else:
        xs = _wide(x)
        axes = [i for i in range(x.dim()) if i != c_axis]
        bmean, bvar, mean_out, var_out = _batch_stats(
            x.numel() // x.shape[c_axis], xs.sum(axes),
            (xs * xs).sum(axes), mean, var, momentum)
    wv, bv = bn_fold(scale, bias, bmean, bvar, eps)
    y = x * wv.to(x.dtype).reshape(shape) + bv.to(x.dtype).reshape(shape)
    return y, mean_out, var_out


def pool2d(x, pool_type="max", pool_size=2, pool_stride=1, pool_padding=0,
           global_pooling=False, data_format="NHWC"):
    """Pooling as ResNet runs it, over NHWC x (or NCHW with
    ``data_format``): the global average (the mean over H and W, kept as
    1 x 1), or a max window whose padding counts as -inf.  The average of
    a bf16 x (amp) is ``jnp.mean``'s: an f32 sum divided by the count and
    rounded once to bf16 (``x.mean`` on CUDA multiplies the f32 sum by 1 /
    count rounded to f32, one more rounding)."""
    nchw = data_format == "NCHW"
    if global_pooling and pool_type == "avg":
        dims = (2, 3) if nchw else (1, 2)
        if x.dtype in (torch.float32, torch.float64):
            return x.mean(dim=dims, keepdim=True)
        count = x.shape[dims[0]] * x.shape[dims[1]]
        return (x.sum(dim=dims, keepdim=True, dtype=torch.float32)
                / count).to(x.dtype)
    if global_pooling or pool_type != "max":
        raise NotImplementedError(
            f"pool2d: {'global ' if global_pooling else ''}{pool_type!r} "
            "pooling is not ported; the global average and max windows are")
    if nchw:
        return F.max_pool2d(x, pool_size, pool_stride, pool_padding)
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
