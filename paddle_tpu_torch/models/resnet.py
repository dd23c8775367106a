"""ResNet for image classification training, as nn.Modules.

Counterpart of ``paddle_tpu/models/resnet.py`` (``resnet_imagenet`` and
``build_train_net``).  On the reference's NHWC training route, with
``FLAGS_fused_bn`` on (its default, the port's ``fused_bn=True``), every
``conv_bn_layer`` is one fused ``conv2d_bn`` (``ops/nn_ops.py``).  There a
1x1 convolution runs #19 (the product with its output's statistics in the
epilogue), every other convolution ``F.conv2d`` (cuDNN on the card, as
the reference leaves its convolutions to XLA) and then #18, and the batch
norm with its residual and ReLU runs #20 forward and #21 backward.
``data_format="NCHW"``, ``fused_bn=False`` and ``model.eval()`` (the
reference's ``is_test``) take the reference's unfused composition
instead, with no kernel: ``F.conv2d``, ``batch_norm_composed`` (batch
statistics in training, the running ones in eval), the residual add and
the ReLU.

The image enters as the reference feeds it, NCHW f32.  On the NHWC route
it is permuted to NHWC once, and every activation after that is a
contiguous NHWC tensor.  The
running mean and variance are buffers, moved in place by each training
forward with momentum 0.9.  Parameters keep the reference's layouts
(OIHW filters, the fc weight [in, out]), so
``interop.load_paddle_tpu_resnet_params`` carries a JAX scope across.

Under amp (``amp.enable(model)``, as ``bench_resnet50`` trains) the
forward runs the reference's cast policy op by op: the image is permuted
in f32 (``transpose`` is on no list), each ``conv2d_bn`` casts its input,
filter and residual to bf16 (a SLOT_WHITE op; the unfused route's
``conv2d`` is WHITE and its residual add GRAY_FOLLOW), so every activation
after the stem is bf16 and the kernels run in bf16 (#19 on tensor cores),
while the batch statistics, the running statistics and the folded
scale and shift stay f32.  The classifier is the reference's softmax
``fc``: ``mul`` (WHITE) and the bias add (GRAY_FOLLOW) in bf16, then the
softmax (BLACK) in f32, so ``predict``, the cross entropy, its mean and
the accuracy are f32.  The parameters stay f32 and their gradients reach
the optimizer in f32.

The card's f32 step needs TF32 off for cuDNN (``torch.backends.cudnn.
allow_tf32 = False``), which PyTorch leaves on by default; the port does
not change that global setting itself.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .. import amp
from ..device import resolve_device
from ..kernels.conv_bn import conv2d_nhwc
from ..ops.nn_ops import (accuracy, batch_norm_composed, conv2d_bn,
                          cross_entropy, elementwise_add, fc, pool2d)

#: depth -> (blocks per stage, block kind), ``resnet_imagenet``'s table
DEPTHS = {18: ([2, 2, 2, 1], "basic"), 34: ([3, 4, 6, 3], "basic"),
          50: ([3, 4, 6, 3], "bottleneck"),
          101: ([3, 4, 23, 3], "bottleneck"),
          152: ([3, 8, 36, 3], "bottleneck")}
MOMENTUM, EPSILON = 0.9, 1e-5


class ConvBN(nn.Module):
    """``conv_bn_layer``: a bias-free convolution, batch norm, and then an
    optional residual and ReLU, as one fused ``conv2d_bn`` in NHWC
    training under ``fused_bn``, else as the reference's separate ops.
    ``weight`` is the OIHW filter (``conv2d_<i>.w_0``), ``scale``/``bias``
    the batch norm's (``batch_norm_<i>.w_0``/``b_0``), ``mean``/``var``
    its running statistics (``.mean_0``/``.var_0``)."""

    def __init__(self, ch_in, ch_out, filter_size, stride, padding,
                 act="relu", device=None, data_format="NHWC",
                 fused_bn=True):
        super().__init__()
        self.stride, self.padding, self.act = stride, padding, act or ""
        self.data_format, self.fused_bn = data_format, fused_bn
        self.weight = nn.Parameter(torch.empty(
            ch_out, ch_in, filter_size, filter_size, device=device))
        self.scale = nn.Parameter(torch.empty(ch_out, device=device))
        self.bias = nn.Parameter(torch.empty(ch_out, device=device))
        self.register_buffer("mean", torch.zeros(ch_out, device=device))
        self.register_buffer("var", torch.ones(ch_out, device=device))

    def forward(self, x, residual=None):
        if self.data_format == "NHWC" and self.fused_bn:
            out, mean, var = conv2d_bn(
                x, self.weight, self.scale, self.bias, self.mean, self.var,
                residual=residual, strides=self.stride,
                paddings=self.padding, eps=EPSILON, momentum=MOMENTUM,
                act=self.act, use_global_stats=not self.training)
        else:
            out, mean, var = self._composed(x, residual)
        if self.training:
            with torch.no_grad():
                self.mean.copy_(mean)
                self.var.copy_(var)
        return out


    def _composed(self, x, residual):
        """The reference's ``conv2d``, ``batch_norm`` and
        ``elementwise_add(residual, bn, act)``: (out, mean_out,
        var_out)."""
        x, w = amp.cast("conv2d", x, self.weight)
        if self.data_format == "NCHW":
            y = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        else:
            y = conv2d_nhwc(x, w, self.stride, self.padding)
        out, mean, var = batch_norm_composed(
            y, self.scale, self.bias, self.mean, self.var, EPSILON, MOMENTUM,
            not self.training, self.data_format)
        if residual is not None:
            out = elementwise_add(residual, out)
        return (torch.relu(out) if self.act == "relu" else out), mean, var


def _shortcut(ch_in, ch_out, stride, **kw):
    """``shortcut``: a 1x1 ConvBN without ReLU where the widths differ,
    else None (the identity)."""
    if ch_in == ch_out:
        return None
    return ConvBN(ch_in, ch_out, 1, stride, 0, act=None, **kw)


class BasicBlock(nn.Module):
    """``basicblock``: two 3x3 ConvBNs; the second adds the shortcut
    before its ReLU.  Modules are made in the reference's draw order: the
    shortcut first."""

    expansion = 1

    def __init__(self, ch_in, ch_out, stride, **kw):
        super().__init__()
        self.shortcut = _shortcut(ch_in, ch_out, stride, **kw)
        self.conv1 = ConvBN(ch_in, ch_out, 3, stride, 1, **kw)
        self.conv2 = ConvBN(ch_out, ch_out, 3, 1, 1, **kw)

    def forward(self, x):
        short = x if self.shortcut is None else self.shortcut(x)
        return self.conv2(self.conv1(x), residual=short)


class Bottleneck(nn.Module):
    """``bottleneck``: 1x1 (stride here), 3x3, 1x1 to 4x the width, which
    adds the shortcut before its ReLU; the shortcut drawn first."""

    expansion = 4

    def __init__(self, ch_in, ch_out, stride, **kw):
        super().__init__()
        self.shortcut = _shortcut(ch_in, ch_out * 4, stride, **kw)
        self.conv1 = ConvBN(ch_in, ch_out, 1, stride, 0, **kw)
        self.conv2 = ConvBN(ch_out, ch_out, 3, 1, 1, **kw)
        self.conv3 = ConvBN(ch_out, ch_out * 4, 1, 1, 0, **kw)

    def forward(self, x):
        short = x if self.shortcut is None else self.shortcut(x)
        return self.conv3(self.conv2(self.conv1(x)), residual=short)


def layer_warp(block, ch_in, ch_out, count, stride, **kw):
    """``layer_warp``: ``count`` blocks, the first with ``stride``."""
    blocks = [block(ch_in, ch_out, stride, **kw)]
    blocks += [block(ch_out * block.expansion, ch_out, 1, **kw)
               for _ in range(count - 1)]
    return nn.Sequential(*blocks)


class ResNet(nn.Module):
    """``resnet_imagenet`` with ``build_train_net``'s loss and metric:
    the 7x7 stride-2 stem, 3x3 max pool, four stages of 64, 128, 256 and
    512 (times the block's expansion), global average pool and a softmax
    fc of ``class_dim``.  ``forward(image, label)`` takes the NCHW f32
    image and the int64 label [N, 1] and returns (avg_cost, acc,
    predict).  ``data_format`` is the layout of the activations ("NHWC",
    the default, or "NCHW"); ``fused_bn`` the reference's
    FLAGS_fused_bn, which arms the fused route in NHWC training.  Runs on
    CUDA unless ``device`` says otherwise; parameters are uninitialized
    until :meth:`init_params` or ``interop.load_paddle_tpu_resnet_params``.
    """

    def __init__(self, depth=50, class_dim=1000, data_format="NHWC",
                 device=None, fused_bn=True):
        super().__init__()
        if depth not in DEPTHS:
            raise ValueError(f"ResNet: depth {depth} not in "
                             f"{sorted(DEPTHS)}")
        if data_format not in ("NHWC", "NCHW"):
            raise ValueError(f"ResNet: data_format {data_format!r} is "
                             "neither NHWC nor NCHW")
        device = resolve_device(device)
        self.depth, self.class_dim = depth, class_dim
        self.data_format = data_format
        kw = dict(device=device, data_format=data_format,
                  fused_bn=bool(fused_bn))
        stages, kind = DEPTHS[depth]
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        self.conv1 = ConvBN(3, 64, 7, 2, 3, **kw)
        ch_in, stage_list = 64, []
        for i, (count, width) in enumerate(zip(stages, (64, 128, 256, 512))):
            stage_list.append(layer_warp(block, ch_in, width, count,
                                         1 if i == 0 else 2, **kw))
            ch_in = width * block.expansion
        self.stages = nn.ModuleList(stage_list)
        self.fc_w = nn.Parameter(torch.empty(ch_in, class_dim, device=device))
        self.fc_b = nn.Parameter(torch.empty(class_dim, device=device))

    def conv_bn_layers(self):
        """The ConvBN modules in the reference's draw order (its
        ``conv2d_<i>`` and ``batch_norm_<i>`` indices)."""
        return [m for m in self.modules() if isinstance(m, ConvBN)]

    @torch.no_grad()
    def init_params(self, seed=0):
        """Seeded random weights with the reference's initializers, drawn
        on the CPU from a torch.Generator so every device gets the same
        numbers: filters N(0, 2 / fan_in), batch-norm scale 1 and bias 0,
        running mean 0 and variance 1, the fc weight Xavier-uniform and
        its bias 0."""
        gen = torch.Generator().manual_seed(seed)
        for m in self.conv_bn_layers():
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                           * math.sqrt(2.0 / fan_in))
            m.scale.fill_(1.0)
            m.bias.zero_()
            m.mean.zero_()
            m.var.fill_(1.0)
        limit = math.sqrt(6.0 / sum(self.fc_w.shape))
        self.fc_w.copy_((torch.rand(self.fc_w.shape, generator=gen) * 2 - 1)
                        * limit)
        self.fc_b.zero_()
        return self

    def forward(self, image, label):
        """(avg_cost, acc, predict); under the reference's bf16 policy when
        the model is ``amp.enable``d."""
        with amp.policy_scope(self):
            fmt = self.data_format
            x = (image if fmt == "NCHW"
                 else image.permute(0, 2, 3, 1).contiguous())
            x = pool2d(self.conv1(x), "max", 3, 2, 1, data_format=fmt)
            for stage in self.stages:
                x = stage(x)
            x = pool2d(x, "avg", global_pooling=True, data_format=fmt)
            (logits,) = amp.cast("softmax", fc(x.reshape(x.shape[0], -1),
                                               self.fc_w, self.fc_b))
            # f32 from here on: the BLACK ops after the softmax see f32
            predict = torch.softmax(logits, dim=-1)
            avg_cost = cross_entropy(predict, label).mean()
            return avg_cost, accuracy(predict, label), predict
