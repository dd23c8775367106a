"""Batch-norm statistics and epilogues of the fused conv + BN route:
kernels #18-#21, in f32 and in bf16 (amp).

Counterpart of ``paddle_tpu/kernels/conv_bn.py``.  Every activation is a
contiguous NHWC tensor, viewed as [rows, C] (channels fastest):

* :func:`channel_stats` (#18): f32 per-channel sum and sum of squares of
  y in one pass.  Its backward is gy = gs1 + 2 y gs2, in plain PyTorch,
  cast to y's dtype;
* :func:`dot_col_stats` (#19): a 1x1 convolution as y = x2 w2^T, with
  x2 [M, C_in] and w2 [C_out, C_in] (the OIHW filter's own 2-D view), and
  the f32 column sums of the stored y (rounded to y's dtype) in the
  product's epilogue.  Its backward folds the statistics' cotangents into
  gy_eff = gy + gs1 + 2 y gs2 (in f32, cast to x2's dtype) and takes
  dx = gy_eff w2 and dw = gy_eff^T x2 with ``torch.matmul``, as the
  reference leaves both to XLA;
* :func:`scale_shift_act` (#20 forward, #21 backward): out =
  [relu](x wv + bv [+ residual]) with per-channel f32 vectors rounded to
  x's dtype; its backward regenerates the ReLU mask from the saved output
  and gives dx and dresidual in x's dtype and, in the same pass, the f32
  dwv = sum g' x and dbv = sum g';
* :func:`bn_apply` folds scale, bias, mean and var into wv and bv
  (:func:`bn_fold`), in f32 and outside the autograd Function, so the gradients reach the batch
  statistics and through them #18's or #19's backward;
* :func:`conv_bn_stats`: a convolution and its output's statistics, #19
  for 1x1 convolutions (strided ones on a contiguous copy of the strided
  rows) and ``F.conv2d`` with #18 for the rest.

Each kernel's wrapper (``channel_stats_fwd``, ``dot_col_stats_fwd``,
``ssa_fwd``, ``ssa_bwd``) runs its plain twin (``reference_*``) for CPU
tensors; for CUDA tensors it launches ``csrc/conv_bn.cu`` or raises.  The
kernels take contiguous activations, all f32 or all bf16 (amp: counted
under the kernel's name + "_bf16"), with f32 per-channel vectors and
sums.  bf16 is the reference's arithmetic in x's dtype: wv and bv rounded
to bf16, each product and sum rounded to bf16, as the twins' bf16 ops
round (bit for bit).  #18, #20 and #21 take any channel count, moving a
16-byte vector of channels where C is a multiple of its lanes (4 f32, 8
bf16) and the tensors are 16-byte aligned and one channel at a time
otherwise (the reference launches its kernels at C = 1 and 2 and composes
at 3, 5, 6, ...; the port launches at every C, computing the same
function).  #19 in bf16 runs on tensor cores and takes K % 8 == 0, an
even N and 16-byte aligned operands; any other shape raises before a
launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import KERNEL_DTYPES, _build, launches


def _rows(x):
    return x.numel() // x.shape[-1]


def _wide(t):
    """t in f32 or wider: the statistics and the folded vectors accumulate
    in f32 (in float64 for a float64 copy of the model)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _on_card(what, acts, vectors=None):
    """None for CPU tensors (the plain twin runs); for CUDA ones the
    suffix of the kernel's element type ("" f32, "_bf16" bf16) when the
    activations (``{name: (tensor, shape)}``) are contiguous and all f32
    or all bf16 and the per-channel ``vectors`` contiguous f32 of their
    shapes; raises on anything else."""
    first = next(iter(acts.values()))[0]
    if first.device.type == "cpu":
        return None
    if first.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {first.device}")
    if first.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what}: no kernel for {first.dtype} activations "
                         "(f32 or bf16)")
    _build.require(
        {**{n: (t, first.dtype, s) for n, (t, s) in acts.items()},
         **{n: (t, torch.float32, s)
            for n, (t, s) in (vectors or {}).items()}}, first.device, what)
    return KERNEL_DTYPES[first.dtype]


def _launch(what, entry, *args, like):
    _build.check(entry(*args, _build.stream_of(like)), what)
    launches[what] += 1


# -- #18 ---------------------------------------------------------------------


def reference_channel_stats(y):
    """Plain twin of #18: (s1, s2) [C] in f32 or wider, the sum and the sum
    of squares of y [..., C] over every axis but the last."""
    ys = _wide(y).reshape(-1, y.shape[-1])
    return ys.sum(0), (ys * ys).sum(0)


def channel_stats_fwd(y):
    """#18: :func:`reference_channel_stats` (CPU: the twin; CUDA: the
    kernel, or an error)."""
    sfx = _on_card("channel_stats", {"y": (y, y.shape)})
    if sfx is None:
        return reference_channel_stats(y)
    c = y.shape[-1]
    s1, s2 = (torch.empty(c, device=y.device) for _ in range(2))
    lib = _build.lib()
    part = torch.empty(getattr(lib, "ptt_stats_partials" + sfx)(_rows(y), c),
                       device=y.device)
    _launch("channel_stats" + sfx, getattr(lib, "ptt_channel_stats" + sfx),
            y.data_ptr(), part.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            _rows(y), c, like=y)
    return s1, s2


class _ChannelStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return channel_stats_fwd(y)

    @staticmethod
    def backward(ctx, gs1, gs2):
        (y,) = ctx.saved_tensors
        return (gs1 + 2.0 * _wide(y) * gs2).to(y.dtype)


def channel_stats(y):
    """(s1, s2): f32 (or wider) [C] sum and sum of squares of y [..., C]
    over all but the channel axis, one pass over y (#18); differentiable
    in y."""
    return _ChannelStats.apply(y.contiguous())


# -- #19 ---------------------------------------------------------------------


def reference_dot_col_stats(x2, w2):
    """Plain twin of #19: (y, s1, s2) with y = x2 w2^T [M, N] in x2's
    dtype and the f32 column sums of that y."""
    y = x2 @ w2.t()
    return (y, *reference_channel_stats(y))


def dot_col_stats_fwd(x2, w2):
    """#19: :func:`reference_dot_col_stats` (CPU: the twin; CUDA: the
    kernel on the fixed-order tiles of ``csrc/gemm.cuh``, f32 or bf16 on
    tensor cores, or an error)."""
    m, k = x2.shape
    n = w2.shape[0]
    sfx = _on_card("dot_col_stats", {"x2": (x2, (m, k)),
                                     "w2": (w2, (n, k))})
    if sfx is None:
        return reference_dot_col_stats(x2, w2)
    if sfx and (k % 8 or n % 2 or x2.data_ptr() % 16 or w2.data_ptr() % 16):
        raise ValueError(
            f"dot_col_stats: the bf16 kernel takes K % 8 == 0, an even N and "
            f"16-byte aligned operands, got M {m}, K {k}, N {n}")
    y = torch.empty(m, n, device=x2.device, dtype=x2.dtype)
    s1, s2 = (torch.empty(n, device=x2.device) for _ in range(2))
    lib = _build.lib()
    part = torch.empty(lib.ptt_dot_stats_partials(m, n), device=x2.device)
    _launch("dot_col_stats" + sfx, getattr(lib, "ptt_dot_col_stats" + sfx),
            x2.data_ptr(), w2.data_ptr(), y.data_ptr(), part.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), m, n, k, like=x2)
    return y, s1, s2


class _DotColStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w2):
        y, s1, s2 = dot_col_stats_fwd(x2, w2)
        ctx.save_for_backward(x2, w2, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x2, w2, y = ctx.saved_tensors
        gy_eff = (_wide(gy) + gs1 + 2.0 * _wide(y) * gs2).to(x2.dtype)
        return gy_eff @ w2, gy_eff.t() @ x2


def dot_col_stats(x2, w2):
    """(y, s1, s2): y = x2 w2^T for x2 [M, C_in] and w2 [C_out, C_in] (in
    their dtype), and f32 [C_out] column sums of y from the product's
    epilogue (#19); differentiable in x2 and w2, the statistics
    included."""
    return _DotColStats.apply(x2.contiguous(), w2.contiguous())


# -- #20 and #21 -------------------------------------------------------------


def reference_ssa_fwd(x, wv, bv, residual=None, relu=False):
    """Plain twin of #20: [relu](x * wv + bv [+ residual]), per channel of
    x [..., C], in x's dtype (wv and bv rounded to it; each op rounds)."""
    out = x * wv.to(x.dtype) + bv.to(x.dtype)
    if residual is not None:
        out = out + residual
    return torch.clamp_min(out, 0.0) if relu else out


def reference_ssa_bwd(g, x, out, wv, has_residual, relu):
    """Plain twin of #21: (dx, dres or None, sg, sgx) with g' = g where
    out > 0 under ReLU (else g), dx = g' * wv in g's dtype (wv rounded to
    it), dres = g', and the per-channel sums of g' and g' * x in f32 or
    wider."""
    if relu:
        g = torch.where(out > 0, g, torch.zeros((), dtype=g.dtype,
                                                device=g.device))
    c = x.shape[-1]
    g2, x2 = _wide(g).reshape(-1, c), _wide(x).reshape(-1, c)
    return (g * wv.to(g.dtype), g if has_residual else None, g2.sum(0),
            (g2 * x2).sum(0))


def ssa_fwd(x, wv, bv, residual=None, relu=False):
    """#20: :func:`reference_ssa_fwd` (CPU: the twin; CUDA: the kernel, or
    an error)."""
    c = x.shape[-1]
    acts = {"x": (x, x.shape)}
    if residual is not None:
        acts["residual"] = (residual, x.shape)
    sfx = _on_card("ssa_fwd", acts, {"wv": (wv, (c,)), "bv": (bv, (c,))})
    if sfx is None:
        return reference_ssa_fwd(x, wv, bv, residual, relu)
    out = torch.empty_like(x)
    _launch("ssa_fwd" + sfx, getattr(_build.lib(), "ptt_ssa_fwd" + sfx),
            x.data_ptr(), wv.data_ptr(), bv.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), _rows(x), c, int(bool(relu)), like=x)
    return out


def ssa_bwd(g, x, out, wv, has_residual, relu):
    """#21: :func:`reference_ssa_bwd` (CPU: the twin; CUDA: the kernel, or
    an error).  ``out`` is read only under ``relu``."""
    c = x.shape[-1]
    acts = {"g": (g, x.shape), "x": (x, x.shape)}
    if relu:
        acts["out"] = (out, x.shape)
    sfx = _on_card("ssa_bwd", acts, {"wv": (wv, (c,))})
    if sfx is None:
        return reference_ssa_bwd(g, x, out, wv, has_residual, relu)
    dx = torch.empty_like(x)
    dres = torch.empty_like(x) if has_residual else None
    sg, sgx = (torch.empty(c, device=x.device) for _ in range(2))
    lib = _build.lib()
    part = torch.empty(getattr(lib, "ptt_stats_partials" + sfx)(_rows(x), c),
                       device=x.device)
    _launch("ssa_bwd" + sfx, getattr(lib, "ptt_ssa_bwd" + sfx),
            g.data_ptr(), x.data_ptr(), out.data_ptr() if relu else None,
            wv.data_ptr(), dx.data_ptr(),
            None if dres is None else dres.data_ptr(), part.data_ptr(),
            sg.data_ptr(), sgx.data_ptr(), _rows(x), c, int(bool(relu)),
            like=x)
    return dx, dres, sg, sgx


class _ScaleShiftAct(torch.autograd.Function):
    """out = [relu](x wv + bv); saves x, wv and, under ReLU, out."""

    @staticmethod
    def forward(ctx, x, wv, bv, relu):
        out = ssa_fwd(x, wv, bv, None, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, wv, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wv, out = ctx.saved_tensors
        dx, _, sg, sgx = ssa_bwd(g.contiguous(), x, out, wv, False, ctx.relu)
        return dx, sgx, sg, None


class _ScaleShiftActResidual(torch.autograd.Function):
    """out = [relu](x wv + bv + residual); as :class:`_ScaleShiftAct`,
    with the residual's gradient g' from the same pass."""

    @staticmethod
    def forward(ctx, x, wv, bv, residual, relu):
        out = ssa_fwd(x, wv, bv, residual, relu)
        ctx.relu = relu
        ctx.save_for_backward(x, wv, out if relu else None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, wv, out = ctx.saved_tensors
        dx, dres, sg, sgx = ssa_bwd(g.contiguous(), x, out, wv, True,
                                    ctx.relu)
        return dx, sgx, sg, dres, None


def scale_shift_act(x, wv, bv, residual=None, relu=False):
    """[relu](x * wv + bv [+ residual]) for x [..., C] and f32 wv, bv [C]:
    #20 forward, #21 backward.  Differentiable in x, wv, bv and the
    residual; stores x, wv and (for the ReLU mask) the output, no
    normalized intermediate."""
    x, wv, bv = x.contiguous(), wv.contiguous(), bv.contiguous()
    if residual is None:
        return _ScaleShiftAct.apply(x, wv, bv, bool(relu))
    if tuple(residual.shape) != tuple(x.shape):
        raise ValueError(f"scale_shift_act: residual {tuple(residual.shape)}"
                         f" vs x {tuple(x.shape)} must match")
    return _ScaleShiftActResidual.apply(x, wv, bv, residual.contiguous(),
                                        bool(relu))


def bn_fold(scale, bias, mean, var, eps=1e-5):
    """(wv, bv): batch norm by (mean, var) then scale and bias as one
    per-channel scale and shift, wv = scale / sqrt(var + eps) and bv =
    bias - mean * wv, formed in f32 (or wider)."""
    wv = _wide(scale) * torch.rsqrt(_wide(var) + eps)
    return wv, _wide(bias) - _wide(mean) * wv


def bn_apply(x, scale, bias, mean, var, residual=None, eps=1e-5, act=""):
    """Batch norm of x [..., C] by (mean, var), then scale and bias, the
    optional residual and ReLU (``act`` "" or "relu"), in one pass (#20).
    The [C] vectors fold (``bn_fold``) outside the Function, so gradients
    reach scale, bias, mean and var through autograd."""
    if act not in ("", "relu", None):
        raise ValueError(f"bn_apply: unsupported act {act!r} (fusable "
                         "epilogues: '', 'relu')")
    wv, bv = bn_fold(scale, bias, mean, var, eps)
    return scale_shift_act(x, wv, bv, residual=residual,
                           relu=act == "relu")


# -- the convolution and its statistics -------------------------------------


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def conv2d_nhwc(x, w, strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
                groups=1):
    """The NHWC convolution of x [N, H, W, C_in] with the OIHW filter w:
    ``F.conv2d`` on the channels-last view of x, returned as
    [N, OH, OW, C_out] (contiguous when the library keeps the
    channels-last layout, as cuDNN does)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=_pair(strides),
                 padding=_pair(paddings), dilation=_pair(dilations),
                 groups=groups or 1)
    return y.permute(0, 2, 3, 1)


def conv_bn_stats(x, w, strides=(1, 1), paddings=(0, 0), dilations=(1, 1),
                  groups=1):
    """(y, s1, s2): the NHWC convolution of x with the OIHW filter w and
    the f32 per-channel sum and sum of squares of y.  An unpadded,
    undilated, ungrouped 1x1 convolution is #19 over [N*H*W, C_in] (a
    strided one first copies the rows x[:, ::s, ::s, :] it reads); every
    other one is ``F.conv2d`` followed by #18."""
    oc, icg, kh, kw = w.shape
    strides, paddings = _pair(strides), _pair(paddings)
    dilations = _pair(dilations)
    if ((kh, kw) == (1, 1) and paddings == (0, 0) and dilations == (1, 1)
            and (groups or 1) == 1):
        if strides != (1, 1):
            x = x[:, ::strides[0], ::strides[1], :]
        n, h, wd, ic = x.shape
        y2, s1, s2 = dot_col_stats(x.reshape(n * h * wd, ic),
                                   w.reshape(oc, icg))
        return y2.reshape(n, h, wd, oc), s1, s2
    y = conv2d_nhwc(x, w, strides, paddings, dilations, groups)
    s1, s2 = channel_stats(y)
    return y, s1, s2
