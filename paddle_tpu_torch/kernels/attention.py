"""Flash attention: the fused-projection kernels and the bthd kernels.

Counterparts of ``paddle_tpu/kernels/attention.py``:

* :func:`flash_qkv_attention`: the q/k/v projections, the online-softmax
  attention and the output projection fused, differentiable through a
  ``torch.autograd.Function`` whose passes are the kernels of
  ``csrc/qkv_attention.cu`` and ``csrc/qkv_attention_bwd.cu``:
  :func:`qkv_attention_fwd` (``_qkv_fwd_kernel``, #1: y and the residuals
  ctx, lse), :func:`qkv_bwd_dq` (``_qkv_bwd_dq_kernel``, #2: dx_q, dW_q,
  dW_out) and :func:`qkv_bwd_dkv` (``_qkv_bwd_dkv_kernel``, #3: dx_kv,
  dW_k, dW_v).  Their plain versions are :func:`reference_qkv_fwd`,
  :func:`reference_qkv_bwd_dq` and :func:`reference_qkv_bwd_dkv`; under
  ``torch.no_grad()`` (serving) #1 runs without residuals.
* :func:`flash_attention` with ``fmt="bthd"``: q, k, v [b, t, h, d] with
  an additive bias, differentiable through a ``torch.autograd.Function``
  whose passes are three kernels of ``csrc/flash_attention.cu``:
  :func:`flash_fwd` (``_fwd_kernel_bthd``, #4), :func:`flash_bwd_dq`
  (``_bwd_dq_kernel_bthd``, #6) and :func:`flash_bwd_dkv`
  (``_bwd_dkv_kernel_bthd``, #7).  Their plain versions are
  :func:`reference_flash_fwd`, :func:`reference_flash_bwd_dq` and
  :func:`reference_flash_bwd_dkv`.

Dropout inside the attention kernels belongs to a later slice.
"""

from __future__ import annotations

import torch

from . import _build, launches

#: score given to causally hidden keys (the reference kernel's value)
MASK_VALUE = -1e30
#: head width the CUDA kernel is compiled for
KERNEL_D_HEAD = 64


def _bias_4d(bias, b, n_head, tq, tk, what):
    """The bias with leading 1s up to 4 dims (a view); raises unless it
    broadcasts to [b, h, tq, tk]."""
    while bias.dim() < 4:
        bias = bias.unsqueeze(0)
    bb, hb, tqb, tkb = bias.shape
    if (bb not in (1, b) or hb not in (1, n_head) or tqb not in (1, tq)
            or tkb not in (1, tk)):
        raise ValueError(
            f"{what}: bias {tuple(bias.shape)} does not broadcast to "
            f"[{b}, {n_head}, {tq}, {tk}]")
    return bias


def _bias_view(bias, b, n_head, tq, tk, what):
    """Broadcast an additive bias to a [b, h, tq, tk] view (no copy), so a
    kernel reads it through strides that are 0 on the broadcast dims."""
    return _bias_4d(bias, b, n_head, tq, tk, what).expand(b, n_head, tq, tk)


def _bias_strides(bias, device, what):
    """(the bias's four strides, its data pointer) for a kernel; zeros and
    None without a bias."""
    if bias is None:
        return (0, 0, 0, 0), None
    if bias.device != device or bias.dtype != torch.float32:
        raise ValueError(f"{what}: bias must be f32 on {device}, got "
                         f"{bias.dtype} on {bias.device}")
    return bias.stride(), bias.data_ptr()


# ---------------------------------------------------------------------------
# flash_qkv_attention: kernels #1, #2, #3
# ---------------------------------------------------------------------------


def _project(x, w_qkv, n_head):
    """q, k, v [b, t, h, dh] of x [b, t, dm] by the packed w_qkv."""
    b, t, _ = x.shape
    hd = w_qkv.shape[1] // 3
    return (a.reshape(b, t, n_head, hd // n_head)
            for a in torch.split(x @ w_qkv, hd, dim=-1))


def reference_qkv_fwd(x, w_qkv, w_out, bias=None, n_head=1, scale=1.0,
                      causal=False):
    """Plain twin of #1 with its residuals: (y [b, t, dm], ctx [b, t, h,
    dh], lse [b, h, t]) where ctx is each head's normalized context,
    ``softmax((x Wq)(x Wk)^T * scale + bias) (x Wv)``, and y = ctx @ w_out
    over the merged heads.  A row whose scores are all masked (max <=
    -1e29) gets a zero context and lse = +inf, as in the kernel."""
    b, t, _ = x.shape
    q, k, v = _project(x, w_qkv, n_head)
    ctx, lse = reference_flash_fwd(q, k, v, bias, scale, causal)
    return (ctx.reshape(b, t, -1) @ w_out).to(x.dtype), ctx, lse


def reference_qkv_attention(x, w_qkv, w_out, bias=None, n_head=1,
                            scale=1.0, causal=False):
    """y of :func:`reference_qkv_fwd`: the math of the reference's
    ``_composed_qkv``."""
    return reference_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale,
                             causal)[0]


def _qkv_recompute(x, w_qkv, w_out, g, ctx, n_head):
    """What both backward kernels rebuild from their inputs: q, k, v,
    dctx = g w_out^T (each [b, t, h, dh]) and delta = rowsum(dctx * ctx)
    [b, h, t]."""
    q, k, v = _project(x, w_qkv, n_head)
    dctx = (g @ w_out.transpose(0, 1)).reshape(ctx.shape)
    delta = (dctx * ctx).sum(-1).transpose(1, 2)
    return q, k, v, dctx, delta


def _rows(a):
    """[b, t, h, dh] -> [b*t, h*dh]."""
    return a.reshape(a.shape[0] * a.shape[1], -1)


def reference_qkv_bwd_dq(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1,
                         scale=1.0, causal=False):
    """Plain twin of #2: (dx_q [b, t, dm], dW_q [dm, hd], dW_out [hd, dm])
    from g = dL/dy and #1's residuals: dq = ds k as the bthd twin of #6
    computes it over the recomputed q, k, v and dctx, then dx_q = dq
    Wq^T, dW_q = x^T dq and dW_out = ctx^T g."""
    hd = w_qkv.shape[1] // 3
    q, k, v, dctx, delta = _qkv_recompute(x, w_qkv, w_out, g, ctx, n_head)
    dq = _rows(reference_flash_bwd_dq(q, k, v, bias, dctx, lse, delta,
                                      scale, causal))
    dx = (dq @ w_qkv[:, :hd].transpose(0, 1)).reshape(x.shape)
    return (dx, _rows(x).transpose(0, 1) @ dq,
            _rows(ctx).transpose(0, 1) @ _rows(g))


def reference_qkv_bwd_dkv(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1,
                          scale=1.0, causal=False):
    """Plain twin of #3: (dx_kv [b, t, dm], dW_k, dW_v [dm, hd]) with dk =
    ds^T q and dv = p^T dctx as the twin of #7 computes them, dx_kv = dk
    Wk^T + dv Wv^T, dW_k = x^T dk and dW_v = x^T dv."""
    hd = w_qkv.shape[1] // 3
    q, k, v, dctx, delta = _qkv_recompute(x, w_qkv, w_out, g, ctx, n_head)
    dk, dv = (_rows(a) for a in reference_flash_bwd_dkv(
        q, k, v, bias, dctx, lse, delta, scale, causal))
    dx = (dk @ w_qkv[:, hd:2 * hd].transpose(0, 1)
          + dv @ w_qkv[:, 2 * hd:].transpose(0, 1)).reshape(x.shape)
    xt = _rows(x).transpose(0, 1)
    return dx, xt @ dk, xt @ dv


def _qkv_args(what, x, w_qkv, w_out, bias, n_head, **more):
    """Check the operands of a fused-projection kernel and return (b, t,
    dm, hd, bias strides, bias pointer).  x (and g) [b, t, dm], w_qkv
    [dm, 3hd], w_out [hd, dm], ctx [b, t, h, 64] and lse [b, h, t] must be
    contiguous f32 on x's CUDA device, with head width 64 and d_model %
    32 == 0: the kernels index raw pointers."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {x.device}")
    b, t, dm = x.shape
    hd = w_qkv.shape[1] // 3
    dh = hd // n_head
    if dh != KERNEL_D_HEAD or dm % 32:
        raise ValueError(
            f"{what}: the CUDA kernel takes d_head 64 and d_model % 32 == "
            f"0, got d_head {dh}, d_model {dm}")
    f32 = torch.float32
    shapes = {"x": (b, t, dm), "w_qkv": (dm, 3 * hd), "w_out": (hd, dm),
              "g": (b, t, dm), "ctx": (b, t, n_head, dh),
              "lse": (b, n_head, t)}
    _build.require({name: (a, f32, shapes[name]) for name, a in dict(
        x=x, w_qkv=w_qkv, w_out=w_out, **more).items()}, x.device, what)
    if bias is not None:
        bias = _bias_view(bias, b, n_head, t, t, what)
    return (b, t, dm, hd) + _bias_strides(bias, x.device, what)


def _launch_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale, causal,
                    residuals):
    """Launch #1: y, or (y, ctx, lse) with ``residuals``."""
    b, t, dm, hd, strides, bias_ptr = _qkv_args(
        "qkv_attention_fwd", x, w_qkv, w_out, bias, n_head)
    y = torch.zeros_like(x)  # the kernel accumulates heads into y
    ctx = lse = None
    if residuals:
        ctx = torch.empty((b, t, n_head, hd // n_head), dtype=x.dtype,
                          device=x.device)
        lse = torch.empty((b, n_head, t), dtype=torch.float32,
                          device=x.device)
    err = _build.lib().ptt_qkv_attention_fwd(
        x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), bias_ptr,
        *strides, y.data_ptr(), ctx.data_ptr() if residuals else None,
        lse.data_ptr() if residuals else None, b, t, dm, n_head,
        float(scale), int(bool(causal)), _build.stream_of(x))
    _build.check(err, "qkv_attention_fwd")
    launches["qkv_attention_fwd"] += 1
    return (y, ctx, lse) if residuals else y


def qkv_attention_fwd(x, w_qkv, w_out, bias=None, n_head=1, scale=1.0,
                      causal=False):
    """#1 with residuals: (y, ctx, lse) as :func:`reference_qkv_fwd`
    computes them.  CPU tensors take the plain twin; CUDA tensors launch
    the kernel or raise."""
    if x.device.type == "cpu":
        return reference_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale,
                                 causal)
    return _launch_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale, causal,
                           residuals=True)


def _launch_qkv_bwd(which, x, w_qkv, w_out, bias, g, ctx, lse, n_head,
                    scale, causal):
    """Launch #2 (which 0), returning (dx_q, dW_q, dW_out), or #3 (which
    1), returning (dx_kv, dW_k, dW_v) as views of the kernel's one
    [dm, 2hd] dW_k | dW_v buffer."""
    what = ("qkv_bwd_dq", "qkv_bwd_dkv")[which]
    b, t, dm, hd, strides, bias_ptr = _qkv_args(
        what, x, w_qkv, w_out, bias, n_head, g=g, ctx=ctx, lse=lse)
    lib = _build.lib()
    scratch = torch.empty(lib.ptt_qkv_bwd_scratch(which, b, t, dm, n_head),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dw = torch.empty((dm, hd * (1 + which)), dtype=x.dtype, device=x.device)
    outs = [dx.data_ptr(), dw.data_ptr()]
    if not which:
        dw_out = torch.empty((hd, dm), dtype=x.dtype, device=x.device)
        outs.append(dw_out.data_ptr())
    entry = (lib.ptt_qkv_bwd_dq, lib.ptt_qkv_bwd_dkv)[which]
    err = entry(x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), bias_ptr,
                *strides, g.data_ptr(), ctx.data_ptr(), lse.data_ptr(),
                scratch.data_ptr(), *outs, b, t, dm, n_head, float(scale),
                int(bool(causal)), _build.stream_of(x))
    _build.check(err, what)
    launches[what] += 1
    return (dx, dw, dw_out) if not which else (dx, dw[:, :hd], dw[:, hd:])


def qkv_bwd_dq(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1, scale=1.0,
               causal=False):
    """#2: (dx_q, dW_q, dW_out) as :func:`reference_qkv_bwd_dq` computes
    them (CPU: the twin; CUDA: the kernel or an error)."""
    if x.device.type == "cpu":
        return reference_qkv_bwd_dq(x, w_qkv, w_out, bias, g, ctx, lse,
                                    n_head, scale, causal)
    return _launch_qkv_bwd(0, x, w_qkv, w_out, bias, g, ctx, lse, n_head,
                           scale, causal)


def qkv_bwd_dkv(x, w_qkv, w_out, bias, g, ctx, lse, n_head=1, scale=1.0,
                causal=False):
    """#3: (dx_kv, dW_k, dW_v) as :func:`reference_qkv_bwd_dkv` computes
    them (CPU: the twin; CUDA: the kernel or an error)."""
    if x.device.type == "cpu":
        return reference_qkv_bwd_dkv(x, w_qkv, w_out, bias, g, ctx, lse,
                                     n_head, scale, causal)
    return _launch_qkv_bwd(1, x, w_qkv, w_out, bias, g, ctx, lse, n_head,
                           scale, causal)


class _FlashQKVAttention(torch.autograd.Function):
    """y = flash_qkv_attention(x, w_qkv, w_out, bias); saves x, the
    weights, the bias and #1's residuals ctx and lse.  Its backward runs
    #2 and #3, sums dx = dx_q + dx_kv and packs dW_qkv = [dW_q | dW_k |
    dW_v] (the reference's ``_unpack_dw_qkv``, outside its kernels too).
    A bias that requires grad gets a plain recompute of ds reduced to its
    shape (the reference's ``_dbias_xla``); attention masks do not, and
    get None."""

    @staticmethod
    def forward(fn, x, w_qkv, w_out, bias, n_head, scale, causal):
        y, ctx, lse = qkv_attention_fwd(x, w_qkv, w_out, bias, n_head,
                                        scale, causal)
        fn.save_for_backward(x, w_qkv, w_out, bias, ctx, lse)
        fn.n_head, fn.scale, fn.causal = n_head, scale, causal
        return y

    @staticmethod
    def backward(fn, g):
        x, w_qkv, w_out, bias, ctx, lse = fn.saved_tensors
        kw = dict(n_head=fn.n_head, scale=fn.scale, causal=fn.causal)
        args = (x, w_qkv, w_out, bias, g.contiguous(), ctx, lse)
        dx_q, dw_q, dw_out = qkv_bwd_dq(*args, **kw)
        dx_kv, dw_k, dw_v = qkv_bwd_dkv(*args, **kw)
        dbias = None
        if fn.needs_input_grad[3]:
            q, k, v, dctx, delta = _qkv_recompute(
                x, w_qkv, w_out, args[4], ctx, fn.n_head)
            _, ds = _dscores(q, k, v, bias, dctx, lse, delta, fn.scale,
                             fn.causal)
            dbias = _reduce_to(ds, bias.shape).to(bias.dtype)
        return (dx_q + dx_kv, torch.cat([dw_q, dw_k, dw_v], dim=1), dw_out,
                dbias, None, None, None)


def flash_qkv_attention(x, w_qkv, w_out, bias=None, n_head=1, scale=1.0,
                        causal=False, dropout_rate=0.0):
    """Self-attention with the q/k/v and output projections fused in.

    x [b, t, d_model] f32; w_qkv [d_model, 3*h*dh] packed q|k|v, head-major
    within each third (the ``layers.fc`` layout); w_out [h*dh, d_model];
    bias broadcastable to [b, 1|h, 1|t, t] (the key-padding bias is
    [b, 1, 1, t], the decoder's [b, 1, t, t]).  Returns [b, t, d_model].

    Where autograd wants a gradient of any input it runs #1 with residuals
    and, in the backward, #2 and #3 (gradients of x, w_qkv, w_out, and of
    the bias when it requires grad); otherwise #1 alone, as serving runs
    it under ``torch.no_grad()``.  CPU tensors take the plain twins; CUDA
    tensors launch the kernels, which take dh == 64 and d_model % 32 == 0
    and raise on anything else.
    """
    if dropout_rate:
        raise NotImplementedError(
            "flash_qkv_attention: in-kernel dropout belongs to the dropout "
            "slice of the port, which is not done yet")
    b, t, _ = x.shape
    if w_qkv.shape[1] % (3 * n_head):
        raise ValueError(
            f"flash_qkv_attention: packed dim {w_qkv.shape[1]} not "
            f"divisible by 3*n_head={3 * n_head}")
    if bias is not None:
        bias = _bias_4d(bias, b, n_head, t, t, "flash_qkv_attention")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, w_qkv, w_out, bias)):
        return _FlashQKVAttention.apply(
            x.contiguous(), w_qkv.contiguous(), w_out.contiguous(), bias,
            n_head, float(scale), bool(causal))
    if x.device.type == "cpu":
        return reference_qkv_attention(x, w_qkv, w_out, bias, n_head,
                                       scale, causal)
    return _launch_qkv_fwd(x, w_qkv, w_out, bias, n_head, scale, causal,
                           residuals=False)


# ---------------------------------------------------------------------------
# flash_attention, fmt="bthd": kernels #4, #6, #7
# ---------------------------------------------------------------------------


def _causal_keep(tq, tk, device):
    """[tq, tk] bool: query i sees key j when j <= i + tk - tq (the
    reference's bottom-right-aligned causal mask)."""
    return torch.ones(tq, tk, dtype=torch.bool, device=device).tril(tk - tq)


def _heads_first(a):
    """[b, t, h, d] -> [b, h, t, d], in f32 (f64 stays f64)."""
    return a.transpose(1, 2).to(torch.promote_types(a.dtype, torch.float32))


def reference_flash_fwd(q, k, v, bias=None, scale=1.0, causal=False):
    """Plain PyTorch twin of #4: q [b, tq, h, d], k/v [b, tk, h, d], bias
    broadcastable to [b, h, tq, tk].  Returns (out [b, tq, h, d], lse
    [b, h, tq] f32).  A row whose max score is <= -1e29 gets a zero
    output and lse = +inf, as in the kernel."""
    qh, kh, vh = _heads_first(q), _heads_first(k), _heads_first(v)
    s = (qh * scale) @ kh.transpose(-1, -2)
    if bias is not None:
        s = s + bias.to(s.dtype)
    if causal:
        s = s.masked_fill(~_causal_keep(s.shape[-2], s.shape[-1], s.device),
                          MASK_VALUE)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    masked = m <= -1e29
    out = ((p @ vh) / l).masked_fill(masked, 0.0)
    lse = (m + torch.log(l)).masked_fill(masked, float("inf"))[..., 0]
    return out.transpose(1, 2).to(q.dtype), lse


def _probs(q, k, bias, lse, scale, causal):
    """p = exp(q k^T * scale + bias - lse) [b, h, tq, tk], causally hidden
    keys 0: the probabilities both backward kernels recompute."""
    s = (_heads_first(q) @ _heads_first(k).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(p.shape[-2], p.shape[-1], p.device),
                          0.0)
    return p


def _dscores(q, k, v, bias, dout, lse, delta, scale, causal):
    """(p, p * (dO v^T - delta)), both [b, h, tq, tk]: the gradient of the
    loss with respect to the biased scores is the second."""
    p = _probs(q, k, bias, lse, scale, causal)
    dp = _heads_first(dout) @ _heads_first(v).transpose(-1, -2)
    return p, p * (dp - delta[..., None])


def reference_flash_bwd_dq(q, k, v, bias, dout, lse, delta, scale=1.0,
                           causal=False):
    """Plain twin of #6: dq [b, tq, h, d] = ds k, with delta [b, h, tq] =
    rowsum(dout * out)."""
    _, ds = _dscores(q, k, v, bias, dout, lse, delta, scale, causal)
    return ((ds * scale) @ _heads_first(k)).transpose(1, 2).to(q.dtype)


def reference_flash_bwd_dkv(q, k, v, bias, dout, lse, delta, scale=1.0,
                            causal=False):
    """Plain twin of #7: (dk = ds^T q, dv = p^T dout), each [b, tk, h, d]."""
    p, ds = _dscores(q, k, v, bias, dout, lse, delta, scale, causal)
    dk = (ds * scale).transpose(-1, -2) @ _heads_first(q)
    dv = p.transpose(-1, -2) @ _heads_first(dout)
    return dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)


def _kernel_args(what, q, k, bias, **more):
    """Check the operands of a bthd kernel and return (b, tq, tk, h, bias
    strides, bias pointer).  Each tensor must be a contiguous f32 [b, t,
    h, 64] (or, for the [b, h, tq] rows in ``more``, that shape) on q's
    CUDA device; the kernels index raw pointers."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {q.device}")
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if d != KERNEL_D_HEAD:
        raise ValueError(f"{what}: the CUDA kernel takes head width 64, "
                         f"got {d}")
    f32 = torch.float32
    shapes = {"q": (b, tq, h, d), "k": (b, tk, h, d), "v": (b, tk, h, d),
              "dout": (b, tq, h, d), "lse": (b, h, tq), "delta": (b, h, tq)}
    _build.require({name: (a, f32, shapes[name])
                    for name, a in dict(q=q, k=k, **more).items()},
                   q.device, what)
    if bias is not None:
        bias = _bias_view(bias, b, h, tq, tk, what)
    return (b, tq, tk, h) + _bias_strides(bias, q.device, what)


def flash_fwd(q, k, v, bias=None, scale=1.0, causal=False):
    """#4: (out, lse) as :func:`reference_flash_fwd` computes them.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return reference_flash_fwd(q, k, v, bias, scale, causal)
    b, tq, tk, h, strides, bias_ptr = _kernel_args("flash_fwd", q, k, bias,
                                                   v=v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    err = _build.lib().ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
        out.data_ptr(), lse.data_ptr(), b, tq, tk, h, float(scale),
        int(bool(causal)), _build.stream_of(q))
    _build.check(err, "flash_fwd")
    launches["flash_fwd"] += 1
    return out, lse


def flash_bwd_dq(q, k, v, bias, dout, lse, delta, scale=1.0, causal=False):
    """#6: dq as :func:`reference_flash_bwd_dq` computes it (CPU: the
    twin; CUDA: the kernel or an error)."""
    if q.device.type == "cpu":
        return reference_flash_bwd_dq(q, k, v, bias, dout, lse, delta, scale,
                                      causal)
    b, tq, tk, h, strides, bias_ptr = _kernel_args(
        "flash_bwd_dq", q, k, bias, v=v, dout=dout, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    err = _build.lib().ptt_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b,
        tq, tk, h, float(scale), int(bool(causal)), _build.stream_of(q))
    _build.check(err, "flash_bwd_dq")
    launches["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(q, k, v, bias, dout, lse, delta, scale=1.0, causal=False):
    """#7: (dk, dv) as :func:`reference_flash_bwd_dkv` computes them (CPU:
    the twin; CUDA: the kernel or an error)."""
    if q.device.type == "cpu":
        return reference_flash_bwd_dkv(q, k, v, bias, dout, lse, delta,
                                       scale, causal)
    b, tq, tk, h, strides, bias_ptr = _kernel_args(
        "flash_bwd_dkv", q, k, bias, v=v, dout=dout, lse=lse, delta=delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _build.lib().ptt_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, *strides,
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, tq, tk, h, float(scale), int(bool(causal)),
        _build.stream_of(q))
    _build.check(err, "flash_bwd_dkv")
    launches["flash_bwd_dkv"] += 1
    return dk, dv


def _reduce_to(ds, shape):
    """Sum ds [b, h, tq, tk] over the dims a bias of ``shape`` broadcast."""
    dims = tuple(i for i, n in enumerate(shape) if n == 1 and ds.shape[i] != 1)
    return ds.sum(dim=dims, keepdim=True) if dims else ds


class _FlashAttention(torch.autograd.Function):
    """out = flash attention of (q, k, v, bias); saves (q, k, v, bias, out,
    lse).  Its backward takes delta = rowsum(dO * out) in f32, then the dq
    kernel and the dkv kernel.  A bias that requires grad gets a plain
    recompute of ds reduced to its shape (the reference's ``_dbias_xla``);
    attention masks do not, and get None."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, causal):
        out, lse = flash_fwd(q, k, v, bias, scale, causal)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        scale, causal = ctx.scale, ctx.causal
        dout = dout.contiguous()
        wide = torch.promote_types(out.dtype, torch.float32)
        delta = (dout.to(wide) * out.to(wide)).sum(-1).transpose(1, 2)
        delta = delta.contiguous()
        dq = flash_bwd_dq(q, k, v, bias, dout, lse, delta, scale, causal)
        dk, dv = flash_bwd_dkv(q, k, v, bias, dout, lse, delta, scale,
                               causal)
        dbias = None
        if ctx.needs_input_grad[3]:
            _, ds = _dscores(q, k, v, bias, dout, lse, delta, scale,
                             causal)
            dbias = _reduce_to(ds, bias.shape).to(bias.dtype)
        return dq, dk, dv, dbias, None, None


def flash_attention(q, k, v, bias=None, scale=1.0, causal=False,
                    fmt="bthd", dropout_rate=0.0):
    """softmax(q k^T * scale + bias) v per head, differentiable in q, k, v
    (and in bias when it requires grad).

    q [b, tq, h, d], k/v [b, tk, h, d] f32 (``fmt="bthd"``, the layout the
    projections give for free); bias broadcastable to [b, 1|h, 1|tq, tk]
    (the key-padding [b, 1, 1, tk] and decoder [b, 1, tq, tk] biases are
    read in place, never expanded); ``causal`` masks keys past
    query + tk - tq.  Returns [b, tq, h, d].  On the CPU every pass runs
    its plain twin; on CUDA the kernels #4, #6 and #7 (head width 64)."""
    if fmt != "bthd":
        raise NotImplementedError(
            f"flash_attention: fmt={fmt!r} needs the bhtd kernels #5, #8 "
            "and #9, which are not ported; pass [b, t, h, d] tensors with "
            "fmt='bthd'")
    if dropout_rate:
        raise NotImplementedError(
            "flash_attention: in-kernel weights dropout belongs to the "
            "dropout slice of the port, which is not done yet")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or (q.shape[0], q.shape[2], q.shape[3]) != (
                k.shape[0], k.shape[2], k.shape[3]):
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)} are not [b, tq, h, d] and [b, tk, h, d]")
    b, tq, h, _ = q.shape
    if bias is not None:
        bias = _bias_4d(bias, b, h, tq, k.shape[1], "flash_attention")
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bias, float(scale),
                                 bool(causal))
