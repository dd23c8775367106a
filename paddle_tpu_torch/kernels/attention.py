"""Flash attention: the fused-projection forward and the bthd kernels.

Counterparts of ``paddle_tpu/kernels/attention.py``:

* :func:`flash_qkv_attention` (``csrc/qkv_attention.cu``, for
  ``_qkv_fwd_kernel``, #1): the q/k/v projections, the online-softmax
  attention and the output projection in one launch; q, k, v and the
  per-head context stay in shared memory.  Forward only: its backward
  kernels (#2, #3) are not ported, so it refuses to run where a gradient
  is wanted.  :func:`reference_qkv_attention` is its plain version, the
  math of the reference's ``_composed_qkv``.
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


def _split_heads(a, b, t, n_head, dh):
    return a.reshape(b, t, n_head, dh).transpose(1, 2)  # [b, h, t, dh]


def reference_qkv_attention(x, w_qkv, w_out, bias=None, n_head=1,
                            scale=1.0, causal=False):
    """Plain PyTorch: ``softmax((x Wq)(x Wk)^T * scale + bias) (x Wv)``
    per head, concatenated, ``@ w_out``.  A row whose scores are all
    masked (max <= -1e29) gets a zero context, as in the kernel."""
    b, t, _ = x.shape
    hd = w_qkv.shape[1] // 3
    dh = hd // n_head
    qkv = x @ w_qkv
    q = _split_heads(qkv[..., :hd], b, t, n_head, dh)
    k = _split_heads(qkv[..., hd:2 * hd], b, t, n_head, dh)
    v = _split_heads(qkv[..., 2 * hd:], b, t, n_head, dh)
    logits = (q @ k.transpose(-1, -2)).float() * scale
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~keep, MASK_VALUE)
    masked = logits.amax(dim=-1, keepdim=True) <= -1e29
    weights = torch.softmax(logits, dim=-1).masked_fill(masked, 0.0)
    ctx = (weights.to(v.dtype) @ v).transpose(1, 2).reshape(b, t, hd)
    return (ctx @ w_out).to(x.dtype)


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


def flash_qkv_attention(x, w_qkv, w_out, bias=None, n_head=1, scale=1.0,
                        causal=False, dropout_rate=0.0):
    """Self-attention with the q/k/v and output projections fused in.

    x [b, t, d_model] f32; w_qkv [d_model, 3*h*dh] packed q|k|v, head-major
    within each third (the ``layers.fc`` layout); w_out [h*dh, d_model];
    bias broadcastable to [b, 1|h, 1|t, t] (the prefill's key-padding
    bias is [b, 1, 1, t]).  Returns [b, t, d_model].

    CPU tensors take :func:`reference_qkv_attention`; CUDA tensors launch
    the kernel, which takes dh == 64 and d_model % 32 == 0 and raises on
    anything else.  Forward only, on both devices: where autograd would
    want a gradient of any input it raises, since the backward kernels
    (#2, #3) are not ported; serving runs under ``torch.no_grad()``.
    """
    if dropout_rate:
        raise NotImplementedError(
            "flash_qkv_attention: in-kernel dropout belongs to the dropout "
            "slice of the port, which is not done yet")
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, w_qkv, w_out, bias)):
        raise NotImplementedError(
            "flash_qkv_attention: no backward yet (kernels #2 and #3 are "
            "the next slice); train with fused_qkv_attention=False, which "
            "runs flash_attention(fmt='bthd'), or call under "
            "torch.no_grad()")
    b, t, dm = x.shape
    if w_qkv.shape[1] % (3 * n_head):
        raise ValueError(
            f"flash_qkv_attention: packed dim {w_qkv.shape[1]} not "
            f"divisible by 3*n_head={3 * n_head}")
    hd = w_qkv.shape[1] // 3
    if bias is not None:
        bias = _bias_view(bias, b, n_head, t, t, "flash_qkv_attention")
    if x.device.type == "cpu":
        return reference_qkv_attention(x, w_qkv, w_out, bias, n_head,
                                       scale, causal)
    dh = hd // n_head
    if x.device.type != "cuda":
        raise ValueError(f"flash_qkv_attention: no kernel for {x.device}")
    if dh != KERNEL_D_HEAD or dm % 32:
        raise ValueError(
            f"flash_qkv_attention: the CUDA kernel takes d_head 64 and "
            f"d_model % 32 == 0, got d_head {dh}, d_model {dm}")
    f32 = torch.float32
    _build.require({"x": (x, f32, (b, t, dm)),
                    "w_qkv": (w_qkv, f32, (dm, 3 * hd)),
                    "w_out": (w_out, f32, (hd, dm))}, x.device,
                   "flash_qkv_attention")
    strides, bias_ptr = _bias_strides(bias, x.device, "flash_qkv_attention")
    y = torch.zeros_like(x)  # the kernel accumulates heads into y
    err = _build.lib().ptt_qkv_attention_fwd(
        x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(), bias_ptr,
        *strides, y.data_ptr(), b, t, dm, n_head, float(scale),
        int(bool(causal)), _build.stream_of(x))
    _build.check(err, "qkv_attention_fwd")
    launches["qkv_attention_fwd"] += 1
    return y


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
        s = s + bias.float()
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
        s = s + bias.float()
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
