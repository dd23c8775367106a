"""Fused-projection self-attention, forward only.

Counterpart of ``paddle_tpu/kernels/attention.py`` ``flash_qkv_attention``
(its forward Pallas kernel ``_qkv_fwd_kernel``).  On a CUDA tensor the
q/k/v projections, the online-softmax attention and the output projection
run in one launch of ``csrc/qkv_attention.cu``; q, k, v and the per-head
context stay in shared memory.  :func:`reference_qkv_attention` is the
plain version: the math of the reference's ``_composed_qkv``.

Dropout, the ``ctx``/``lse`` residuals and the backward belong to
training and are not part of this module yet.
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


def _bias_view(bias, b, n_head, t):
    """Broadcast an additive bias to a [b, h, t, t] view (no copy) and
    return it; raises on shapes that do not broadcast."""
    while bias.dim() < 4:
        bias = bias.unsqueeze(0)
    bb, hb, tqb, tkb = bias.shape
    if (bb not in (1, b) or hb not in (1, n_head) or tqb not in (1, t)
            or tkb not in (1, t)):
        raise ValueError(
            f"flash_qkv_attention: bias {tuple(bias.shape)} does not "
            f"broadcast to [{b}, {n_head}, {t}, {t}]")
    return bias.expand(b, n_head, t, t)


def flash_qkv_attention(x, w_qkv, w_out, bias=None, n_head=1, scale=1.0,
                        causal=False, dropout_rate=0.0):
    """Self-attention with the q/k/v and output projections fused in.

    x [b, t, d_model] f32; w_qkv [d_model, 3*h*dh] packed q|k|v, head-major
    within each third (the ``layers.fc`` layout); w_out [h*dh, d_model];
    bias broadcastable to [b, 1|h, 1|t, t] (the prefill's key-padding
    bias is [b, 1, 1, t]).  Returns [b, t, d_model].

    CPU tensors take :func:`reference_qkv_attention`; CUDA tensors launch
    the kernel, which takes dh == 64 and d_model % 32 == 0 and raises on
    anything else.
    """
    if dropout_rate:
        raise NotImplementedError(
            "flash_qkv_attention: dropout belongs to training, which this "
            "port does not have yet")
    b, t, dm = x.shape
    if w_qkv.shape[1] % (3 * n_head):
        raise ValueError(
            f"flash_qkv_attention: packed dim {w_qkv.shape[1]} not "
            f"divisible by 3*n_head={3 * n_head}")
    hd = w_qkv.shape[1] // 3
    if bias is not None:
        bias = _bias_view(bias, b, n_head, t)
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
    if bias is not None and (bias.device != x.device or bias.dtype != f32):
        raise ValueError(f"flash_qkv_attention: bias must be f32 on "
                         f"{x.device}, got {bias.dtype} on {bias.device}")
    strides = bias.stride() if bias is not None else (0, 0, 0, 0)
    y = torch.zeros_like(x)  # the kernel accumulates heads into y
    err = _build.lib().ptt_qkv_attention_fwd(
        x.data_ptr(), w_qkv.data_ptr(), w_out.data_ptr(),
        bias.data_ptr() if bias is not None else None, *strides,
        y.data_ptr(), b, t, dm, n_head, float(scale), int(bool(causal)),
        _build.stream_of(x))
    _build.check(err, "qkv_attention_fwd")
    launches["qkv_attention_fwd"] += 1
    return y
