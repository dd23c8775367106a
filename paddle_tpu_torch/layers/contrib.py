"""Counterpart of ``paddle_tpu/layers/contrib.py`` ``fused_attention``."""

from __future__ import annotations

from ..kernels.attention import flash_attention
from ..kernels.dropout_epilogue import dropout


def fused_attention(q, k, v, bias=None, scale=1.0, causal=False,
                    dropout_rate=0.0, block_q=512, block_k=512, fmt="bhtd",
                    weights_dropout=True, dropout_seed=None, name=None):
    """Flash attention over [B, H, T, D] tensors (``fmt="bhtd"``, the
    default: kernels #5, #8 and #9 on the card) or [B, T, H, D] tensors
    (``fmt="bthd"``: #4, #6, #7), with the reference's defaults and
    :func:`~paddle_tpu_torch.kernels.attention.flash_attention`'s
    operands: an additive bias broadcast to [B, 1|H, 1|Tq, Tk],
    ``causal`` bottom-right aligned.

    With ``dropout_rate`` > 0 and ``weights_dropout`` (the default) the
    attention weights are dropped inside the kernels, the reference's
    dropout on the softmax; with ``weights_dropout=False`` the attention
    output is dropped instead by ``dropout`` (#16 without a residual,
    upscale_in_train), as the reference appends a ``dropout`` op.  Either
    way the site takes one uint32 ``dropout_seed`` per step: the fused
    op's in-kernel seed, or that ``dropout`` op's.  The caller passes
    rate 0 at inference.

    ``block_q`` and ``block_k`` are the TPU kernels' tile hints; the CUDA
    kernels tile by 64 rows whatever they say, so they are accepted and
    unused.  ``name`` is accepted as the reference's is."""
    del block_q, block_k, name
    if dropout_rate and dropout_seed is None:
        raise ValueError("fused_attention: dropout_rate > 0 needs "
                         "dropout_seed")
    in_kernel = dropout_rate if weights_dropout else 0.0
    out = flash_attention(q, k, v, bias, scale=scale, causal=causal,
                          fmt=fmt, dropout_rate=in_kernel,
                          dropout_seed=dropout_seed if in_kernel else None)
    if dropout_rate and not weights_dropout:
        out = dropout(out, dropout_rate, dropout_seed)
    return out
