"""Counterpart of ``paddle_tpu/passes.py`` ``attention_fuse``.

The reference's pass rewrites a program's hand-written scaled-dot-product
attention (``matmul(q, k^T, alpha)``, the bias ``elementwise_add``,
``softmax``, an upscale_in_train ``dropout``, ``matmul(., v)``) into one
``fused_attention`` op in the bhtd layout, with the dropout folded into
the kernels under a freshly drawn ``rng_id``.  The port's models are
modules, so the pass is eager: it switches the hand-written sites of a
module (:class:`~paddle_tpu_torch.models.transformer.MultiHeadAttention`
with ``use_flash`` off) to that route.
"""

from __future__ import annotations

from .models.transformer import MultiHeadAttention


def attention_fuse(module) -> int:
    """Switch every hand-written attention site in ``module`` to
    ``layers.contrib.fused_attention(fmt="bhtd")`` with in-kernel weights
    dropout at the site's rate (kernels #5, #8 and #9 on the card), and
    return how many were switched, as the reference's pass returns its
    rewrite count; a second call finds none and returns 0.  A switched
    site draws its dropout seed after every other site of its model, as
    the reference's rewritten op draws a new ``rng_id``
    (``BertPretrain.dropout_sites``)."""
    count = 0
    for m in module.modules():
        if (isinstance(m, MultiHeadAttention) and not m.use_flash
                and not m.attention_fused):
            m.attention_fused = True
            count += 1
    return count
