"""Counterparts of ``paddle_tpu/ops/generation_ops.py`` ``sample_token``
(greedy) and ``kv_cache_update``."""

from __future__ import annotations

import torch


def sample_token(logits):
    """Greedy next token: argmax over the last axis of logits [b, V], the
    first index among equal maxima (``jnp.argmax``'s rule).  Returns
    [b] int64."""
    return torch.argmax(logits.float(), dim=-1)


def kv_cache_update(cache_k, cache_v, k, v, pos, layer, active):
    """Write k/v [b, t, h, dh] into rows pos[b] .. pos[b]+t-1 of cache
    layer ``layer`` ([L, b, max_t, h, dh]), in place.  The start clamps so
    the rows fit, as ``dynamic_update_slice`` clamps; lanes with
    ``active`` [b] == 0 keep their rows."""
    b, t = k.shape[:2]
    max_t = cache_k.shape[2]
    starts = pos.reshape(-1).long().clamp(0, max_t - t)
    rows = starts[:, None] + torch.arange(t, device=cache_k.device)
    lanes = torch.arange(b, device=cache_k.device)[:, None]
    keep = active.reshape(-1).bool()[:, None, None, None]
    for cache, new in ((cache_k, k), (cache_v, v)):
        old = cache[layer, lanes, rows]
        cache[layer, lanes, rows] = torch.where(keep, new.to(cache.dtype),
                                                old)
