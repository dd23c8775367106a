"""Counterparts of ``paddle_tpu/ops/generation_ops.py`` ``sample_token``
(greedy), ``kv_cache_update``, ``paged_kv_cache_update`` and the unfused
decoder step's ``decode_attention`` and ``paged_decode_attention``.

The two attention ops always reach the flash-decode kernels for CUDA
tensors; the reference's ``FLAGS_flash_decode=0`` branch to its XLA twin
is a fallback, and the port has none."""

from __future__ import annotations

import torch

from ..kernels import decode_attention as kda


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


def paged_kv_cache_update(cache_k, cache_v, k, v, table, pos, layer,
                          active):
    """Paged form of :func:`kv_cache_update`: k/v [b, t, h, dh] rows land
    at logical rows pos[b] .. of layer ``layer`` of the pools [L,
    num_blocks, block_t, h, dh], addressed through table [b, max_blocks];
    rows of inactive lanes and rows past the logical window are dropped.
    In place."""
    kda.paged_scatter_rows(cache_k, k, table, pos, active, layer)
    kda.paged_scatter_rows(cache_v, v, table, pos, active, layer)


def decode_attention(q, cache_k, cache_v, lengths, layer, scale):
    """q [b, 1, h, dh] against the first lengths[b] rows of layer
    ``layer`` of the ring cache [L, b, max_t, h, dh] -> [b, 1, h, dh]."""
    b, _, h, dh = q.shape
    q3 = q.reshape(b, h, dh).contiguous()
    out = kda.flash_decode(q3, cache_k[layer], cache_v[layer], lengths,
                           scale)
    return out.reshape(b, 1, h, dh)


def paged_decode_attention(q, cache_k, cache_v, table, lengths, layer,
                           scale):
    """q [b, 1, h, dh] against the first lengths[b] logical rows of layer
    ``layer`` of the pools, walked through table [b, max_blocks] ->
    [b, 1, h, dh]."""
    b, _, h, dh = q.shape
    q3 = q.reshape(b, h, dh).contiguous()
    out = kda.flash_decode_paged(q3, cache_k[layer], cache_v[layer], table,
                                 lengths, scale)
    return out.reshape(b, 1, h, dh)
