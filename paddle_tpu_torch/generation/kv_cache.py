"""KVCache: the ring-buffer attention cache of the generation tier.

Counterpart of ``paddle_tpu/generation/kv_cache.py`` ``KVCache`` (ring
layout only).  One buffer per side across all layers:

    k, v    : [num_layers, batch, max_t, n_head, d_head] f32
    lengths : [batch] int32 valid-row counters

The decode step writes rows in place (the JAX package donates the same
buffers to its compiled step instead).
"""

from __future__ import annotations

import torch


def cache_rows(n: int) -> int:
    """Ring rows for n positions, rounded up to the reference's 128-row
    allocation quantum (``models/transformer.py`` ``_cache_rows``)."""
    return ((int(n) + 127) // 128) * 128


class KVCache:
    """Zero-filled cache buffers and length counters on ``device``."""

    def __init__(self, num_layers: int, batch: int, max_t: int,
                 n_head: int, d_head: int, device):
        self.shape = (num_layers, batch, max_t, n_head, d_head)
        self.k = torch.zeros(self.shape, dtype=torch.float32, device=device)
        self.v = torch.zeros(self.shape, dtype=torch.float32, device=device)
        self.lengths = torch.zeros(batch, dtype=torch.int32, device=device)
