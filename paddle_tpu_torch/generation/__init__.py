"""Autoregressive generation: the ring and paged KV caches and the greedy
session."""

from .kv_cache import BlockAllocator, KVCache, PagedKVCache  # noqa: F401
from .sampler import GenerationSession  # noqa: F401
