"""Autoregressive generation: the ring KV cache and the greedy session."""

from .kv_cache import KVCache  # noqa: F401
from .sampler import GenerationSession  # noqa: F401
