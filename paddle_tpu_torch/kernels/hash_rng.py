"""Counter-based hash PRNG of the dropout masks, over torch tensors.

The port's own copy of ``paddle_tpu/kernels/hash_rng.py``: a keep bit is
a pure function of a uint32 seed and a uint32 element index,

    bits(i) = lowbias32(i * GOLDEN + seed)
    keep(i) = bits(i) >= round(rate * 2^32)

so the forward and backward kernels regenerate the same mask, no mask
tensor is stored, and the plain twins here give the reference's bits for
the same seeds.  The kernels inline the same functions from
``csrc/hash_rng.cuh``.

torch has no uint32 arithmetic on the CPU, so the hash runs in int64 with
every product and sum masked to its low 32 bits: a 32 x 32-bit product
may wrap int64, but its low 32 bits survive the wrap, and the right
shifts then act on non-negative values.
"""

from __future__ import annotations

import numpy as np
import torch

GOLDEN = 0x9E3779B9  # 2^32 / phi, odd: i * GOLDEN is a bijection mod 2^32
_M32 = 0xFFFFFFFF


def mix32(x):
    """lowbias32 over an int64 tensor of uint32 values (or one Python
    int); returns the same."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def mix32_fast(x):
    """The two-round mixer of the attention-weights masks (one multiply)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    return x ^ (x >> 15)


def keep_threshold(rate: float) -> int:
    """uint32 threshold such that P(bits >= threshold) = 1 - rate."""
    t = int(round(float(rate) * 4294967296.0))
    return max(0, min(t, _M32))


def seed_from_key_data(key_data, rng_id: int) -> int:
    """The uint32 stream seed of one dropout site in one step:
    ``(kd[0] * GOLDEN + kd[-1]) ^ mix32(rng_id)`` over the step key's
    uint32 data ``kd`` (the reference's ``seed_from_key``), in numpy."""
    kd = np.asarray(key_data).reshape(-1).astype(np.uint32)
    head = (int(kd[0]) * GOLDEN + int(kd[-1])) & _M32
    return head ^ mix32(int(rng_id))


def keep_mask(seed: int, shape, rate: float, device=None):
    """Bool keep mask of ``shape`` over the flat element index: True with
    probability 1 - rate (the reference's ``keep_mask``)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=device)
    bits = mix32(idx * GOLDEN + (int(seed) & _M32))
    return (bits >= keep_threshold(rate)).reshape(tuple(shape))


def attn_head_seed(seed: int, bh):
    """Seed of head ``bh`` = b * H + h (an int64 tensor) of one attention
    site: ``mix32(seed + bh * GOLDEN)``."""
    return mix32(bh * GOLDEN + (int(seed) & _M32))


def keep_mask_attn(seed: int, shape, rate: float, device=None):
    """Attention-weights keep mask over [b, h, tq, tk]: element (b, h, q,
    k) keys on (seed, b * h_count + h, q * tk + k), the bits the kernels
    draw (the reference's ``keep_mask_attn``).  Raises when tq * tk >
    2^32, where the in-plane index would wrap."""
    b, h, tq, tk = (int(s) for s in shape)
    if tq * tk > 2 ** 32:
        raise ValueError(
            f"keep_mask_attn: mask plane tq*tk = {tq}*{tk} > 2^32 wraps the "
            "uint32 hash index and correlates mask bits")
    hseed = attn_head_seed(seed, torch.arange(b * h, dtype=torch.int64,
                                              device=device))
    plane = torch.arange(tq * tk, dtype=torch.int64, device=device)
    bits = mix32_fast(plane[None, :] * GOLDEN + hseed[:, None])
    return (bits >= keep_threshold(rate)).reshape(b, h, tq, tk)
