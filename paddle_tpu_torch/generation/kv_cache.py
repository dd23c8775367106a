"""The attention caches of the generation tier: the ring ``KVCache``, the
paged ``PagedKVCache`` and its ``BlockAllocator``.

Counterparts of ``paddle_tpu/generation/kv_cache.py``.  The ring keeps
one buffer per side across all layers:

    k, v    : [num_layers, batch, max_t, n_head, d_head] f32
    lengths : [batch] int32 valid-row counters

The paged cache keeps a global block pool per side and a block table:

    k, v    : [num_layers, num_blocks, block_t, n_head, d_head] f32
    table   : [batch, max_blocks] int32 pool block ids
    lengths : [batch] int32

Logical row r of slot i lives at block table[i, r // block_t], row
r % block_t.  Decode steps write rows in place (the JAX package donates
the same buffers to its compiled step instead).  Both caches carry the
op surface the decoder step draws from (``write``, ``attend``), so the
model is layout-blind.

The table lives on the device, where the kernels read it, and as a host
mirror (``host_table``) that the allocator's bookkeeping reads: a table
update copies one row to the device and never reads the device back.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.generation_ops import (decode_attention, kv_cache_update,
                                  paged_decode_attention,
                                  paged_kv_cache_update)

_F32_BYTES = 4


def cache_rows(n: int) -> int:
    """Ring rows for n positions, rounded up to the reference's 128-row
    allocation quantum (``models/transformer.py`` ``_cache_rows``)."""
    return ((int(n) + 127) // 128) * 128


def _numel(shape) -> int:
    return int(np.prod(shape))


class KVCache:
    """Zero-filled ring buffers and length counters on ``device``."""

    def __init__(self, num_layers: int, batch: int, max_t: int,
                 n_head: int, d_head: int, device):
        self.batch = batch
        self.shape = (num_layers, batch, max_t, n_head, d_head)
        self.k = torch.zeros(self.shape, dtype=torch.float32, device=device)
        self.v = torch.zeros(self.shape, dtype=torch.float32, device=device)
        self.lengths = torch.zeros(batch, dtype=torch.int32, device=device)

    @property
    def hbm_bytes(self) -> int:
        """Resident bytes: K + V buffers and the length counters."""
        return 2 * _numel(self.shape) * _F32_BYTES + 4 * self.batch

    def write(self, k, v, pos, layer, active):
        """k/v [b, t, h, dh] into rows pos[b] .. of layer ``layer``; lanes
        with ``active`` == 0 keep their rows."""
        kv_cache_update(self.k, self.v, k, v, pos, layer, active)

    def attend(self, q, lengths, layer, scale):
        """q [b, 1, h, dh] against the first lengths[b] rows of layer
        ``layer`` -> [b, 1, h, dh]."""
        return decode_attention(q, self.k, self.v, lengths, layer, scale)


class BlockAllocator:
    """Host-side ledger over a paged pool: a free list and per-block
    reference counts.

    ``alloc`` hands out blocks at ref 1, lowest id first; ``share`` bumps
    the refs of blocks a later request maps into its own table; ``free``
    decrefs and reclaims at zero.  A block with ref > 1 is never written:
    ``PagedKVCache.cow_if_shared`` copies it first.  ``reserve`` low
    blocks are withheld from the free list (dynamic serving reserves block
    0 as the trap block)."""

    def __init__(self, num_blocks: int, reserve: int = 0):
        self.num_blocks = int(num_blocks)
        self.reserve = int(reserve)
        # pop() from the tail -> lowest block first
        self._free = list(range(self.num_blocks - 1, self.reserve - 1, -1))
        self._refs = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - self.reserve - len(self._free)

    def refcount(self, block: int) -> int:
        return self._refs.get(int(block), 0)

    def alloc(self, n: int):
        """n fresh blocks at ref 1; MemoryError (ledger intact) when the
        pool cannot cover them."""
        if n > len(self._free):
            raise MemoryError(
                f"paged KV pool exhausted: want {n} blocks, "
                f"{len(self._free)} free of {self.num_blocks}")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def share(self, blocks) -> None:
        for b in blocks:
            b = int(b)
            if self._refs.get(b, 0) <= 0:
                raise ValueError(f"share of unallocated block {b}")
            self._refs[b] += 1

    def free(self, blocks) -> None:
        for b in blocks:
            b = int(b)
            r = self._refs.get(b, 0)
            if r <= 0:
                raise ValueError(f"double free of block {b}")
            if r == 1:
                del self._refs[b]
                self._free.append(b)
            else:
                self._refs[b] = r - 1


class PagedKVCache:
    """Paged pools, block table and counters on ``device``.

    ``num_blocks`` 0 sizes the pool ring-equivalent (batch * max_blocks).
    Two modes, as in the reference:

    * :meth:`allocate`: static identity tables, slot i owning blocks
      [i * max_blocks, (i + 1) * max_blocks): the ring's capacity;
    * :meth:`reset_dynamic`: serving mode, block 0 reserved as the trap
      block, every table entry parked on it, the rest on the allocator's
      free list; the batcher maps blocks per request.

    The constructor allocates the zeroed pools, counters and an all-trap
    table; call one of the two before use."""

    def __init__(self, num_layers: int, batch: int, max_t: int,
                 n_head: int, d_head: int, device, block_t: int = 16,
                 num_blocks: int = 0):
        if block_t <= 0 or block_t % 8:
            raise ValueError(f"block_t must be a positive multiple of 8, "
                             f"got {block_t}")
        self.num_layers, self.batch = num_layers, batch
        self.n_head, self.d_head = n_head, d_head
        self.block_t = int(block_t)
        self.max_blocks = -(-int(max_t) // self.block_t)
        self.num_blocks = int(num_blocks) or batch * self.max_blocks
        self.shape = (num_layers, self.num_blocks, self.block_t, n_head,
                      d_head)
        self.k = torch.zeros(self.shape, dtype=torch.float32, device=device)
        self.v = torch.zeros(self.shape, dtype=torch.float32, device=device)
        self.lengths = torch.zeros(batch, dtype=torch.int32, device=device)
        self.host_table = np.zeros((batch, self.max_blocks), np.int32)
        self.table = torch.zeros((batch, self.max_blocks), dtype=torch.int32,
                                 device=device)
        self.allocator = None  # armed by reset_dynamic

    @property
    def logical_max_t(self) -> int:
        return self.max_blocks * self.block_t

    @property
    def block_bytes(self) -> int:
        """K + V bytes one block pins across all layers: the quantum of
        the batcher's block-budget admission."""
        return (2 * self.num_layers * self.block_t * self.n_head
                * self.d_head * _F32_BYTES)

    @property
    def hbm_bytes(self) -> int:
        """Resident bytes: pools, length counters and the block table."""
        return (2 * _numel(self.shape) * _F32_BYTES + 4 * self.batch
                + 4 * self.batch * self.max_blocks)

    def blocks_for(self, rows: int) -> int:
        return -(-max(int(rows), 0) // self.block_t)

    # -- the op surface of the decoder step ------------------------------
    def write(self, k, v, pos, layer, active):
        """k/v [b, t, h, dh] into logical rows pos[b] .. of layer
        ``layer``, through the table; inactive lanes and rows past the
        logical window are dropped."""
        paged_kv_cache_update(self.k, self.v, k, v, self.table, pos, layer,
                              active)

    def attend(self, q, lengths, layer, scale):
        """q [b, 1, h, dh] against the first lengths[b] logical rows of
        layer ``layer`` -> [b, 1, h, dh]."""
        return paged_decode_attention(q, self.k, self.v, self.table,
                                      lengths, layer, scale)

    # -- host side ---------------------------------------------------------
    def _set_table(self, table: np.ndarray) -> None:
        self.host_table = table.astype(np.int32)
        self.table.copy_(torch.from_numpy(self.host_table))

    def allocate(self) -> None:
        """Static mode: zero pools and counters, identity tables."""
        if self.num_blocks < self.batch * self.max_blocks:
            raise ValueError(
                f"static paged cache needs >= batch*max_blocks = "
                f"{self.batch * self.max_blocks} blocks, pool has "
                f"{self.num_blocks} (size it, or run reset_dynamic)")
        self.k.zero_()
        self.v.zero_()
        self.lengths.zero_()
        self._set_table(np.arange(self.batch * self.max_blocks)
                        .reshape(self.batch, self.max_blocks))
        self.allocator = None

    def reset_dynamic(self) -> None:
        """Dynamic mode: arm the allocator (block 0 = trap), park every
        table entry on the trap block, zero the counters.  Pool contents
        are not cleared: stale rows sit behind the length masks."""
        self.lengths.zero_()
        self._set_table(np.zeros((self.batch, self.max_blocks), np.int32))
        self.allocator = BlockAllocator(self.num_blocks, reserve=1)

    def set_table_row(self, slot: int, blocks) -> None:
        """Point ``slot``'s table row at ``blocks`` (tail entries -> the
        trap block 0)."""
        row = np.zeros((self.max_blocks,), np.int32)
        row[:len(blocks)] = blocks
        self.host_table[slot] = row
        self.table[slot].copy_(torch.from_numpy(row))

    def slot_blocks(self, slot: int, rows: int):
        """The block ids backing ``slot``'s first ``rows`` logical rows."""
        return [int(b) for b in
                self.host_table[slot][:self.blocks_for(rows)]]

    def cow_if_shared(self, slot: int, pos: int) -> bool:
        """Copy-on-write guard before an append at logical row ``pos`` of
        ``slot``: when the covering block is shared (ref > 1), copy it, in
        every layer and on both sides, into a fresh block, re-point this
        slot's table entry and decref the original, so the sharer keeps
        its rows.  Returns True when a copy happened.  Dynamic mode
        only."""
        alloc = self.allocator
        if alloc is None:
            return False
        idx = int(pos) // self.block_t
        old = int(self.host_table[slot, idx])
        if alloc.refcount(old) <= 1:
            return False
        new = alloc.alloc(1)[0]
        for pool in (self.k, self.v):
            pool[:, new] = pool[:, old]
        row = self.host_table[slot].copy()
        row[idx] = new
        self.set_table_row(slot, row)
        alloc.free([old])
        return True

    def fork_slot(self, dst_slot: int, src_slot: int, rows: int) -> None:
        """Map ``src_slot``'s first ``rows`` logical rows into
        ``dst_slot``'s table by sharing the covering blocks (ref++); the
        next divergent append on either slot goes through
        :meth:`cow_if_shared`."""
        blocks = self.slot_blocks(src_slot, rows)
        self.allocator.share(blocks)
        old = self.slot_blocks(dst_slot, int(self.lengths[dst_slot]))
        self.set_table_row(dst_slot, blocks)
        if old:
            self.allocator.free(old)
