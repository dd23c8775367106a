"""Flash-decode: single-query attention over the ring cache or the paged
block pool.

Counterpart of ``paddle_tpu/kernels/decode_attention.py``:

* :func:`flash_decode` (``csrc/decode_attention.cu``, for
  ``_decode_kernel``): q [b, h, dh] against the first lengths[b] rows of
  one layer's ring cache k/v [b, max_t, h, dh];
* :func:`flash_decode_paged` (same source, for ``_paged_decode_kernel``):
  the same against one layer's pools [num_blocks, block_t, h, dh], row r
  of sequence i at block table[i, r // block_t], row r % block_t;
* :func:`paged_scatter_rows`: the paged cache write, the core of
  ``paged_kv_cache_update`` and of the composed paged decoder step.

The plain versions are :func:`reference_decode` and
:func:`reference_decode_paged`.  A lane with length 0 gets a zero context
in both, as in the TPU kernels (the reference's XLA twin spreads its
weight uniformly instead).
"""

from __future__ import annotations

import torch

from . import KERNEL_D_HEAD, _build, composes, launches


def reference_decode(q, k, v, lengths, scale=1.0):
    """Single-query attention: q [b, h, dh] against the first lengths[b]
    rows of k/v [b, max_t, h, dh]; f32 softmax.  A lane with length 0
    gets a zero context, as in the kernels."""
    max_t = k.shape[1]
    logits = torch.einsum("bhd,bthd->bht", q.float(), k.float()) * scale
    valid = (torch.arange(max_t, device=q.device)[None, :]
             < lengths.long()[:, None])                      # [b, t]
    logits = logits.masked_fill(~valid[:, None, :], -1e30)
    w = torch.softmax(logits, dim=-1) * (lengths > 0).float()[:, None, None]
    return torch.einsum("bht,bthd->bhd", w, v.float()).to(q.dtype)


def reference_decode_paged(q, k_pool, v_pool, table, lengths, scale=1.0):
    """Plain paged walk: gather every sequence's table-addressed blocks
    into its logical [max_blocks * block_t] view and run
    :func:`reference_decode` on it.  Rows past a length never count, so
    whatever sits in unreferenced or trap blocks does not matter."""
    _, bt, h, dh = k_pool.shape
    b, mb = table.shape
    flat = table.reshape(-1).long()
    view_k = k_pool[flat].reshape(b, mb * bt, h, dh)
    view_v = v_pool[flat].reshape(b, mb * bt, h, dh)
    return reference_decode(q, view_k, view_v, lengths, scale)


def paged_scatter_rows(cache, new, table, pos, active, layer):
    """Write new [b, t, h, dh] into logical rows pos[b] .. pos[b]+t-1 of
    layer ``layer`` of the pool cache [L, num_blocks, block_t, h, dh], in
    place: row r of lane i lands at block table[i, r // block_t], row
    r % block_t.  Rows of lanes with ``active`` [b] == 0 (None: all
    active) and rows at or past max_blocks * block_t are dropped.

    Targets may repeat: joining lanes of a prefill all write the rows past
    their blocks into the trap block, which no length ever reads.  The
    dropped rows are routed, without a device-to-host sync, to the target
    of the first kept row and carry that row's value, so no dropped row can
    change what a kept one writes."""
    nb, bt, h, dh = cache.shape[1:]
    b, t = new.shape[:2]
    mb = table.shape[1]
    dev = cache.device
    rows = pos.reshape(-1, 1).long() + torch.arange(t, device=dev)
    blk = torch.gather(table.long(), 1, (rows // bt).clamp(0, mb - 1))
    flat = (blk * bt + rows % bt).reshape(-1)
    keep = rows < mb * bt
    if active is not None:
        keep = keep & (active.reshape(-1, 1) != 0)
    keep = keep.reshape(-1)
    vals = new.reshape(b * t, h, dh).to(cache.dtype)
    first = torch.argmax(keep.int())        # 0 when nothing is kept
    pool = cache[layer].view(nb * bt, h, dh)
    target = torch.where(keep, flat, flat[first])
    fill = torch.where(keep[first], vals[first], pool[flat[first]])
    pool[target] = torch.where(keep[:, None, None], vals, fill)


def _check_query(q, lengths, what):
    b, h, dh = q.shape
    if q.device.type != "cuda" or dh != KERNEL_D_HEAD:
        raise ValueError(f"{what}: no kernel for q {tuple(q.shape)} on "
                         f"{q.device} (needs CUDA and d_head 64)")
    return {"q": (q, torch.float32, (b, h, dh)),
            "lengths": (lengths, torch.int32, (b,))}


def flash_decode(q, k, v, lengths, scale=1.0):
    """Single-query attention against a length-masked ring cache slice.
    q [b, h, dh]; k/v [b, max_t, h, dh]; lengths [b] int32.  Returns
    [b, h, dh].  On CUDA at a head width % 64 != 0 the plain walk (the
    reference's plan declines the kernel there)."""
    if q.device.type == "cpu" or composes("flash_decode", q.shape[-1]):
        return reference_decode(q, k, v, lengths, scale)
    b, h, dh = q.shape
    max_t = k.shape[1]
    spec = _check_query(q, lengths, "flash_decode")
    spec.update(k=(k, torch.float32, (b, max_t, h, dh)),
                v=(v, torch.float32, (b, max_t, h, dh)))
    _build.require(spec, q.device, "flash_decode")
    out = torch.empty_like(q)
    err = _build.lib().ptt_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, max_t, h, float(scale), _build.stream_of(q))
    _build.check(err, "flash_decode")
    launches["flash_decode"] += 1
    return out


def flash_decode_paged(q, k_pool, v_pool, table, lengths, scale=1.0):
    """Single-query attention over one layer's paged pools.  q [b, h, dh];
    k_pool/v_pool [num_blocks, block_t, h, dh]; table [b, max_blocks]
    int32 pool block ids (trusted: the host allocator owns them); lengths
    [b] int32.  Returns [b, h, dh].  On CUDA at a head width % 64 != 0
    the plain walk, as :func:`flash_decode`."""
    if q.device.type == "cpu" or composes("flash_decode_paged",
                                          q.shape[-1]):
        return reference_decode_paged(q, k_pool, v_pool, table, lengths,
                                      scale)
    b, h, dh = q.shape
    nb, bt = k_pool.shape[:2]
    mb = table.shape[1]
    spec = _check_query(q, lengths, "flash_decode_paged")
    spec.update(k_pool=(k_pool, torch.float32, (nb, bt, h, dh)),
                v_pool=(v_pool, torch.float32, (nb, bt, h, dh)),
                table=(table, torch.int32, (b, mb)))
    _build.require(spec, q.device, "flash_decode_paged")
    out = torch.empty_like(q)
    err = _build.lib().ptt_flash_decode_paged(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, h, bt, mb,
        float(scale), _build.stream_of(q))
    _build.check(err, "flash_decode_paged")
    launches["flash_decode_paged"] += 1
    return out
