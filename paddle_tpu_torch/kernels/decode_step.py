"""Fused decode step: one decoder layer for one token, two launches.

Counterpart of ``paddle_tpu/kernels/decode_step.py`` ``fused_decode_step``
and ``fused_decode_step_paged`` in their split-FFN mode, the mode the
reference's plans take at Transformer-base widths in f32:

* :func:`megastep` (``csrc/megastep.cu``, for ``_megastep_kernel``): qkv
  projection, the in-place k/v row write into the ring cache, the self
  and cross walks with their projections, residuals and layer norms;
* :func:`megastep_paged` (the same source's paged instantiation, for
  ``_paged_megastep_kernel``): the same over paged block pools, every row
  addressed through the block tables;
* :func:`ffn_epilogue` (``csrc/ffn.cu``, for ``_ffn_kernel``): the
  feed-forward, its residual and the last layer norm, after either.

The self cache is updated in place: the port's counterpart of the JAX
package's donated cache buffers.  The returned caches are the tensors
passed in.

The plain versions are :func:`reference_decode_step` and
:func:`reference_decode_step_paged`, the op chains of the reference's
compositions with ``kernels/decode_attention.py``'s plain walks as their
attention.
"""

from __future__ import annotations

import torch

from . import (KERNEL_D_HEAD, _build, composed, composes, head_route,
               launches)
from .decode_attention import reference_decode, reference_decode_paged
from ..ops.generation_ops import kv_cache_update, paged_kv_cache_update
from ..ops.nn_ops import layer_norm


def reference_megastep(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                       ln2_scale, ln2_bias, cache_k, cache_v, cross_k,
                       cross_v, pos, lengths, cross_lengths, active, *,
                       layer, n_head, scale, eps=1e-5):
    """Plain version of :func:`megastep`: the attention half of the
    decoder step.  Updates cache_k/cache_v in place; returns the
    layer-norm-2 output [b, 1, d_model]."""
    b = x.shape[0]
    dh = cache_k.shape[-1]
    hd = n_head * dh

    qkv = x @ wqkv
    q, k, v = torch.split(qkv, hd, dim=-1)
    kv_cache_update(cache_k, cache_v, k.reshape(b, 1, n_head, dh),
                    v.reshape(b, 1, n_head, dh), pos, layer, active)
    ctx = reference_decode(q.reshape(b, n_head, dh), cache_k[layer],
                           cache_v[layer], lengths, scale)
    x = layer_norm(x + ctx.reshape(b, 1, hd) @ wout, ln1_scale, ln1_bias,
                   eps)
    cq = x @ wcq
    cctx = reference_decode(cq.reshape(b, n_head, dh), cross_k[layer],
                            cross_v[layer], cross_lengths, scale)
    return layer_norm(x + cctx.reshape(b, 1, hd) @ wcout, ln2_scale,
                      ln2_bias, eps)


def reference_ffn(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale,
                  ln3_bias, eps=1e-5):
    """Plain version of :func:`ffn_epilogue`:
    LN3(x + relu(x W_in + b_in) W_out + b_out)."""
    hid = torch.relu(x @ ffn_in_w + ffn_in_b)
    return layer_norm(x + (hid @ ffn_out_w + ffn_out_b), ln3_scale,
                      ln3_bias, eps)


def reference_decode_step(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                          ln2_scale, ln2_bias, ffn_in_w, ffn_in_b,
                          ffn_out_w, ffn_out_b, ln3_scale, ln3_bias,
                          cache_k, cache_v, cross_k, cross_v, pos, lengths,
                          cross_lengths, active=None, *, layer, n_head,
                          scale, eps=1e-5):
    """The whole decoder step in plain PyTorch (the reference's
    composition).  Returns (out [b, 1, d_model], cache_k, cache_v)."""
    if active is None:
        active = torch.ones_like(pos)
    x = reference_megastep(
        x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
        ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
        cross_lengths, active, layer=layer, n_head=n_head, scale=scale,
        eps=eps)
    out = reference_ffn(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
                        ln3_scale, ln3_bias, eps)
    return out, cache_k, cache_v


def _megastep_spec(what, x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                   ln2_scale, ln2_bias, cache_k, cache_v, pos, lengths,
                   cross_lengths, active, n_head, layer):
    """The checks both megastep wrappers share: raise unless the kernel
    takes these widths on this device; return the tensor specs of
    :func:`_build.require` for the weights, the self cache and the int32
    vectors."""
    b, _, dm = x.shape
    n_layer, h, dh = cache_k.shape[0], cache_k.shape[-2], cache_k.shape[-1]
    if (x.device.type != "cuda" or h != n_head or dh != KERNEL_D_HEAD
            or dm % 4 or not 0 <= layer < n_layer):
        raise ValueError(
            f"{what}: no kernel for x {tuple(x.shape)}, cache "
            f"{tuple(cache_k.shape)}, n_head {n_head}, layer {layer} on "
            f"{x.device} (needs CUDA and d_head 64)")
    hd = h * dh
    f32, i32 = torch.float32, torch.int32
    vec = (dm,)
    return {
        "x": (x, f32, (b, 1, dm)), "wqkv": (wqkv, f32, (dm, 3 * hd)),
        "wout": (wout, f32, (hd, dm)), "ln1_scale": (ln1_scale, f32, vec),
        "ln1_bias": (ln1_bias, f32, vec), "wcq": (wcq, f32, (dm, hd)),
        "wcout": (wcout, f32, (hd, dm)), "ln2_scale": (ln2_scale, f32, vec),
        "ln2_bias": (ln2_bias, f32, vec),
        "cache_k": (cache_k, f32, cache_k.shape),
        "cache_v": (cache_v, f32, cache_k.shape),
        "pos": (pos, i32, (b,)), "lengths": (lengths, i32, (b,)),
        "cross_lengths": (cross_lengths, i32, (b,)),
        "active": (active, i32, (b,))}


def megastep(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
             ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
             cross_lengths, active, *, layer, n_head, scale, eps=1e-5):
    """The attention half of the decoder step (see module docstring).
    x [b, 1, d_model]; caches [L, b, rows, h, dh] (the self cache is
    written in place); pos/lengths/cross_lengths/active [b] int32.
    Returns [b, 1, d_model]."""
    args = (x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
            ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
            cross_lengths, active)
    if x.device.type == "cpu" or composes("megastep", cache_k.shape[-1]):
        return reference_megastep(*args, layer=layer, n_head=n_head,
                                  scale=scale, eps=eps)
    spec = _megastep_spec("megastep", *args[:11], *args[13:], n_head,
                          layer)
    b, _, dm = x.shape
    n_layer, _, max_t, h, dh = cache_k.shape
    cross_t = cross_k.shape[2]
    cross = (n_layer, b, cross_t, h, dh)
    spec.update(cross_k=(cross_k, torch.float32, cross),
                cross_v=(cross_v, torch.float32, cross))
    _build.require(spec, x.device, "megastep")
    out = torch.empty_like(x)
    err = _build.lib().ptt_megastep(
        *(a.data_ptr() for a in args), out.data_ptr(), layer, b, dm, h,
        max_t, cross_t, float(scale), float(eps), _build.stream_of(x))
    _build.check(err, "megastep")
    launches["megastep"] += 1
    return out


def reference_megastep_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                             ln2_scale, ln2_bias, cache_k, cache_v, cross_k,
                             cross_v, pos, lengths, cross_lengths,
                             self_table, cross_table, active, *, layer,
                             n_head, scale, eps=1e-5):
    """Plain version of :func:`megastep_paged`: the attention half of the
    reference's ``reference_decode_step_paged``.  Updates the self pools
    in place; returns the layer-norm-2 output [b, 1, d_model]."""
    b = x.shape[0]
    dh = cache_k.shape[-1]
    hd = n_head * dh

    qkv = x @ wqkv
    q, k, v = torch.split(qkv, hd, dim=-1)
    paged_kv_cache_update(cache_k, cache_v, k.reshape(b, 1, n_head, dh),
                          v.reshape(b, 1, n_head, dh), self_table, pos,
                          layer, active)
    ctx = reference_decode_paged(q.reshape(b, n_head, dh), cache_k[layer],
                                 cache_v[layer], self_table, lengths, scale)
    x = layer_norm(x + ctx.reshape(b, 1, hd) @ wout, ln1_scale, ln1_bias,
                   eps)
    cq = x @ wcq
    cctx = reference_decode_paged(cq.reshape(b, n_head, dh), cross_k[layer],
                                  cross_v[layer], cross_table,
                                  cross_lengths, scale)
    return layer_norm(x + cctx.reshape(b, 1, hd) @ wcout, ln2_scale,
                      ln2_bias, eps)


def megastep_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                   ln2_scale, ln2_bias, cache_k, cache_v, cross_k, cross_v,
                   pos, lengths, cross_lengths, self_table, cross_table,
                   active, *, layer, n_head, scale, eps=1e-5):
    """:func:`megastep` over paged caches.  cache_k/cache_v [L, num_blocks,
    block_t, h, dh] (written in place) and cross_k/cross_v [L,
    cross_num_blocks, cross_block_t, h, dh] pools; self_table/cross_table
    [b, max_blocks] int32 block ids.  A row at or past
    max_blocks * block_t is dropped, as the reference's composition drops
    it.  Returns [b, 1, d_model]."""
    args = (x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
            ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
            cross_lengths, self_table, cross_table, active)
    if x.device.type == "cpu" or composes("megastep_paged",
                                          cache_k.shape[-1]):
        return reference_megastep_paged(*args, layer=layer, n_head=n_head,
                                        scale=scale, eps=eps)
    spec = _megastep_spec("megastep_paged", *args[:11], *args[13:16],
                          active, n_head, layer)
    b, _, dm = x.shape
    n_layer, nb, bt, h, dh = cache_k.shape
    cnb, cbt = cross_k.shape[1:3]
    mb, cmb = self_table.shape[1], cross_table.shape[1]
    f32, i32 = torch.float32, torch.int32
    cross = (n_layer, cnb, cbt, h, dh)
    spec.update(cross_k=(cross_k, f32, cross), cross_v=(cross_v, f32, cross),
                self_table=(self_table, i32, (b, mb)),
                cross_table=(cross_table, i32, (b, cmb)))
    _build.require(spec, x.device, "megastep_paged")
    out = torch.empty_like(x)
    err = _build.lib().ptt_megastep_paged(
        *(a.data_ptr() for a in args), out.data_ptr(), layer, b, dm, h, nb,
        bt, mb, cnb, cbt, cmb, float(scale), float(eps),
        _build.stream_of(x))
    _build.check(err, "megastep_paged")
    launches["megastep_paged"] += 1
    return out


#: (device, stream handle) -> int32 tickets of the FFN kernel's last-block
#: reduction.  The kernel needs them zero on entry and leaves them zero, so
#: one buffer serves every launch that is ordered after the last one: the
#: launches of one stream.  Launches on two streams never share a buffer.
_tickets = {}


def _ticket_buffer(device, stream, n):
    buf = _tickets.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = buf
    return buf


def ffn_epilogue(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale,
                 ln3_bias, eps=1e-5):
    """LN3(x + relu(x W_in + b_in) W_out + b_out) over x [b, 1, d_model]."""
    if x.device.type == "cpu":
        return reference_ffn(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
                             ln3_scale, ln3_bias, eps)
    b, _, dm = x.shape
    di = ffn_in_w.shape[1]
    if x.device.type != "cuda" or dm % 4:
        raise ValueError(f"ffn_epilogue: no kernel for x {tuple(x.shape)} "
                         f"on {x.device}")
    f32, vec = torch.float32, (dm,)
    _build.require({
        "x": (x, f32, (b, 1, dm)), "ffn_in_w": (ffn_in_w, f32, (dm, di)),
        "ffn_in_b": (ffn_in_b, f32, (di,)),
        "ffn_out_w": (ffn_out_w, f32, (di, dm)),
        "ffn_out_b": (ffn_out_b, f32, vec),
        "ln3_scale": (ln3_scale, f32, vec), "ln3_bias": (ln3_bias, f32, vec)},
        x.device, "ffn_epilogue")
    lib = _build.lib()
    chunks, tiles = lib.ptt_ffn_chunks(di), lib.ptt_ffn_tiles(b)
    partial = torch.empty((chunks, b, dm), dtype=f32, device=x.device)
    stream = _build.stream_of(x)
    tickets = _ticket_buffer(x.device, stream, tiles)
    out = torch.empty_like(x)
    err = lib.ptt_ffn(
        x.data_ptr(), ffn_in_w.data_ptr(), ffn_in_b.data_ptr(),
        ffn_out_w.data_ptr(), ffn_out_b.data_ptr(), ln3_scale.data_ptr(),
        ln3_bias.data_ptr(), out.data_ptr(), partial.data_ptr(),
        tickets.data_ptr(), b, dm, di, float(eps), stream)
    _build.check(err, "ffn")
    launches["ffn"] += 1
    return out


def _ffn_route(x, d_head):
    """The FFN half of a decoder step: :func:`ffn_epilogue`, or on CUDA at
    a head width % 64 != 0 its plain version (counted), since there the
    reference's megastep plan declines the whole step, FFN included."""
    if x.device.type == "cuda" and head_route(d_head) == "composed":
        composed["ffn"] += 1
        return reference_ffn
    return ffn_epilogue


def fused_decode_step(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                      ln2_scale, ln2_bias, ffn_in_w, ffn_in_b, ffn_out_w,
                      ffn_out_b, ln3_scale, ln3_bias, cache_k, cache_v,
                      cross_k, cross_v, pos, lengths, cross_lengths,
                      active=None, *, layer, n_head, scale, eps=1e-5):
    """One decoder layer over a single embedded token, in the argument
    order of the reference's ``fused_decode_step``.  x [b, 1, d_model];
    wqkv [d_model, 3*h*dh]; wout/wcout [h*dh, d_model]; wcq
    [d_model, h*dh]; caches [L, b, rows, h, dh] (self cache updated in
    place); pos/lengths/cross_lengths [b] int32; active [b] 0/1 or None.
    Returns (out [b, 1, d_model], cache_k, cache_v)."""
    if active is None:
        active = torch.ones_like(pos)
    x = megastep(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
                 ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
                 cross_lengths, active, layer=layer, n_head=n_head,
                 scale=scale, eps=eps)
    out = _ffn_route(x, cache_k.shape[-1])(
        x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale, ln3_bias,
        eps)
    return out, cache_k, cache_v


def reference_decode_step_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq,
                                wcout, ln2_scale, ln2_bias, ffn_in_w,
                                ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale,
                                ln3_bias, cache_k, cache_v, cross_k,
                                cross_v, pos, lengths, cross_lengths,
                                self_table, cross_table, active=None, *,
                                layer, n_head, scale, eps=1e-5):
    """The whole decoder step over paged caches in plain PyTorch (the
    reference's ``reference_decode_step_paged``).  Returns
    (out [b, 1, d_model], cache_k, cache_v)."""
    if active is None:
        active = torch.ones_like(pos)
    x = reference_megastep_paged(
        x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
        ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
        cross_lengths, self_table, cross_table, active, layer=layer,
        n_head=n_head, scale=scale, eps=eps)
    out = reference_ffn(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
                        ln3_scale, ln3_bias, eps)
    return out, cache_k, cache_v


def fused_decode_step_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq,
                            wcout, ln2_scale, ln2_bias, ffn_in_w,
                            ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale,
                            ln3_bias, cache_k, cache_v, cross_k, cross_v,
                            pos, lengths, cross_lengths, self_table,
                            cross_table, active=None, *, layer, n_head,
                            scale, eps=1e-5):
    """One decoder layer over paged caches, in the argument order of the
    reference's ``fused_decode_step_paged``: :func:`megastep_paged`, then
    :func:`ffn_epilogue`.  Pools [L, num_blocks, block_t, h, dh] (the self
    pools updated in place); tables [b, max_blocks] int32.  Returns
    (out [b, 1, d_model], cache_k, cache_v)."""
    if active is None:
        active = torch.ones_like(pos)
    x = megastep_paged(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout,
                       ln2_scale, ln2_bias, cache_k, cache_v, cross_k,
                       cross_v, pos, lengths, cross_lengths, self_table,
                       cross_table, active, layer=layer, n_head=n_head,
                       scale=scale, eps=eps)
    out = _ffn_route(x, cache_k.shape[-1])(
        x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b, ln3_scale, ln3_bias,
        eps)
    return out, cache_k, cache_v
