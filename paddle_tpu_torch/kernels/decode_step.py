"""Fused decode step: one decoder layer for one token, two launches.

Counterpart of ``paddle_tpu/kernels/decode_step.py`` ``fused_decode_step``
in its split-FFN mode, the mode the reference's plan takes at
Transformer-base widths in f32:

* :func:`megastep` (``csrc/megastep.cu``, for ``_megastep_kernel``): qkv
  projection, the in-place k/v row write into the ring cache, the self
  and cross walks with their projections, residuals and layer norms;
* :func:`ffn_epilogue` (``csrc/ffn.cu``, for ``_ffn_kernel``): the
  feed-forward, its residual and the last layer norm.

The self cache is updated in place: the port's counterpart of the JAX
package's donated cache buffers.  The returned caches are the tensors
passed in.

The plain version is :func:`reference_decode_step`, the op chain of the
reference's ``reference_decode_step`` with :func:`reference_decode` as
its attention.
"""

from __future__ import annotations

import torch

from . import _build, launches
from ..ops.generation_ops import kv_cache_update
from ..ops.nn_ops import layer_norm

#: head width the CUDA kernels are compiled for
KERNEL_D_HEAD = 64


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


def megastep(x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
             ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
             cross_lengths, active, *, layer, n_head, scale, eps=1e-5):
    """The attention half of the decoder step (see module docstring).
    x [b, 1, d_model]; caches [L, b, rows, h, dh] (the self cache is
    written in place); pos/lengths/cross_lengths/active [b] int32.
    Returns [b, 1, d_model]."""
    if x.device.type == "cpu":
        return reference_megastep(
            x, wqkv, wout, ln1_scale, ln1_bias, wcq, wcout, ln2_scale,
            ln2_bias, cache_k, cache_v, cross_k, cross_v, pos, lengths,
            cross_lengths, active, layer=layer, n_head=n_head,
            scale=scale, eps=eps)
    b, _, dm = x.shape
    n_layer, _, max_t, h, dh = cache_k.shape
    cross_t = cross_k.shape[2]
    hd = h * dh
    if (x.device.type != "cuda" or h != n_head or dh != KERNEL_D_HEAD
            or dm % 4 or not 0 <= layer < n_layer):
        raise ValueError(
            f"megastep: no kernel for x {tuple(x.shape)}, cache "
            f"{tuple(cache_k.shape)}, n_head {n_head}, layer {layer} on "
            f"{x.device} (needs CUDA and d_head 64)")
    f32, i32 = torch.float32, torch.int32
    vec, cross = (dm,), (n_layer, b, cross_t, h, dh)
    _build.require({
        "x": (x, f32, (b, 1, dm)), "wqkv": (wqkv, f32, (dm, 3 * hd)),
        "wout": (wout, f32, (hd, dm)), "ln1_scale": (ln1_scale, f32, vec),
        "ln1_bias": (ln1_bias, f32, vec), "wcq": (wcq, f32, (dm, hd)),
        "wcout": (wcout, f32, (hd, dm)), "ln2_scale": (ln2_scale, f32, vec),
        "ln2_bias": (ln2_bias, f32, vec),
        "cache_k": (cache_k, f32, cache_k.shape),
        "cache_v": (cache_v, f32, cache_k.shape),
        "cross_k": (cross_k, f32, cross), "cross_v": (cross_v, f32, cross),
        "pos": (pos, i32, (b,)), "lengths": (lengths, i32, (b,)),
        "cross_lengths": (cross_lengths, i32, (b,)),
        "active": (active, i32, (b,))}, x.device, "megastep")
    out = torch.empty_like(x)
    err = _build.lib().ptt_megastep(
        x.data_ptr(), wqkv.data_ptr(), wout.data_ptr(),
        ln1_scale.data_ptr(), ln1_bias.data_ptr(), wcq.data_ptr(),
        wcout.data_ptr(), ln2_scale.data_ptr(), ln2_bias.data_ptr(),
        cache_k.data_ptr(), cache_v.data_ptr(), cross_k.data_ptr(),
        cross_v.data_ptr(), pos.data_ptr(), lengths.data_ptr(),
        cross_lengths.data_ptr(), active.data_ptr(), out.data_ptr(),
        layer, b, dm, h, max_t, cross_t, float(scale), float(eps),
        _build.stream_of(x))
    _build.check(err, "megastep")
    launches["megastep"] += 1
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
    out = ffn_epilogue(x, ffn_in_w, ffn_in_b, ffn_out_w, ffn_out_b,
                       ln3_scale, ln3_bias, eps)
    return out, cache_k, cache_v
