"""The encoder-decoder Transformer, as nn.Modules, for serving and training.

Counterpart of ``paddle_tpu/models/transformer.py`` with ``use_flash=True``:

* training: ``transformer(...)``'s forward, :meth:`Transformer.forward`
  (word + learned position tables and their dropout, the encoder and
  decoder layers, the "dan" post-process chain as one fused
  ``dropout_add`` then the layer norm, the output projection and the
  weighted ``softmax_with_cross_entropy`` mean), with the biases of
  :func:`training_biases`.  Its self-attention sites take the route of
  the reference's ``FLAGS_fused_qkv_attention``: by default one
  ``flash_qkv_attention`` (#1 forward, #2 and #3 backward), or with
  ``fused_qkv_attention=False`` the q/k/v ``mul``,
  ``flash_attention(fmt="bthd")`` (#4, #6, #7) and the output ``mul``.
  Cross-attention takes the second form on both routes, as there;
* prefill, as the generation programs (``build_generation_programs``)
  run it: ``prepare_encoder``, the encoder layers on the fused-qkv route
  by default (``fused_qkv_attention=True``, the reference's default flag),
  ``_src_token_lengths`` and ``_prefill_cross_cache``;
* the hand-written self-attention of ``multi_head_attention`` with
  ``use_flash=False``, which BERT's default build spells out and the
  ``attention_fuse`` pass turns into ``fused_attention(fmt="bhtd")``:
  :class:`MultiHeadAttention`, which takes every route of that function;
* decode: ``cached_decoder_step``, then ``predict_w``/``predict_b``.  On
  the fused route (``fused_decode_step=True``, the reference's default
  ``FLAGS_fused_decode_step``) each layer is one ``fused_decode_step``
  (ring caches) or ``fused_decode_step_paged`` (paged caches); on the
  unfused route it is the reference's op chain: the qkv ``mul``, the cache
  write, ``decode_attention`` through the cache, the output ``mul``, the
  "dan" layer norm, cross-attention the same way and the feed-forward.
  There only the two attentions are kernels; the matmuls and the FFN are
  plain PyTorch, as the reference leaves them to XLA.

Both routes train and serve, with the same parameters.  Training
applies the reference's dropout (``dropout_rate``, 0.1 in ``transformer()``)
while the module is in training mode: at the two embedding sites
(``dropout``, kernel #16 without a residual), at every "dan" residual
(``dropout_add``, #16 and #17) and on the attention weights inside #1-#4,
#6 and #7.  Each of the 50 sites of Transformer-base
(:meth:`Transformer.dropout_sites`) takes one uint32 seed per step; the
same seeds give the reference's masks bit for bit.  ``model.eval()`` (the
reference's ``is_test``) and every serving entry point run without
dropout.

Weights keep the reference's [in, out] layout, and no choice changes
their names or shapes, so the JAX package's arrays load as they are
(``interop.load_paddle_tpu_params``).  Every parameter is trainable except
the position tables, which the reference declares ``trainable=False``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..kernels.attention import flash_attention, flash_qkv_attention
from ..kernels.decode_step import fused_decode_step, fused_decode_step_paged
from ..layers.contrib import fused_attention
from ..ops.nn_ops import (dropout, dropout_add, layer_norm, lookup_table,
                          mul, softmax_with_cross_entropy)

#: additive score bias of a padded key and of a future one (the
#: reference's -1e9)
PAD_BIAS = -1e9


def _param(*shape, device, trainable=True):
    return nn.Parameter(torch.empty(shape, device=device),
                        requires_grad=trainable)


def prepare_encoder(word_ids, pos_ids, word_table, pos_table):
    """Word embedding plus the learned position table."""
    return lookup_table(word_table, word_ids) + lookup_table(pos_table,
                                                             pos_ids)


def positionwise_feed_forward(x, w_in, b_in, w_out, b_out):
    return mul(torch.relu(mul(x, w_in) + b_in), w_out) + b_out


def _attend(q, k, v, w_out, bias, n_head, d_key, rate=0.0, seed=None):
    """The flag-off flash route's tail: q [b, tq, h*d], k/v [b, tk, h*d]
    as [b, t, h, d] (a view), ``flash_attention(fmt="bthd")`` (weights
    dropout at ``rate`` under ``seed``), the heads merged back and
    projected by w_out."""
    b, tq, hd = q.shape
    tk = k.shape[1]
    ctx = flash_attention(q.reshape(b, tq, n_head, d_key),
                          k.reshape(b, tk, n_head, d_key),
                          v.reshape(b, tk, n_head, d_key), bias,
                          scale=d_key ** -0.5, fmt="bthd",
                          dropout_rate=rate, dropout_seed=seed)
    return mul(ctx.reshape(b, tq, hd), w_out)


def self_attention(x, w_qkv, w_out, bias, n_head, d_key, fused, rate=0.0,
                   seed=None):
    """Self-attention of x [b, t, d_model]: one ``flash_qkv_attention``
    (#1) when ``fused``, else one ``mul`` by the packed w_qkv, split q|k|v,
    and :func:`_attend` (#4, #6, #7); weights dropout at ``rate`` under
    ``seed`` on either route."""
    if fused:
        return flash_qkv_attention(x, w_qkv, w_out, bias, n_head=n_head,
                                   scale=d_key ** -0.5, dropout_rate=rate,
                                   dropout_seed=seed)
    q, k, v = torch.split(mul(x, w_qkv), n_head * d_key, dim=-1)
    return _attend(q, k, v, w_out, bias, n_head, d_key, rate, seed)


class MultiHeadAttention(nn.Module):
    """A self-attention site of the reference's ``multi_head_attention``
    (queries = keys = values, d_key == d_value): the packed ``attn_qkv_w``
    [d_model, 3hd] and ``attn_out_w`` [hd, d_model], on the route the
    reference's build takes.

    * ``use_flash`` with ``fused_qkv_attention`` (the reference's default
      flag): one ``flash_qkv_attention`` (#1, #2, #3);
    * ``use_flash`` with the flag off: :func:`self_attention`'s projections
      around ``flash_attention(fmt="bthd")`` (#4, #6, #7);
    * without ``use_flash``, the reference's hand-written attention: the
      qkv ``mul``, split, the split-head transpose to [b, h, t, d],
      ``matmul(q, k^T) * d_key^-0.5``, the bias added, ``softmax``, the
      weights ``dropout`` (upscale_in_train over the flat [b, h, t, t]
      index: ``keep_mask``, kernel #16 without a residual), ``matmul``
      with v, the head merge and the output ``mul``;
    * the same once :func:`paddle_tpu_torch.passes.attention_fuse` has set
      :attr:`attention_fused`: the matmul-to-matmul chain becomes one
      ``layers.contrib.fused_attention(fmt="bhtd")`` (#5, #8, #9) with the
      dropout in the kernels (``keep_mask_attn``), as the reference's
      ``attention_fuse`` pass rewrites it.

    Every route takes one dropout seed per step (:meth:`forward`)."""

    def __init__(self, d_model, n_head, d_key, device, use_flash=False,
                 fused_qkv_attention=True):
        super().__init__()
        self.n_head, self.d_key = n_head, d_key
        self.use_flash = bool(use_flash)
        self.fused_qkv_attention = bool(fused_qkv_attention)
        #: set by ``passes.attention_fuse`` on a hand-written site
        self.attention_fused = False
        hd = n_head * d_key
        self.attn_qkv_w = _param(d_model, 3 * hd, device=device)
        self.attn_out_w = _param(hd, d_model, device=device)

    def forward(self, x, bias, rate=0.0, seed=None):
        """Self-attention of x [b, t, d_model] under the additive bias
        (broadcast to [b, 1|h, 1|t, t]); the attention weights dropped at
        ``rate`` under ``seed`` on every route."""
        if self.use_flash:
            return self_attention(x, self.attn_qkv_w, self.attn_out_w, bias,
                                  self.n_head, self.d_key,
                                  self.fused_qkv_attention, rate, seed)
        b, t, _ = x.shape
        h, d = self.n_head, self.d_key

        def split_heads(a):
            return a.reshape(b, t, h, d).transpose(1, 2)

        q, k, v = (split_heads(a) for a in torch.split(
            mul(x, self.attn_qkv_w), h * d, dim=-1))
        if self.attention_fused:
            ctx = fused_attention(q, k, v, bias, scale=d ** -0.5,
                                  dropout_rate=rate, dropout_seed=seed)
        else:
            product = (q @ k.transpose(-1, -2)) * d ** -0.5
            if bias is not None:
                product = product + bias
            weights = dropout(torch.softmax(product, dim=-1), rate, seed)
            ctx = weights @ v
        return mul(ctx.transpose(1, 2).reshape(b, t, h * d), self.attn_out_w)


def pad_bias(word):
    """[b, t] ids -> the key-padding bias [b, 1, 1, t]: -1e9 at pad id 0."""
    b, t = word.shape
    return (PAD_BIAS * (word == 0).float()).reshape(b, 1, 1, t)


def training_biases(src_word, trg_word, trg_pos):
    """The training step's additive biases from the fed [b, t] ids and
    positions, made on the device as ``transformer(device_biases=True)``
    makes them: (the source key-padding bias [b, 1, 1, ts] of the encoder
    and of the cross-attention, the decoder's causal-plus-padding bias
    [b, 1, tt, tt]), -1e9 where masked."""
    b, tt = trg_word.shape
    future = (trg_pos[:, :, None] < trg_pos[:, None, :]).float()
    return (pad_bias(src_word),
            (PAD_BIAS * future).reshape(b, 1, tt, tt) + pad_bias(trg_word))


def src_token_lengths(src_word):
    """[b, Ts] ids -> [b] int32: 1 + the last non-pad position (pad id 0),
    0 for an all-pad row (the reference's ``_src_token_lengths``)."""
    ts = src_word.shape[1]
    pos1 = torch.arange(1, ts + 1, device=src_word.device)
    return ((src_word != 0) * pos1).amax(dim=1).to(torch.int32)


class EncoderLayer(nn.Module):
    """One encoder layer.  ``fused_qkv_attention`` picks its attention
    route (the reference's ``FLAGS_fused_qkv_attention``): #1, or the
    flag-off projections around the bthd flash kernels."""

    #: its dropout sites, in the reference program's op order
    SITES = ("attn", "attn_dropout_add", "ffn_dropout_add")

    def __init__(self, d_model, n_head, d_key, d_inner_hid, device,
                 fused_qkv_attention=True):
        super().__init__()
        self.n_head, self.d_key = n_head, d_key
        self.fused_qkv_attention = bool(fused_qkv_attention)
        hd = n_head * d_key
        self.attn_qkv_w = _param(d_model, 3 * hd, device=device)
        self.attn_out_w = _param(hd, d_model, device=device)
        self.ln1_scale = _param(d_model, device=device)
        self.ln1_bias = _param(d_model, device=device)
        self.ffn_in_w = _param(d_model, d_inner_hid, device=device)
        self.ffn_in_b = _param(d_inner_hid, device=device)
        self.ffn_out_w = _param(d_inner_hid, d_model, device=device)
        self.ffn_out_b = _param(d_model, device=device)
        self.ln2_scale = _param(d_model, device=device)
        self.ln2_bias = _param(d_model, device=device)

    def forward(self, x, attn_bias, rate=0.0, seeds=(None,) * 3):
        """The reference's ``encoder_layer``: self-attention, then each
        "dan" post-process as ``layer_norm(dropout_add(out, x))``; dropout
        at ``rate`` with one seed per site of :attr:`SITES`."""
        attn = self_attention(x, self.attn_qkv_w, self.attn_out_w, attn_bias,
                              self.n_head, self.d_key,
                              self.fused_qkv_attention, rate, seeds[0])
        x = layer_norm(dropout_add(attn, x, rate, seeds[1]), self.ln1_scale,
                       self.ln1_bias)
        ffd = positionwise_feed_forward(x, self.ffn_in_w, self.ffn_in_b,
                                        self.ffn_out_w, self.ffn_out_b)
        return layer_norm(dropout_add(ffd, x, rate, seeds[2]),
                          self.ln2_scale, self.ln2_bias)


class DecoderLayer(nn.Module):
    """One decoder layer: :meth:`forward` over a whole target sequence
    (training), :meth:`step` over one cached token (serving).
    ``cross_k_w``/``cross_v_w`` project the encoder output; at serving
    they fill this layer's cross cache at prefill."""

    #: its dropout sites, in the reference program's op order
    SITES = ("self_attn", "self_dropout_add", "cross_attn",
             "cross_dropout_add", "ffn_dropout_add")

    def __init__(self, d_model, n_head, d_key, d_inner_hid, device,
                 fused_qkv_attention=True):
        super().__init__()
        self.n_head, self.d_key = n_head, d_key
        self.fused_qkv_attention = bool(fused_qkv_attention)
        hd = n_head * d_key
        self.attn_qkv_w = _param(d_model, 3 * hd, device=device)
        self.attn_out_w = _param(hd, d_model, device=device)
        self.ln1_scale = _param(d_model, device=device)
        self.ln1_bias = _param(d_model, device=device)
        self.cross_q_w = _param(d_model, hd, device=device)
        self.cross_out_w = _param(hd, d_model, device=device)
        self.ln2_scale = _param(d_model, device=device)
        self.ln2_bias = _param(d_model, device=device)
        self.ffn_in_w = _param(d_model, d_inner_hid, device=device)
        self.ffn_in_b = _param(d_inner_hid, device=device)
        self.ffn_out_w = _param(d_inner_hid, d_model, device=device)
        self.ffn_out_b = _param(d_model, device=device)
        self.ln3_scale = _param(d_model, device=device)
        self.ln3_bias = _param(d_model, device=device)
        self.cross_k_w = _param(d_model, hd, device=device)
        self.cross_v_w = _param(d_model, hd, device=device)

    def forward(self, x, enc_out, slf_bias, cross_bias, rate=0.0,
                seeds=(None,) * 5):
        """The reference's ``decoder_layer`` over x [b, tt, d_model]:
        self-attention under slf_bias [b, 1, tt, tt], cross-attention to
        enc_out [b, ts, d_model] under cross_bias [b, 1, 1, ts], the
        feed-forward, each followed by ``layer_norm(dropout_add(out, x))``;
        dropout at ``rate`` with one seed per site of :attr:`SITES`."""
        attn = self_attention(x, self.attn_qkv_w, self.attn_out_w, slf_bias,
                              self.n_head, self.d_key,
                              self.fused_qkv_attention, rate, seeds[0])
        x = layer_norm(dropout_add(attn, x, rate, seeds[1]), self.ln1_scale,
                       self.ln1_bias)
        cross = _attend(mul(x, self.cross_q_w), mul(enc_out, self.cross_k_w),
                        mul(enc_out, self.cross_v_w), self.cross_out_w,
                        cross_bias, self.n_head, self.d_key, rate, seeds[2])
        x = layer_norm(dropout_add(cross, x, rate, seeds[3]),
                       self.ln2_scale, self.ln2_bias)
        ffd = positionwise_feed_forward(x, self.ffn_in_w, self.ffn_in_b,
                                        self.ffn_out_w, self.ffn_out_b)
        return layer_norm(dropout_add(ffd, x, rate, seeds[4]),
                          self.ln3_scale, self.ln3_bias)

    def step(self, x, self_cache, cross_cache, pos, lengths, active,
             layer, fused=True):
        """The cached decoder step of this layer over x [b, 1, d_model]:
        one fused step (ring or paged by the caches' type), or the
        unfused op chain when ``fused`` is False."""
        scale = self.d_key ** -0.5
        if not fused:
            return self._unfused_step(x, self_cache, cross_cache, pos,
                                      lengths, active, layer, scale)
        weights = (self.attn_qkv_w, self.attn_out_w, self.ln1_scale,
                   self.ln1_bias, self.cross_q_w, self.cross_out_w,
                   self.ln2_scale, self.ln2_bias, self.ffn_in_w,
                   self.ffn_in_b, self.ffn_out_w, self.ffn_out_b,
                   self.ln3_scale, self.ln3_bias)
        caches = (self_cache.k, self_cache.v, cross_cache.k, cross_cache.v,
                  pos, lengths, cross_cache.lengths)
        kw = dict(layer=layer, n_head=self.n_head, scale=scale)
        if hasattr(self_cache, "table"):  # paged caches carry a table
            out, _, _ = fused_decode_step_paged(
                x, *weights, *caches, self_cache.table, cross_cache.table,
                active, **kw)
        else:
            out, _, _ = fused_decode_step(x, *weights, *caches, active,
                                          **kw)
        return out

    def _unfused_step(self, x, self_cache, cross_cache, pos, lengths,
                      active, layer, scale):
        """The reference's flag-off ``cached_decoder_step`` chain."""
        b = x.shape[0]
        heads = (b, 1, self.n_head, self.d_key)
        q, k, v = torch.split(mul(x, self.attn_qkv_w),
                              self.n_head * self.d_key, dim=-1)
        self_cache.write(k.reshape(heads), v.reshape(heads), pos, layer,
                         active)
        ctx = self_cache.attend(q.reshape(heads), lengths, layer, scale)
        x = layer_norm(x + mul(ctx.reshape(b, 1, -1), self.attn_out_w),
                       self.ln1_scale, self.ln1_bias)
        cq = mul(x, self.cross_q_w)
        cctx = cross_cache.attend(cq.reshape(heads), cross_cache.lengths,
                                  layer, scale)
        x = layer_norm(x + mul(cctx.reshape(b, 1, -1), self.cross_out_w),
                       self.ln2_scale, self.ln2_bias)
        ffd = positionwise_feed_forward(x, self.ffn_in_w, self.ffn_in_b,
                                        self.ffn_out_w, self.ffn_out_b)
        return layer_norm(x + ffd, self.ln3_scale, self.ln3_bias)


def paddle_tpu_param_names(n_layer: int):
    """[(reference parameter name, port parameter path)] of a Transformer of
    ``n_layer`` layers, in the generation programs' draw order: the
    prefill program's, then the decode program's."""
    pairs = [("src_word_emb_table", "src_word_emb"),
             ("src_pos_enc_table", "src_pos_enc")]

    def ln(index, path):
        return [(f"layer_norm_{index}.w_0", f"{path}_scale"),
                (f"layer_norm_{index}.b_0", f"{path}_bias")]

    for i in range(n_layer):
        enc = f"encoder.{i}."
        pairs += [(f"attn_qkv_w_{i}", enc + "attn_qkv_w"),
                  (f"attn_out_w_{i}", enc + "attn_out_w"),
                  *ln(2 * i, enc + "ln1"),
                  (f"ffn_in_w_{i}", enc + "ffn_in_w"),
                  (f"ffn_in_b_{i}", enc + "ffn_in_b"),
                  (f"ffn_out_w_{i}", enc + "ffn_out_w"),
                  (f"ffn_out_b_{i}", enc + "ffn_out_b"),
                  *ln(2 * i + 1, enc + "ln2")]
    for i in range(n_layer):
        pairs += [(f"attn_k_w_{i}", f"decoder.{i}.cross_k_w"),
                  (f"attn_v_w_{i}", f"decoder.{i}.cross_v_w")]
    pairs += [("trg_word_emb_table", "trg_word_emb"),
              ("trg_pos_enc_table", "trg_pos_enc")]
    L = n_layer
    for i in range(n_layer):
        dec = f"decoder.{i}."
        pairs += [(f"attn_qkv_w_{L + i}", dec + "attn_qkv_w"),
                  (f"attn_out_w_{L + 2 * i}", dec + "attn_out_w"),
                  *ln(2 * L + 3 * i, dec + "ln1"),
                  (f"attn_q_w_{i}", dec + "cross_q_w"),
                  (f"attn_out_w_{L + 2 * i + 1}", dec + "cross_out_w"),
                  *ln(2 * L + 3 * i + 1, dec + "ln2"),
                  (f"ffn_in_w_{L + i}", dec + "ffn_in_w"),
                  (f"ffn_in_b_{L + i}", dec + "ffn_in_b"),
                  (f"ffn_out_w_{L + i}", dec + "ffn_out_w"),
                  (f"ffn_out_b_{L + i}", dec + "ffn_out_b"),
                  *ln(2 * L + 3 * i + 2, dec + "ln3")]
    pairs += [("predict_w", "predict_w"), ("predict_b", "predict_b")]
    return pairs


class Transformer(nn.Module):
    """Encoder-decoder Transformer for training and generation.  Runs on
    CUDA unless ``device`` says otherwise; parameters are uninitialized
    until :meth:`init_params` or ``interop.load_paddle_tpu_params``.
    ``fused_qkv_attention`` picks the self-attention route (the
    reference's ``FLAGS_fused_qkv_attention``), ``fused_decode_step`` the
    decoder step's (its ``FLAGS_fused_decode_step``).  ``dropout_rate`` is
    the reference's training dropout, applied by :meth:`forward` in
    training mode (``model.train()``, the default) and never by
    ``model.eval()`` or the serving entry points."""

    def __init__(self, src_vocab_size=10000, trg_vocab_size=10000,
                 max_length=256, n_layer=6, n_head=8, d_key=64, d_value=64,
                 d_model=512, d_inner_hid=2048, device=None,
                 fused_decode_step=True, fused_qkv_attention=True,
                 dropout_rate=0.0):
        super().__init__()
        if d_key != d_value:
            raise ValueError("Transformer: the cached decoder step needs "
                             f"d_key == d_value, got {d_key}, {d_value}")
        device = resolve_device(device)
        self.fused_decode_step = bool(fused_decode_step)
        self.dropout_rate = float(dropout_rate)
        self.n_layer, self.n_head, self.d_key = n_layer, n_head, d_key
        self.d_model, self.max_length = d_model, max_length
        self.trg_vocab_size = trg_vocab_size
        layer_kw = dict(device=device,
                        fused_qkv_attention=fused_qkv_attention)
        self.src_word_emb = _param(src_vocab_size, d_model, device=device)
        self.src_pos_enc = _param(max_length, d_model, device=device,
                                  trainable=False)
        self.encoder = nn.ModuleList(
            EncoderLayer(d_model, n_head, d_key, d_inner_hid, **layer_kw)
            for _ in range(n_layer))
        self.trg_word_emb = _param(trg_vocab_size, d_model, device=device)
        self.trg_pos_enc = _param(max_length, d_model, device=device,
                                  trainable=False)
        self.decoder = nn.ModuleList(
            DecoderLayer(d_model, n_head, d_key, d_inner_hid, **layer_kw)
            for _ in range(n_layer))
        self.predict_w = _param(d_model, trg_vocab_size, device=device)
        self.predict_b = _param(trg_vocab_size, device=device)

    @property
    def device(self):
        return self.predict_w.device

    def paddle_tpu_named_parameters(self):
        """[(reference name, parameter)] in :func:`paddle_tpu_param_names`'s
        order: the names the reference's scope gives these weights."""
        return [(name, self.get_parameter(path))
                for name, path in paddle_tpu_param_names(self.n_layer)]

    @torch.no_grad()
    def init_params(self, seed=0):
        """Seeded random weights, drawn on the CPU from a torch.Generator
        so every device gets the same numbers: embedding tables
        N(0, d_model^-0.5), matrices Xavier-uniform, biases 0, layer-norm
        scales 1."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith(("_emb", "_enc")):
                w = torch.randn(p.shape, generator=gen) * self.d_model ** -0.5
            elif leaf.endswith("_scale"):
                w = torch.ones(p.shape)
            elif p.dim() == 1:
                w = torch.zeros(p.shape)
            else:
                limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                w = (torch.rand(p.shape, generator=gen) * 2 - 1) * limit
            p.copy_(w)
        return self

    def dropout_sites(self):
        """The names of the dropout sites, one seed each, in the reference
        training program's op order (the order its ``rng_id``s are drawn):
        the source embedding, each encoder layer's
        :attr:`EncoderLayer.SITES`, the target embedding, each decoder
        layer's :attr:`DecoderLayer.SITES`; 50 for 6 + 6 layers."""
        sites = ["src_emb_dropout"]
        for i in range(self.n_layer):
            sites += [f"encoder.{i}.{s}" for s in EncoderLayer.SITES]
        sites.append("trg_emb_dropout")
        for i in range(self.n_layer):
            sites += [f"decoder.{i}.{s}" for s in DecoderLayer.SITES]
        return sites

    def _seeds(self, dropout_seeds, generator):
        """One host int per site: the given seeds, or uint32s drawn on the
        CPU from ``generator`` (torch's default generator when None)."""
        n = len(self.dropout_sites())
        if dropout_seeds is None:
            dropout_seeds = torch.randint(0, 2 ** 32, (n,), dtype=torch.int64,
                                          generator=generator).tolist()
        seeds = [int(s) & 0xFFFFFFFF for s in dropout_seeds]
        if len(seeds) != n:
            raise ValueError(f"Transformer: {len(seeds)} dropout seeds for "
                             f"{n} dropout sites")
        return seeds

    def forward(self, src_word, src_pos, trg_word, trg_pos, lbl_word,
                lbl_weight, dropout_seeds=None, generator=None):
        """The training step's forward: ids [b, t] or [b, t, 1] (pad id
        0), lbl_weight [b, tt] or [b, tt, 1] f32.  Returns (avg_cost,
        predict): the lbl_weight-weighted mean of the per-token
        ``softmax_with_cross_entropy`` (weighted sum over weight sum, a
        0-dim tensor) and the logits [b, tt, trg_vocab].

        In training mode with ``dropout_rate`` > 0 every site of
        :meth:`dropout_sites` drops with its uint32 seed from
        ``dropout_seeds`` (a sequence in that order, e.g.
        ``interop.dropout_seeds`` of the reference's step key), or, when
        none are given, with seeds drawn on the host from ``generator``.
        The seeds reach the kernels as host scalars."""
        b = src_word.shape[0]
        src_word, src_pos, trg_word, trg_pos = (
            a.reshape(b, -1) for a in (src_word, src_pos, trg_word, trg_pos))
        src_bias, trg_bias = training_biases(src_word, trg_word, trg_pos)
        rate = self.dropout_rate if self.training else 0.0
        seeds = iter(self._seeds(dropout_seeds, generator) if rate
                     else [None] * len(self.dropout_sites()))

        def take(n):
            return tuple(next(seeds) for _ in range(n))

        enc_out = self.encode(src_word, src_pos, src_bias, rate, take(
            1 + self.n_layer * len(EncoderLayer.SITES)))
        x = dropout(prepare_encoder(trg_word, trg_pos, self.trg_word_emb,
                                    self.trg_pos_enc), rate, *take(1))
        for layer in self.decoder:
            x = layer(x, enc_out, trg_bias, src_bias, rate,
                      take(len(DecoderLayer.SITES)))
        predict = mul(x, self.predict_w) + self.predict_b
        cost = softmax_with_cross_entropy(
            predict.reshape(-1, self.trg_vocab_size), lbl_word.reshape(-1, 1))
        w = lbl_weight.reshape(-1, 1).float()
        return (cost * w).sum() / w.sum(), predict

    def encode(self, src_word, src_pos, attn_bias, rate=0.0, seeds=None):
        """src_word/src_pos [b, Ts] int64, attn_bias [b, 1, 1, Ts] ->
        encoder output [b, Ts, d_model].  Prefill runs it without dropout;
        training passes ``rate`` and the seeds of the source embedding and
        the encoder layers' sites, in :meth:`dropout_sites` order."""
        n = len(EncoderLayer.SITES)
        seeds = seeds or (None,) * (1 + self.n_layer * n)
        x = dropout(prepare_encoder(src_word[..., None], src_pos[..., None],
                                    self.src_word_emb, self.src_pos_enc),
                    rate, seeds[0])
        for i, layer in enumerate(self.encoder):
            x = layer(x, attn_bias, rate, seeds[1 + i * n:1 + (i + 1) * n])
        return x

    def prefill_cross_cache(self, enc_out, cross_cache, active):
        """Project enc_out into every layer's cross K/V and write them
        through the cache (ring or paged) at row 0 of the active lanes'
        slots."""
        b, ts, _ = enc_out.shape
        zero = torch.zeros(b, dtype=torch.int32, device=enc_out.device)
        for i, layer in enumerate(self.decoder):
            k = mul(enc_out, layer.cross_k_w).reshape(b, ts, self.n_head,
                                                      self.d_key)
            v = mul(enc_out, layer.cross_v_w).reshape(b, ts, self.n_head,
                                                      self.d_key)
            cross_cache.write(k, v, zero, i, active)

    def decode_logits(self, token, self_cache, cross_cache, lengths,
                      active):
        """One cached decoder step: token [b] int64 at position
        self_cache.lengths; lengths [b] int32 rows each walk attends.
        Returns logits [b, trg_vocab]."""
        pos = self_cache.lengths
        x = prepare_encoder(token.reshape(-1, 1, 1), pos.reshape(-1, 1, 1),
                            self.trg_word_emb, self.trg_pos_enc)
        for i, layer in enumerate(self.decoder):
            x = layer.step(x, self_cache, cross_cache, pos, lengths,
                           active, i, fused=self.fused_decode_step)
        return (mul(x, self.predict_w) + self.predict_b)[:, 0, :]


def make_batch(batch_size, src_len, trg_len, n_head, src_vocab, trg_vocab,
               rng=None):
    """Synthetic padded batch as numpy arrays, a copy of the reference's
    ``make_batch`` with ``device_biases=True``: ids [b, t, 1] int64 in
    [1, vocab), positions 0..t-1, lbl_weight [b, tt, 1] of ones; the model
    makes the attention biases on the device (``n_head`` is unused, as
    there)."""
    del n_head
    rng = rng or np.random.RandomState(0)

    def pos(n, t):
        return np.tile(np.arange(t, dtype=np.int64)[None, :, None], (n, 1, 1))

    return {
        "src_word": rng.randint(1, src_vocab,
                                (batch_size, src_len, 1)).astype("int64"),
        "src_pos": pos(batch_size, src_len),
        "trg_word": rng.randint(1, trg_vocab,
                                (batch_size, trg_len, 1)).astype("int64"),
        "trg_pos": pos(batch_size, trg_len),
        "lbl_word": rng.randint(1, trg_vocab,
                                (batch_size, trg_len, 1)).astype("int64"),
        "lbl_weight": np.ones((batch_size, trg_len, 1), "float32"),
    }
