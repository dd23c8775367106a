"""The encoder-decoder Transformer on the serving path, as nn.Modules.

Counterpart of ``paddle_tpu/models/transformer.py`` as the generation
programs (``build_generation_programs``) run it with ``use_flash=True``
and the default flags, at inference (dropout 0):

* prefill: ``prepare_encoder`` (word + learned position tables), the
  encoder layers on the fused-qkv route with the "dan" post-process chain
  (add + layer norm at rate 0), ``_src_token_lengths`` and
  ``_prefill_cross_cache``;
* decode: the cached decoder step on the fused route, one
  ``fused_decode_step`` per layer, then ``predict_w``/``predict_b``.

Weights keep the reference's [in, out] layout, so the JAX package's
arrays load as they are (``interop.load_paddle_tpu_params``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.attention import flash_qkv_attention
from ..kernels.decode_step import fused_decode_step
from ..ops.generation_ops import kv_cache_update
from ..ops.nn_ops import layer_norm, lookup_table, mul

#: additive score bias of a padded source key (the reference's -1e9)
PAD_BIAS = -1e9


def _param(*shape, device):
    return nn.Parameter(torch.empty(shape, device=device),
                        requires_grad=False)


def prepare_encoder(word_ids, pos_ids, word_table, pos_table):
    """Word embedding plus the learned position table."""
    return lookup_table(word_table, word_ids) + lookup_table(pos_table,
                                                             pos_ids)


def positionwise_feed_forward(x, w_in, b_in, w_out, b_out):
    return mul(torch.relu(mul(x, w_in) + b_in), w_out) + b_out


def src_token_lengths(src_word):
    """[b, Ts] ids -> [b] int32: 1 + the last non-pad position (pad id 0),
    0 for an all-pad row (the reference's ``_src_token_lengths``)."""
    ts = src_word.shape[1]
    pos1 = torch.arange(1, ts + 1, device=src_word.device)
    return ((src_word != 0) * pos1).amax(dim=1).to(torch.int32)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, n_head, d_key, d_inner_hid, device):
        super().__init__()
        self.n_head, self.d_key = n_head, d_key
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

    def forward(self, x, attn_bias):
        attn = flash_qkv_attention(x, self.attn_qkv_w, self.attn_out_w,
                                   attn_bias, n_head=self.n_head,
                                   scale=self.d_key ** -0.5)
        x = layer_norm(attn + x, self.ln1_scale, self.ln1_bias)
        ffd = positionwise_feed_forward(x, self.ffn_in_w, self.ffn_in_b,
                                        self.ffn_out_w, self.ffn_out_b)
        return layer_norm(ffd + x, self.ln2_scale, self.ln2_bias)


class DecoderLayer(nn.Module):
    """One decoder layer's weights; ``cross_k_w``/``cross_v_w`` project
    the encoder output into this layer's cross cache at prefill."""

    def __init__(self, d_model, n_head, d_key, d_inner_hid, device):
        super().__init__()
        self.n_head, self.d_key = n_head, d_key
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

    def step(self, x, self_cache, cross_cache, pos, lengths, active,
             layer):
        """The cached decoder step of this layer over x [b, 1, d_model]."""
        out, _, _ = fused_decode_step(
            x, self.attn_qkv_w, self.attn_out_w, self.ln1_scale,
            self.ln1_bias, self.cross_q_w, self.cross_out_w, self.ln2_scale,
            self.ln2_bias, self.ffn_in_w, self.ffn_in_b, self.ffn_out_w,
            self.ffn_out_b, self.ln3_scale, self.ln3_bias, self_cache.k,
            self_cache.v, cross_cache.k, cross_cache.v, pos, lengths,
            cross_cache.lengths, active, layer=layer, n_head=self.n_head,
            scale=self.d_key ** -0.5)
        return out


class Transformer(nn.Module):
    """Encoder-decoder Transformer for generation.  Runs on CUDA unless
    ``device`` says otherwise; parameters are uninitialized until
    :meth:`init_params` or ``interop.load_paddle_tpu_params``."""

    def __init__(self, src_vocab_size=10000, trg_vocab_size=10000,
                 max_length=256, n_layer=6, n_head=8, d_key=64, d_value=64,
                 d_model=512, d_inner_hid=2048, device=None):
        super().__init__()
        if d_key != d_value:
            raise ValueError("Transformer: the fused serving route needs "
                             f"d_key == d_value, got {d_key}, {d_value}")
        device = resolve_device(device)
        self.n_layer, self.n_head, self.d_key = n_layer, n_head, d_key
        self.d_model, self.max_length = d_model, max_length
        self.trg_vocab_size = trg_vocab_size
        self.src_word_emb = _param(src_vocab_size, d_model, device=device)
        self.src_pos_enc = _param(max_length, d_model, device=device)
        self.encoder = nn.ModuleList(
            EncoderLayer(d_model, n_head, d_key, d_inner_hid, device)
            for _ in range(n_layer))
        self.trg_word_emb = _param(trg_vocab_size, d_model, device=device)
        self.trg_pos_enc = _param(max_length, d_model, device=device)
        self.decoder = nn.ModuleList(
            DecoderLayer(d_model, n_head, d_key, d_inner_hid, device)
            for _ in range(n_layer))
        self.predict_w = _param(d_model, trg_vocab_size, device=device)
        self.predict_b = _param(trg_vocab_size, device=device)

    @property
    def device(self):
        return self.predict_w.device

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

    def encode(self, src_word, src_pos, attn_bias):
        """src_word/src_pos [b, Ts] int64, attn_bias [b, 1, 1, Ts] ->
        encoder output [b, Ts, d_model]."""
        x = prepare_encoder(src_word[..., None], src_pos[..., None],
                            self.src_word_emb, self.src_pos_enc)
        for layer in self.encoder:
            x = layer(x, attn_bias)
        return x

    def prefill_cross_cache(self, enc_out, cross_cache, active):
        """Project enc_out into every layer's cross K/V and write them at
        row 0 of the active lanes' cache slots."""
        b, ts, _ = enc_out.shape
        zero = torch.zeros(b, dtype=torch.int32, device=enc_out.device)
        for i, layer in enumerate(self.decoder):
            k = mul(enc_out, layer.cross_k_w).reshape(b, ts, self.n_head,
                                                      self.d_key)
            v = mul(enc_out, layer.cross_v_w).reshape(b, ts, self.n_head,
                                                      self.d_key)
            kv_cache_update(cross_cache.k, cross_cache.v, k, v, zero,
                            layer=i, active=active)

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
                           active, i)
        return (mul(x, self.predict_w) + self.predict_b)[:, 0, :]
