"""BERT masked-LM pretraining, as nn.Modules.

Counterpart of ``paddle_tpu/models/bert.py``: ``bert_encoder_layer``,
``bert_encoder`` and ``build_pretrain_net`` (:class:`BertPretrain`), and
``make_batch``.  The encoder sums the word, position and sentence
embeddings (dense gradients, as the reference's ``embedding`` gives
them), normalizes and drops them, and builds the attention bias
``mask * 1e9 - 1e9`` of the [B, T, 1] input mask as [B, 1, 1, T] (no
gradient).  Each layer is self-attention, the dropout-add and layer
norm, an fc with the exact gelu, an fc, the dropout-add and layer norm.
The head is an fc to the vocabulary and the weighted masked-LM loss.

The attention sites take the reference's routes
(:class:`~paddle_tpu_torch.models.transformer.MultiHeadAttention`): by
default (``use_flash=False``, the reference's default build) the
hand-written composition, which :func:`paddle_tpu_torch.passes.
attention_fuse` turns into ``fused_attention(fmt="bhtd")`` (#5, #8, #9);
with ``use_flash`` the fused-qkv kernels (#1-#3) or, with
``fused_qkv_attention=False``, the bthd ones (#4, #6, #7).  The
dropout-add sites run #16 and #17, as the reference's default
``FLAGS_fused_dropout_add`` does.

Dropout (``dropout_rate``, training mode only) takes one uint32 seed per
site and step, in :meth:`BertPretrain.dropout_sites` order: the order in
which the reference's program draws its ``rng_id``s, so that
``interop.dropout_seeds(key_data, sorted(rng_ids))`` gives the
reference's masks.  Parameters keep the reference's [in, out] layouts and
load by its names (``interop.load_paddle_tpu_bert_params``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from .. import amp
from ..device import resolve_device
from ..ops.nn_ops import (dropout, dropout_add, fc, layer_norm, lookup_table,
                          masked_lm_loss)
from .transformer import MultiHeadAttention, _param

#: the sentence-type vocabulary (``bert_encoder``'s type_vocab_size)
TYPE_VOCAB_SIZE = 2


class BertEncoderLayer(nn.Module):
    """``bert_encoder_layer``: self-attention, then ``layer_norm(
    dropout_add(attn, x))``, the gelu fc and the fc, then ``layer_norm(
    dropout_add(ffn, x))``."""

    #: its dropout sites, in the order of the reference's ops
    SITES = ("attn", "attn_dropout_add", "ffn_dropout_add")

    def __init__(self, d_model, n_head, d_ff, device, use_flash=False,
                 fused_qkv_attention=True):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, n_head, d_model // n_head,
                                       device, use_flash,
                                       fused_qkv_attention)
        self.ln1_scale = _param(d_model, device=device)
        self.ln1_bias = _param(d_model, device=device)
        self.ffn_in_w = _param(d_model, d_ff, device=device)
        self.ffn_in_b = _param(d_ff, device=device)
        self.ffn_out_w = _param(d_ff, d_model, device=device)
        self.ffn_out_b = _param(d_model, device=device)
        self.ln2_scale = _param(d_model, device=device)
        self.ln2_bias = _param(d_model, device=device)

    def forward(self, x, attn_bias, rate=0.0, seeds=(None,) * 3):
        """x [b, t, d_model]; dropout at ``rate`` with one seed per site of
        :attr:`SITES`."""
        attn = self.attn(x, attn_bias, rate, seeds[0])
        x = layer_norm(dropout_add(attn, x, rate, seeds[1]), self.ln1_scale,
                       self.ln1_bias)
        ff = fc(fc(x, self.ffn_in_w, self.ffn_in_b, act="gelu"),
                self.ffn_out_w, self.ffn_out_b)
        return layer_norm(dropout_add(ff, x, rate, seeds[2]), self.ln2_scale,
                          self.ln2_bias)


class BertEncoder(nn.Module):
    """``bert_encoder``: the word, position and sentence embeddings summed
    (dense gradients), layer-normed and dropped, then the layers under the
    input mask's attention bias.  ``max_position`` is the position
    table's height (``build_pretrain_net`` passes seq_len)."""

    def __init__(self, vocab_size=30522, max_position=512, n_layer=12,
                 n_head=12, d_model=768, d_ff=3072, use_flash=False,
                 fused_qkv_attention=True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.word_embedding = _param(vocab_size, d_model, device=device)
        self.pos_embedding = _param(max_position, d_model, device=device)
        self.sent_embedding = _param(TYPE_VOCAB_SIZE, d_model, device=device)
        self.emb_ln_scale = _param(d_model, device=device)
        self.emb_ln_bias = _param(d_model, device=device)
        self.layers = nn.ModuleList(
            BertEncoderLayer(d_model, n_head, d_ff, device, use_flash,
                             fused_qkv_attention) for _ in range(n_layer))

    def forward(self, src_ids, pos_ids, sent_ids, input_mask, rate=0.0,
                seeds=None):
        """ids [b, t, 1] (or [b, t]) int64 and input_mask [b, t, 1] f32 (1
        valid, 0 padded) -> [b, t, d_model].  ``seeds``: {site name: seed}
        for ``emb_dropout`` and each layer's sites (``layers.<i>.<site>``),
        used at ``rate`` > 0."""
        b, t = src_ids.shape[:2]
        seeds = seeds or {}
        x = (lookup_table(self.word_embedding, src_ids)
             + lookup_table(self.pos_embedding, pos_ids)
             + lookup_table(self.sent_embedding, sent_ids))
        x = dropout(layer_norm(x, self.emb_ln_scale, self.emb_ln_bias), rate,
                    seeds.get("emb_dropout"))
        # (mask * 1e9 - 1e9) as [b, 1, 1, t]: 0 where valid, -1e9 on pads
        bias = (input_mask.reshape(b, 1, 1, t).to(x.dtype) * 1e9
                + (-1e9)).detach()
        for i, layer in enumerate(self.layers):
            x = layer(x, bias, rate, [seeds.get(f"layers.{i}.{s}")
                                      for s in BertEncoderLayer.SITES])
        return x


def bert_param_names(n_layer: int):
    """[(reference parameter name, port parameter path)] of a BertPretrain
    of ``n_layer`` layers, in ``build_pretrain_net``'s draw order.  Every
    route draws the same names: each layer's qkv and output projections
    take an ``fc`` name of their own (``fc_{4i}``, ``fc_{4i+1}``) besides
    their explicit ``attn_qkv_w_i`` and ``attn_out_w_i``, so the FFN's fcs
    are ``fc_{4i+2}`` and ``fc_{4i+3}`` and the head's ``fc_{4L}``."""
    enc = "encoder."
    pairs = [("word_embedding", enc + "word_embedding"),
             ("pos_embedding", enc + "pos_embedding"),
             ("sent_embedding", enc + "sent_embedding"),
             ("layer_norm_0.w_0", enc + "emb_ln_scale"),
             ("layer_norm_0.b_0", enc + "emb_ln_bias")]
    for i in range(n_layer):
        layer = f"{enc}layers.{i}."
        pairs += [(f"attn_qkv_w_{i}", layer + "attn.attn_qkv_w"),
                  (f"attn_out_w_{i}", layer + "attn.attn_out_w"),
                  (f"layer_norm_{2 * i + 1}.w_0", layer + "ln1_scale"),
                  (f"layer_norm_{2 * i + 1}.b_0", layer + "ln1_bias"),
                  (f"fc_{4 * i + 2}.w_0", layer + "ffn_in_w"),
                  (f"fc_{4 * i + 2}.b_0", layer + "ffn_in_b"),
                  (f"fc_{4 * i + 3}.w_0", layer + "ffn_out_w"),
                  (f"fc_{4 * i + 3}.b_0", layer + "ffn_out_b"),
                  (f"layer_norm_{2 * i + 2}.w_0", layer + "ln2_scale"),
                  (f"layer_norm_{2 * i + 2}.b_0", layer + "ln2_bias")]
    return pairs + [(f"fc_{4 * n_layer}.w_0", "mlm_w"),
                    (f"fc_{4 * n_layer}.b_0", "mlm_b")]


class BertPretrain(nn.Module):
    """``build_pretrain_net``: the encoder and the masked-LM head, with its
    defaults (vocab 1000, seq_len 128, 2 layers, 4 heads, d_model 128, d_ff
    512, no dropout, the hand-written attention).  Bench BERT-base is
    ``BertPretrain(30522, 128, 12, 12, 768, 3072, 0.1)``.

    :meth:`forward` takes ``make_batch``'s six arrays as tensors and
    returns (avg_loss, enc).  Runs on CUDA unless ``device`` says
    otherwise; the parameters are uninitialized until :meth:`init_params`
    or ``interop.load_paddle_tpu_bert_params``."""

    def __init__(self, vocab_size=1000, seq_len=128, n_layer=2, n_head=4,
                 d_model=128, d_ff=512, dropout_rate=0.0, use_flash=False,
                 fused_qkv_attention=True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size, self.n_layer = vocab_size, n_layer
        self.dropout_rate = float(dropout_rate)
        self.encoder = BertEncoder(vocab_size, seq_len, n_layer, n_head,
                                   d_model, d_ff, use_flash,
                                   fused_qkv_attention, device)
        self.mlm_w = _param(d_model, vocab_size, device=device)
        self.mlm_b = _param(vocab_size, device=device)

    def paddle_tpu_named_parameters(self):
        """[(reference name, parameter)] in :func:`bert_param_names`'s
        order."""
        return [(name, self.get_parameter(path))
                for name, path in bert_param_names(self.n_layer)]

    @torch.no_grad()
    def init_params(self, seed=0):
        """Seeded random weights with the reference's initializers, drawn on
        the CPU from a torch.Generator: the three embeddings N(0, 0.02),
        the matrices Xavier-uniform, biases 0, layer-norm scales 1."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_embedding"):
                w = torch.randn(p.shape, generator=gen) * 0.02
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
        """The names of the dropout sites, one seed each, in the order the
        reference's program draws their ``rng_id``s: the embedding
        dropout, then each layer's :attr:`BertEncoderLayer.SITES`; a site
        that ``attention_fuse`` switched draws its id at pass time, after
        all others, so those come last, by layer."""
        sites, fused = ["emb_dropout"], []
        for i, layer in enumerate(self.encoder.layers):
            for s in BertEncoderLayer.SITES:
                name = f"layers.{i}.{s}"
                (fused if s == "attn" and layer.attn.attention_fused
                 else sites).append(name)
        return sites + fused

    def _seeds(self, dropout_seeds, generator):
        """{site: host int}: the given seeds (in :meth:`dropout_sites`
        order), or uint32s drawn on the CPU from ``generator``."""
        names = self.dropout_sites()
        if dropout_seeds is None:
            dropout_seeds = torch.randint(0, 2 ** 32, (len(names),),
                                          dtype=torch.int64,
                                          generator=generator).tolist()
        if len(dropout_seeds) != len(names):
            raise ValueError(f"BertPretrain: {len(dropout_seeds)} dropout "
                             f"seeds for {len(names)} dropout sites")
        return {n: int(s) & 0xFFFFFFFF for n, s in zip(names, dropout_seeds)}

    def forward(self, src_ids, pos_ids, sent_ids, input_mask, mask_labels,
                mask_weights, dropout_seeds=None, generator=None):
        """ids [b, t, 1] (or [b, t]) int64, input_mask and mask_weights
        [b, t, 1] f32, mask_labels [b, t, 1] int64.  Returns (avg_loss,
        enc [b, t, d_model]): the mask_weights-weighted mean of the
        per-token cross entropy and the encoder output.

        In training mode with ``dropout_rate`` > 0 every site of
        :meth:`dropout_sites` drops with its uint32 seed from
        ``dropout_seeds`` (a sequence in that order), or, when none are
        given, with seeds drawn on the host from ``generator``.

        With ``amp.enable(model)`` the step runs under the reference's bf16
        cast policy (``paddle_tpu_torch.amp``), as ``pt.amp.enable`` runs
        ``build_pretrain_net``: the embeddings summed, normalized and
        dropped in f32; the matrix products and the attention in bf16 (the
        attention bias too); from the first residual on every activation
        bf16 (layer norm with f32 statistics, the fc biases and gelu
        following their input); the logits bf16 and the loss f32; every
        parameter's gradient f32."""
        rate = self.dropout_rate if self.training else 0.0
        seeds = self._seeds(dropout_seeds, generator) if rate else None
        with amp.policy_scope(self):
            enc = self.encoder(src_ids, pos_ids, sent_ids, input_mask, rate,
                               seeds)
            logits = fc(enc, self.mlm_w, self.mlm_b)
            return masked_lm_loss(logits.reshape(-1, self.vocab_size),
                                  mask_labels.reshape(-1, 1),
                                  mask_weights.reshape(-1, 1)), enc


def make_batch(batch_size, seq_len, vocab_size, rng=None):
    """A copy of the reference's ``make_batch``: ids in [0, vocab), the
    positions 0..t-1, sentence ids 0, an input mask of ones and label
    weights 1 on about 15% of the tokens, as numpy arrays drawn from
    ``rng`` (``RandomState(0)`` by default) in the reference's order."""
    rng = rng or np.random.RandomState(0)
    pos = np.tile(np.arange(seq_len, dtype=np.int64)[None, :, None],
                  (batch_size, 1, 1))
    return {
        "src_ids": rng.randint(0, vocab_size,
                               (batch_size, seq_len, 1)).astype("int64"),
        "pos_ids": pos,
        "sent_ids": np.zeros((batch_size, seq_len, 1), np.int64),
        "input_mask": np.ones((batch_size, seq_len, 1), np.float32),
        "mask_labels": rng.randint(0, vocab_size,
                                   (batch_size, seq_len, 1)).astype("int64"),
        "mask_weights": (rng.rand(batch_size, seq_len, 1)
                         < 0.15).astype("float32"),
    }
