"""GenerationSession: greedy generation with the ring or paged KV cache.

Counterpart of ``paddle_tpu/generation/sampler.py`` ``GenerationSession``
over the programs ``build_generation_programs`` builds for greedy
decoding.  The reference's build-time flags are constructor arguments
with its defaults: ``paged``/``block_t``/``num_blocks`` for
``FLAGS_paged_kv_cache``/``FLAGS_kv_block_t``/``FLAGS_kv_cache_blocks``
(and the model's ``fused_decode_step`` for ``FLAGS_fused_decode_step``).
Every route self-feeds its greedy token and latches eos on the device, as
the reference's fused route does.  The serving tier reaches the model only
through :meth:`prefill` and :meth:`decode_step`; :meth:`generate` is the
one-shot entry point.

A paged pool smaller than batch * max_blocks blocks (on either side) arms
dynamic mode, where only the serving batcher maps blocks, and
:meth:`generate` refuses, as the reference's does.

Session state lives on the model's device: the self and cross caches with
their length counters, the last token of every lane and the finished
latch.  ``last_logits`` keeps the logits of the latest decode step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.transformer import pad_bias, src_token_lengths
from ..ops.generation_ops import sample_token
from .kv_cache import KVCache, PagedKVCache, cache_rows


def _lane_mask(active, batch, device):
    """[b] int32 0/1 from an optional host or device mask (default all)."""
    if active is None:
        return torch.ones(batch, dtype=torch.int32, device=device)
    if not isinstance(active, torch.Tensor):
        active = torch.as_tensor(np.asarray(active))
    return (active.reshape(batch) != 0).to(device=device,
                                            dtype=torch.int32)


class GenerationSession:
    """Greedy generation for ``batch_size`` lanes of ``model``.

    ``max_out_len`` tokens at most per sequence (position 0 is BOS);
    ``src_seq_len`` source positions.  Token 0 is the pad id of the
    source.  ``paged`` swaps the ring caches for paged pools of
    ``block_t``-row blocks, ``num_blocks`` per side (0: ring-equivalent)."""

    def __init__(self, model, batch_size: int, src_seq_len: int,
                 max_out_len: int, bos_id: int = 0, eos_id: int = 1,
                 paged: bool = False, block_t: int = 16,
                 num_blocks: int = 0):
        if (model.max_length < max_out_len + 1
                or model.max_length < src_seq_len):
            raise ValueError(
                f"max_length={model.max_length} position table is smaller "
                f"than the decode buffer (max_out_len+1={max_out_len + 1})"
                f" or the source length ({src_seq_len})")
        self.model = model
        self.batch_size = batch_size
        self.src_seq_len = src_seq_len
        self.max_out_len = max_out_len
        self.bos_id, self.eos_id = bos_id, eos_id
        dev = model.device
        shape = (model.n_layer, batch_size)
        heads = (model.n_head, model.d_key)
        rows = (cache_rows(max_out_len + 1), cache_rows(src_seq_len))
        self.paged = bool(paged)
        self.dynamic_only = False
        if self.paged:
            self.self_cache, self.cross_cache = (
                PagedKVCache(*shape, r, *heads, dev, block_t=block_t,
                             num_blocks=num_blocks) for r in rows)
            caches = (self.self_cache, self.cross_cache)
            self.dynamic_only = any(
                c.num_blocks < c.batch * c.max_blocks for c in caches)
            for c in caches:
                if self.dynamic_only:
                    c.reset_dynamic()
                else:
                    c.allocate()
        else:
            self.self_cache, self.cross_cache = (
                KVCache(*shape, r, *heads, dev) for r in rows)
        self.last_tok = torch.full((batch_size,), bos_id, dtype=torch.int64,
                                   device=dev)
        self.finished = torch.zeros(batch_size, dtype=torch.int32,
                                    device=dev)
        self.last_logits = None

    @property
    def device(self):
        return self.model.device

    @torch.no_grad()
    def prefill(self, src_word, src_pos=None, active=None) -> np.ndarray:
        """Encode src_word [b, Ts(, 1)] and write the cross cache of the
        lanes in ``active`` [b] 0/1 (default all): continuous batching's
        late join.  A joining lane gets its source length as cross
        length, self length 0, BOS and a cleared finished latch; the
        other lanes keep their state.  Returns the source lengths."""
        b, ts = self.batch_size, self.src_seq_len
        dev = self.device
        word = torch.as_tensor(np.asarray(src_word, np.int64),
                               device=dev).reshape(b, ts)
        if src_pos is None:
            pos = torch.arange(ts, device=dev).expand(b, ts)
        else:
            pos = torch.as_tensor(np.asarray(src_pos, np.int64),
                                  device=dev).reshape(b, ts)
        enc_out = self.model.encode(word, pos, pad_bias(word))
        src_lens = src_token_lengths(word)
        a = _lane_mask(active, b, dev)
        inv = 1 - a
        self.model.prefill_cross_cache(enc_out, self.cross_cache, a)
        cross, own = self.cross_cache.lengths, self.self_cache.lengths
        cross.copy_(a * src_lens + inv * cross)
        own.copy_(inv * own)
        self.last_tok.copy_(a * self.bos_id + inv * self.last_tok)
        self.finished.copy_(inv * self.finished)
        return src_lens.cpu().numpy()

    @torch.no_grad()
    def decode_step(self, active=None) -> np.ndarray:
        """One token for every lane -> [b] int64.  Lanes with ``active``
        == 0 neither write their cache row nor advance their length.  A
        finished lane keeps emitting (and feeding itself) eos."""
        b = self.batch_size
        a = _lane_mask(active, b, self.device)
        lengths = self.self_cache.lengths + a
        logits = self.model.decode_logits(self.last_tok, self.self_cache,
                                          self.cross_cache, lengths, a)
        self.last_logits = logits
        nxt = sample_token(logits)
        fin = self.finished.long()
        masked = fin * self.eos_id + (1 - fin) * nxt
        is_eos = (masked == self.eos_id).to(torch.int32)
        self.finished.copy_(self.finished + is_eos
                            - self.finished * is_eos)
        self.last_tok.copy_(masked)
        self.self_cache.lengths.copy_(lengths)
        return masked.cpu().numpy()

    def generate(self, src_word, src_pos=None,
                 max_tokens: Optional[int] = None):
        """Greedy generation: (tokens [b, n] int64, eos-padded past each
        sequence's end, n steps run).  Prefill once, then one decode step
        per token, stopping early once every sequence has emitted eos."""
        if self.dynamic_only:
            raise RuntimeError(
                "paged KV pool is smaller than batch*max_blocks (dynamic "
                "serving mode): drive it through ContinuousBatcher, which "
                "maps blocks per request; generate() needs the static "
                "identity tables")
        max_tokens = min(max_tokens or self.max_out_len, self.max_out_len)
        rows = np.asarray(src_word).shape[0]
        if rows != self.batch_size:
            raise ValueError(f"generate: got {rows} rows, the session has "
                             f"{self.batch_size} lanes")
        self.prefill(src_word, src_pos)
        finished = np.zeros((self.batch_size,), bool)
        out = []
        for _ in range(max_tokens):
            nxt = np.where(finished, self.eos_id, self.decode_step())
            out.append(nxt)
            finished |= nxt == self.eos_id
            if finished.all():
                break
        return np.stack(out, axis=1), len(out)
