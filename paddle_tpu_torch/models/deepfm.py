"""DeepFM for click-through-rate training, as an nn.Module.

Counterpart of ``paddle_tpu/models/deepfm.py`` (``ctr_deepfm``,
``build_train_net`` and ``make_batch``), the reference's sparse CTR
workload (``bench_deepfm``): 13 dense features and 26 sparse slots, each
slot with its own embedding table [hash_dim, embedding_size] and
first-order table [hash_dim, 1]; the FM second-order term; an MLP of
400-400-400 with ReLU and a 2-way softmax; the cross entropy's mean and a
streaming AUC.

With ``fused_embedding`` (the reference's FLAGS_fused_embedding, on by
default) the 26 embedding lookups are one ``fused_lookup_table`` (one #22
launch) and the 26 first-order lookups another; without it each slot is
its own ``lookup_table``, the reference's flag-off lookups.  With
``is_sparse`` every table's gradient is row-sparse (an uncoalesced sparse
COO tensor), which ``Adam(lazy_mode=True)`` or ``SGD`` apply to the
touched rows only: one #23 launch per table group on either route.

Parameters keep the reference's names and layouts (``deepfm_emb_<i>``,
``deepfm_w1_<i>``, ``deepfm_fc<i>_w`` [in, out], ``deepfm_fc<i>_b``,
``deepfm_out_w``, ``deepfm_out_b``), so
``interop.load_paddle_tpu_deepfm_params`` carries a JAX scope across.
The AUC's histograms are the buffers ``auc_stat_pos`` and
``auc_stat_neg``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.metric_ops import auc
from ..ops.nn_ops import (cross_entropy, fused_lookup_table, lookup_table,
                          stacked_slot_ids)

#: dist_ctr_reader.py: 13 continuous features, 26 categorical slots
DENSE_DIM = 13
SPARSE_SLOTS = 26
#: the reference's scaled-down default; ``bench_deepfm`` uses 1000001
HASH_DIM = 10001
NUM_THRESHOLDS = 4095
#: ``ctr_deepfm``'s MLP
HIDDEN_SIZES = (400, 400, 400)


class DeepFM(nn.Module):
    """``ctr_deepfm`` with ``build_train_net``'s loss and metric.
    ``forward(dense, sparse_ids, click)`` takes the dense features [B, 13]
    f32, the slots' ids (a sequence of 26 [B] or [B, 1] integer tensors,
    the feed's ``C0`` ... ``C25``, or one [26, B] tensor) and the int64
    label [B, 1], and returns (avg_cost, auc, predict [B, 2]).  Runs on
    CUDA unless ``device`` says otherwise; parameters are uninitialized
    until :meth:`init_params` or ``interop.load_paddle_tpu_deepfm_params``.
    """

    def __init__(self, embedding_size=10, hash_dim=HASH_DIM, is_sparse=True,
                 fused_embedding=True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embedding_size, self.hash_dim = embedding_size, hash_dim
        self.is_sparse = bool(is_sparse)
        self.fused_embedding = bool(fused_embedding)

        def param(name, *shape):
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, device=device)))

        for i in range(SPARSE_SLOTS):
            param(f"deepfm_emb_{i}", hash_dim, embedding_size)
            param(f"deepfm_w1_{i}", hash_dim, 1)
        # dense, the slots' embeddings, the first-order and FM terms
        width = (DENSE_DIM + SPARSE_SLOTS * (embedding_size + 1)
                 + embedding_size)
        for i, h in enumerate(HIDDEN_SIZES):
            param(f"deepfm_fc{i}_w", width, h)
            param(f"deepfm_fc{i}_b", h)
            width = h
        param("deepfm_out_w", width, 2)
        param("deepfm_out_b", 2)
        for name in ("auc_stat_pos", "auc_stat_neg"):
            self.register_buffer(name, torch.zeros(NUM_THRESHOLDS + 1,
                                                   device=device))

    def paddle_tpu_named_parameters(self):
        """[(reference name, parameter)]: the parameters' own names, which
        are the reference's."""
        return list(self.named_parameters())

    def tables(self, kind="emb"):
        """The 26 embedding tables (``kind`` "emb") or first-order tables
        ("w1"), slot by slot."""
        return [self.get_parameter(f"deepfm_{kind}_{i}")
                for i in range(SPARSE_SLOTS)]

    @torch.no_grad()
    def init_params(self, seed=0):
        """Seeded random weights with the reference's initializers, drawn
        on the CPU from a torch.Generator so every device gets the same
        numbers: Xavier-uniform weights and tables (limit sqrt(6 / (rows +
        columns))), zero biases; the AUC histograms emptied."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if p.dim() == 1:
                p.zero_()
                continue
            limit = math.sqrt(6.0 / sum(p.shape))
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * limit)
        self.auc_stat_pos.zero_()
        self.auc_stat_neg.zero_()
        return self

    def _lookup(self, kind, ids):
        """[S, B, D] rows of the ``kind`` tables at ids [S, B]."""
        tables = self.tables(kind)
        if self.fused_embedding:
            return fused_lookup_table(tables, ids, is_sparse=self.is_sparse)
        return torch.stack([lookup_table(t, ids[s], is_sparse=self.is_sparse)
                            for s, t in enumerate(tables)])

    def forward(self, dense, sparse_ids, click):
        ids = stacked_slot_ids(sparse_ids)
        b = ids.shape[1]
        # slot-major, as the reference's concat: slot i owns columns
        # i * E .. i * E + E - 1
        stacked = self._lookup("emb", ids).transpose(0, 1)      # [B, S, E]
        # FM: the first-order weights and 0.5 ((sum v)^2 - sum v^2)
        first = self._lookup("w1", ids)[..., 0].transpose(0, 1)  # [B, S]
        sum_v = stacked.sum(1)
        second = 0.5 * (sum_v.square() - stacked.square().sum(1))
        x = torch.cat([dense, stacked.reshape(b, -1), first, second], dim=1)
        for i in range(len(HIDDEN_SIZES)):
            x = torch.relu(x @ self.get_parameter(f"deepfm_fc{i}_w")
                           + self.get_parameter(f"deepfm_fc{i}_b"))
        predict = torch.softmax(x @ self.deepfm_out_w + self.deepfm_out_b,
                                dim=-1)
        avg_cost = cross_entropy(predict, click).mean()
        return (avg_cost, auc(predict.detach(), click, self.auc_stat_pos,
                              self.auc_stat_neg, NUM_THRESHOLDS), predict)


def make_batch(batch_size, hash_dim=HASH_DIM, rng=None):
    """The reference's synthetic CTR batch, array for array for the same
    ``RandomState``: ``dense_input`` [B, 13] f32 uniform, ``C0`` ...
    ``C25`` [B, 1] int64 uniform in [0, hash_dim), and ``click`` [B, 1]
    int64 drawn from a logistic of the first two dense features (a
    learnable signal, so the loss can fall below ln 2)."""
    rng = rng or np.random.RandomState(0)
    dense = rng.rand(batch_size, DENSE_DIM).astype("float32")
    feed = {"dense_input": dense}
    for i in range(SPARSE_SLOTS):
        feed[f"C{i}"] = rng.randint(0, hash_dim,
                                    (batch_size, 1)).astype("int64")
    logit = 4.0 * (dense[:, 0] - 0.5) + 2.0 * (dense[:, 1] - 0.5)
    p = 1.0 / (1.0 + np.exp(-logit))
    feed["click"] = (rng.rand(batch_size) < p).astype("int64")[:, None]
    return feed


def batch_tensors(feed, device=None):
    """(dense, sparse_ids [26, B] int32, click) on ``device`` from a
    :func:`make_batch` feed, the slots stacked once on the host."""
    device = resolve_device(device)
    ids = np.stack([feed[f"C{i}"].reshape(-1)
                    for i in range(SPARSE_SLOTS)]).astype(np.int32)
    return (torch.from_numpy(feed["dense_input"]).to(device),
            torch.from_numpy(ids).to(device),
            torch.from_numpy(feed["click"]).to(device))
