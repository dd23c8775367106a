"""Counterpart of ``paddle_tpu/ops/metric_ops.py`` ``auc``: the streaming
ROC AUC with its persistent histograms, in plain PyTorch (the reference
has no kernel for it)."""

from __future__ import annotations

import torch


@torch.no_grad()
def auc(predict, label, stat_pos, stat_neg, num_thresholds=4095):
    """The reference's ``auc`` op: add this batch to the histograms
    ``stat_pos`` and ``stat_neg`` ([num_thresholds + 1] f32, updated in
    place: the reference's StatPos/StatNeg state) and return the AUC [] f32
    of everything they hold.  The positive probability is predict[:, -1]
    (or predict itself when 1-D), bucketed as int(p * num_thresholds)
    clipped to [0, num_thresholds]; label > 0 is positive.  The area is
    the trapezoidal sum over the thresholds from the top down, over
    tot_pos * tot_neg, and 0 while either class is missing.  Counts add
    whole numbers, exact in f32, so their order does not matter."""
    pos_prob = predict[:, -1] if predict.dim() == 2 else predict.reshape(-1)
    bucket = (pos_prob * num_thresholds).to(torch.int32).clamp(
        0, num_thresholds).long()
    is_pos = (label.reshape(-1) > 0).to(stat_pos.dtype)
    stat_pos.index_add_(0, bucket, is_pos)
    stat_neg.index_add_(0, bucket, 1 - is_pos)
    tp = torch.cumsum(stat_pos.flip(0), 0)
    fp = torch.cumsum(stat_neg.flip(0), 0)
    tot_pos, tot_neg = tp[-1], fp[-1]
    tp_prev = torch.cat([tp.new_zeros(1), tp[:-1]])
    fp_prev = torch.cat([fp.new_zeros(1), fp[:-1]])
    area = ((fp - fp_prev) * (tp + tp_prev) / 2.0).sum()
    return torch.where((tot_pos > 0) & (tot_neg > 0),
                       area / torch.clamp_min(tot_pos * tot_neg, 1.0),
                       area.new_zeros(()))
