"""SelectedRows: the row-sparse gradient of an embedding table.

Counterpart of ``paddle_tpu/core/selected_rows.py``: ``ids [K]`` and
``rows [K, ...]`` of a tall tensor of ``height`` rows, one row per lookup,
duplicates allowed.  In the port a table's row-sparse gradient travels
through autograd as an uncoalesced sparse COO tensor (what
``F.embedding(..., sparse=True)`` gives); :meth:`SelectedRows.from_sparse`
and :meth:`SelectedRows.to_sparse` convert through ``_indices()`` and
``_values()`` and never coalesce, whose order of summation on CUDA is not
fixed.  Duplicates are merged by :meth:`merged` (the reference's MergeAdd,
``kernels.embedding.merge_slot_rows``) or inside the apply kernel #23.
"""

from __future__ import annotations

import torch

from .kernels.embedding import merge_slot_rows


class SelectedRows:
    """rows [K, ...] of the ids [K] of a [height, ...] tensor."""

    __slots__ = ("ids", "rows", "height")

    def __init__(self, ids, rows, height: int):
        self.ids = ids
        self.rows = rows
        self.height = int(height)

    @property
    def shape(self):
        return (self.height,) + tuple(self.rows.shape[1:])

    @classmethod
    def from_sparse(cls, grad):
        """The SelectedRows of an uncoalesced sparse COO tensor of one
        sparse dimension (its duplicates kept, nothing summed)."""
        if not grad.is_sparse or grad.sparse_dim() != 1:
            raise ValueError("SelectedRows.from_sparse: a sparse COO tensor "
                             "with one sparse dimension is needed")
        return cls(grad._indices()[0], grad._values(), grad.shape[0])

    def to_sparse(self):
        """An uncoalesced sparse COO tensor of shape :attr:`shape` holding
        these rows (the gradient autograd hands a dense table)."""
        return torch.sparse_coo_tensor(
            self.ids.reshape(1, -1).long(), self.rows, self.shape,
            check_invariants=False)

    def merged(self):
        """MergeAdd: (uids [K] int32, mrows [K, ...]), each id once with its
        summed rows, ascending; the tail holds the sentinel ``height``."""
        rows = self.rows.reshape(self.rows.shape[0], -1)
        uids, mrows = merge_slot_rows(self.ids.reshape(1, -1), rows[None],
                                      self.height)
        return uids[0], mrows[0].reshape(self.rows.shape)

    def to_dense(self):
        """SelectedRowsAddToTensor: the rows added into zeros of
        :attr:`shape` (ids outside [0, height) dropped)."""
        ids = self.ids.reshape(-1).long()
        ok = (ids >= 0) & (ids < self.height)
        out = torch.zeros(self.shape, dtype=self.rows.dtype,
                          device=self.rows.device)
        return out.index_add_(0, ids[ok], self.rows[ok])
