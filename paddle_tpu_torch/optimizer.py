"""Paddle's Adam, Momentum and SGD, the optimizers of the port's training
steps (the Transformer's, ResNet's and DeepFM's).

Counterparts of ``paddle_tpu/optimizer.py`` ``AdamOptimizer``,
``MomentumOptimizer`` and ``SGDOptimizer`` and their ``adam``,
``momentum`` and ``sgd`` ops (``paddle_tpu/ops/optimizer_ops.py``).

Adam and SGD also take row-sparse gradients (the uncoalesced sparse COO
tensors of ``lookup_table`` and ``fused_lookup_table`` with
``is_sparse``).  The tables whose gradients are sparse are grouped by
shape, as the reference's ``fused_embedding`` pass groups its per-table
optimizer ops into ``fused_sparse_adam`` / ``fused_sparse_sgd``, and each
group is one #23 launch (``kernels/embedding.py``).  The per-table
updates of the reference's flag-off graph compute the same function.
"""

from __future__ import annotations

import torch

from .kernels import embedding as ke
from .selected_rows import SelectedRows


def _sparse_groups(params):
    """The parameters with a sparse gradient as [(params, ids [S, K] int32,
    rows [S, K, D])] groups: tables of one shape, dtype, device and
    lookup count together, in parameter order."""
    groups = {}
    for p in params:
        sr = SelectedRows.from_sparse(p.grad)
        key = (tuple(p.shape), p.dtype, p.device, sr.ids.numel())
        groups.setdefault(key, []).append((p, sr))
    return [([p for p, _ in g],
             torch.stack([sr.ids for _, sr in g]).to(torch.int32),
             torch.stack([sr.rows.reshape(sr.rows.shape[0], -1)
                          for _, sr in g]))
            for g in groups.values()]


def _split_sparse(params):
    """(dense, sparse): the parameters with a gradient, by its layout."""
    dense, sparse = [], []
    for p in params:
        if p.grad is not None:
            (sparse if p.grad.is_sparse else dense).append(p)
    return dense, sparse


class Adam:
    """Adam as Paddle updates, one step per :meth:`minimize`:

        m1 = beta1 * m1 + (1 - beta1) * g
        m2 = beta2 * m2 + (1 - beta2) * g^2
        lr_t = lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)
        p -= lr_t * m1 / (sqrt(m2) + epsilon)

    then ``beta1_pow *= beta1`` and ``beta2_pow *= beta2`` (both start at
    beta1 and beta2).  This is not ``torch.optim.Adam``, which corrects the
    moments' bias itself and adds epsilon after that correction; here
    epsilon is added to the uncorrected ``sqrt(m2)``, so the two differ
    where ``sqrt(m2)`` is near epsilon.

    ``params``: the parameters to train; those with ``requires_grad``
    False are left alone, as the reference leaves its non-trainable ones.
    The state of parameter ``p`` is ``state[p]``, under the reference's
    accumulator names: ``moment1``, ``moment2`` (like p) and
    ``beta1_pow_acc``, ``beta2_pow_acc`` ([1] f32), all on p's device.

    A row-sparse gradient with ``lazy_mode`` (the reference's lazy Adam)
    updates the moments and the parameter on its touched rows only, once
    per distinct row (duplicates summed first); a group of same-shape
    tables is one #23 launch, whose rate lr_t comes from the group's
    first beta pows (they advance in lockstep).
    Without ``lazy_mode`` a sparse gradient is densified first, as the
    reference's default does.
    """

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False):
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate = float(learning_rate)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)
        self.lazy_mode = bool(lazy_mode)
        self.state = {}
        for p in self.params:
            self.state[p] = {
                "moment1": torch.zeros_like(p, memory_format=torch.
                                            contiguous_format),
                "moment2": torch.zeros_like(p, memory_format=torch.
                                            contiguous_format),
                "beta1_pow_acc": torch.full((1,), self.beta1,
                                            device=p.device),
                "beta2_pow_acc": torch.full((1,), self.beta2,
                                            device=p.device),
            }

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient, in place.  The
        learning-rate factor stays a device tensor: no host sync."""
        b1, b2 = self.beta1, self.beta2
        dense, sparse = _split_sparse(self.params)
        if not self.lazy_mode:
            dense, sparse = dense + sparse, []
        for p in dense:
            g = p.grad
            if g.is_sparse:
                g = SelectedRows.from_sparse(g).to_dense()
            st = self.state[p]
            m1 = st["moment1"].mul_(b1).add_(g, alpha=1 - b1)
            m2 = st["moment2"].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(self._lr_t(p) * m1 / (torch.sqrt(m2) + self.epsilon))
        for group, ids, rows in _sparse_groups(sparse):
            ke.multi_table_sparse_adam(
                group, [self.state[p]["moment1"] for p in group],
                [self.state[p]["moment2"] for p in group], ids, rows,
                self._lr_t(group[0]), b1, b2, self.epsilon)
        for p in dense + sparse:
            self.state[p]["beta1_pow_acc"].mul_(b1)
            self.state[p]["beta2_pow_acc"].mul_(b2)

    def _lr_t(self, p):
        """lr * sqrt(1 - beta2_pow) / (1 - beta1_pow), a [1] device tensor
        from p's accumulators."""
        st = self.state[p]
        return (self.learning_rate * torch.sqrt(1 - st["beta2_pow_acc"])
                / (1 - st["beta1_pow_acc"]))

    def minimize(self, loss):
        """Backward of ``loss``, the update, and a reset of the gradients.
        Returns ``[(param, grad)]`` for the parameters that got one, as the
        reference's ``minimize`` returns its ``params_grads``."""
        loss.backward()
        self.step()
        params_grads = []
        for p in self.params:
            if p.grad is not None:
                params_grads.append((p, p.grad))
                p.grad = None
        return params_grads


class Momentum:
    """Momentum as Paddle's dense ``momentum`` op updates, one step per
    :meth:`minimize`:

        v = mu * v + g
        p -= lr * v                      (use_nesterov: p -= (g + mu * v) * lr)

    Unlike ``torch.optim.SGD``'s momentum, the velocity of the first step
    is mu * 0 + g with no dampening, and lr multiplies v in the update
    rather than in the velocity.  ``params``: those with ``requires_grad``
    False are left alone.  The state of parameter ``p`` is
    ``state[p]["velocity"]`` (like p, zero at the start), the reference's
    ``<param>_velocity_0``.
    """

    def __init__(self, params, learning_rate, momentum, use_nesterov=False):
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.use_nesterov = bool(use_nesterov)
        self.state = {p: {"velocity": torch.zeros_like(
            p, memory_format=torch.contiguous_format)} for p in self.params}

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient, in place; each
        product rounds on its own, as the reference's op does."""
        lr, mu = self.learning_rate, self.momentum
        for p in self.params:
            g = p.grad
            if g is None:
                continue
            v = self.state[p]["velocity"].mul_(mu).add_(g)
            if self.use_nesterov:
                p.sub_((g + mu * v) * lr)
            else:
                p.sub_(lr * v)

    minimize = Adam.minimize


class SGD:
    """SGD as Paddle's ``sgd`` op updates, one step per :meth:`minimize`:
    p -= lr * g.  A row-sparse gradient updates the touched rows only: each
    group of same-shape tables is one #23 launch in SGD mode on its merged
    rows (``fused_sparse_sgd``).  The reference's ``optimizer="sgd"`` of
    DeepFM (dist_ctr parity).
    ``params``: those with ``requires_grad`` False are left alone."""

    def __init__(self, params, learning_rate):
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate = float(learning_rate)
        self.state = {}

    @torch.no_grad()
    def step(self):
        """Update every parameter that has a gradient, in place."""
        lr = self.learning_rate
        dense, sparse = _split_sparse(self.params)
        for p in dense:
            p.sub_(lr * p.grad)
        for group, ids, rows in _sparse_groups(sparse):
            ke.multi_table_sparse_sgd(group, ids, rows, lr)

    minimize = Adam.minimize
