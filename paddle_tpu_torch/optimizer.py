"""Paddle's Adam, the optimizer of the port's training step.

Counterpart of ``paddle_tpu/optimizer.py`` ``AdamOptimizer`` and its
``adam`` op (``paddle_tpu/ops/optimizer_ops.py`` ``_adam_one``), dense
gradients only.
"""

from __future__ import annotations

import torch


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
    """

    def __init__(self, params, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.learning_rate = float(learning_rate)
        self.beta1, self.beta2 = float(beta1), float(beta2)
        self.epsilon = float(epsilon)
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
        for p in self.params:
            g = p.grad
            if g is None:
                continue
            st = self.state[p]
            b1p, b2p = st["beta1_pow_acc"], st["beta2_pow_acc"]
            lr_t = self.learning_rate * torch.sqrt(1 - b2p) / (1 - b1p)
            m1 = st["moment1"].mul_(b1).add_(g, alpha=1 - b1)
            m2 = st["moment2"].mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr_t * m1 / (torch.sqrt(m2) + self.epsilon))
            b1p.mul_(b1)
            b2p.mul_(b2)

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
