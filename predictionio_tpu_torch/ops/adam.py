"""Adam in optax's order, for the port's trainers.

`optax.adam(lr)` at its defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root
0), written out so that the CPU and the card run the same arithmetic as
the JAX package's `tx.update` + `optax.apply_updates`:

    m = (1 - b1) g + b1 m
    v = (1 - b2) g^2 + b2 v
    p = p + -lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

with the bias corrections `1 - b**t` in float32. `torch.optim.Adam`
rounds in another order, so the trainers' step-by-step parity with the
JAX package would not hold with it. The moments are dense: a row of an
embedding table that a batch does not touch still moves, as in optax.
Used by `ops.logreg`, `ops.twotower` and `ops.seqrec`.
"""

from __future__ import annotations

from typing import Sequence

import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Adam:
    """The moments of `params` (tensors updated in place by `step`),
    fresh at count 0, as `optax.adam(lr).init(params)`."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.params = list(params)
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        dev = self.params[0].device
        self._b1 = torch.tensor(ADAM_B1, dtype=torch.float32, device=dev)
        self._b2 = torch.tensor(ADAM_B2, dtype=torch.float32, device=dev)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every parameter by its gradient."""
        self.count += 1
        bc1 = 1 - self._b1 ** self.count
        bc2 = 1 - self._b2 ** self.count
        lr = self.lr
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
            v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v)
            p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)))
