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
        # b1, b2 as float32 scalars once on each device that holds a
        # parameter (the shards of a parameter over a mesh may lie on
        # several cards)
        self._betas = {dev: tuple(
            torch.tensor(b, dtype=torch.float32, device=dev)
            for b in (ADAM_B1, ADAM_B2))
            for dev in dict.fromkeys(p.device for p in self.params)}

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of every parameter by its gradient."""
        self.count += 1
        bcs = {dev: (1 - b1 ** self.count, 1 - b2 ** self.count)
               for dev, (b1, b2) in self._betas.items()}
        lr = self.lr
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            bc1, bc2 = bcs[p.device]
            m.copy_((1 - ADAM_B1) * g + ADAM_B1 * m)
            v.copy_((1 - ADAM_B2) * (g * g) + ADAM_B2 * v)
            p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)))
