"""Adam with optax's constants (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, no weight decay), in plain tensor ops over named leaves."""

from __future__ import annotations

import math
from typing import Dict

import torch


class Adam:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params, self.lr = params, lr
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        """One update; a leaf with no gradient keeps its value and
        moments (torch's Adam skips it)."""
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads.get(k)
            if g is None:
                continue
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.sub_(self.lr / c1 * self.m[k] / denom)
