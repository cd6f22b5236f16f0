"""Adam on parameter trees (port of ``repro/train/optimizer.py``).

Functional like the reference: ``update`` returns new parameters and a
new state and changes neither argument. Moments, the global-norm clip
and the bias corrections are float32; each update is computed in
float32 and cast to the parameter's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor      # int32 scalar (a [C] vector when client-stacked)
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0

    def init(self, params) -> AdamState:
        first = leaves(params)[0]

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            m=tree_map(zeros, params), v=tree_map(zeros, params))

    def update(self, grads, state: AdamState, params):
        grads = tree_map(lambda g: g.float(), grads)
        if self.grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda mu, g: b1 * mu + (1 - b1) * g, state.m, grads)
        v = tree_map(lambda nu, g: b2 * nu + (1 - b2) * g * g, state.v,
                     grads)
        t = step.float()
        bc1 = 1 - torch.pow(torch.full_like(t, b1), t)
        bc2 = 1 - torch.pow(torch.full_like(t, b2), t)

        def upd(p, mu, nu):
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (p.float() - self.lr * u).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, AdamState(step=step, m=m, v=v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf
    by leaf in flatten order (the reference's Python ``sum``)."""
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(leaf.float() ** 2)
    return torch.sqrt(total)
