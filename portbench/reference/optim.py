"""The plain reference's optimizer: optax's chain
``clip_by_global_norm(1.0) -> scale_by_adam() -> scale_by_schedule ->
scale(-1)`` over named float32 tensors, with optax's rules (the clip
applies only when the global norm reaches the limit; eps outside the
square root; bias corrections of the incremented count; the schedule read
at the count before the update) and the HF warm-up schedules of the
reference configs. Plain torch; nothing of the program."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def schedule(kind: str, lr: float, total: int, warm_up_ratio: float,
             step: int) -> float:
    """The learning rate of update number ``step`` (from 0), in float32."""
    f32 = np.float32
    warm = int(total * warm_up_ratio)
    s = f32(step)
    if s < warm:
        return float(f32(lr) * (s / f32(max(1.0, warm))))
    progress = (s - f32(warm)) / f32(max(1.0, total - warm))
    if kind == "cosine":
        decay = max(f32(0.0), f32(0.5) * (f32(1.0) + np.cos(
            f32(math.pi) * progress, dtype=f32)))
    elif kind == "linear":
        decay = max(f32(0.0), f32(1.0) - progress)
    else:
        decay = f32(1.0)
    return float(f32(lr) * decay)


class Adam:
    """The chain over a dict of leaves; ``step`` returns the clipped
    gradients it applied."""

    def __init__(self, params: Dict[str, torch.Tensor], lr_of, clip=1.0):
        self.params = params
        self.lr_of = lr_of
        self.clip = clip
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values()))
        scale = 1.0 if float(norm) < self.clip else self.clip / float(norm)
        clipped = {k: g * scale for k, g in grads.items()}
        count = self.count + 1
        lr = self.lr_of(self.count)
        c1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(count))
        c2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(count))
        for k, g in clipped.items():
            self.mu[k] = B1 * self.mu[k] + (1.0 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1.0 - B2) * g * g
            upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + EPS)
            self.params[k] = self.params[k] - lr * upd
        self.count = count
        return clipped


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: List[str]) -> float:
    """max over ``leaves`` of |‖prog‖ − ‖ref‖| / max(‖ref‖, the median
    leaf's ‖ref‖): the gap of the norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    median = float(np.median([ref[k] for k in leaves]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in leaves)
