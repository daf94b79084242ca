"""Optimizer and learning-rate schedule (counterpart of
biomedkg_tpu/training/optim.py).

The reference's optax chain, written out: ``clip_by_global_norm(1.0) →
scale_by_adam() → scale_by_schedule(warmup_schedule) → scale(-1)``, with
optax's rules, which differ from ``torch.optim``'s in three places:

* the clip scales by ``max_norm / g_norm`` only when ``g_norm >= max_norm``
  (``clip_grad_norm_`` divides by ``g_norm + 1e-6``);
* Adam's ``eps`` is added outside the square root (``eps_root = 0``), with
  the bias corrections of the incremented count;
* the schedule reads the count *before* it is incremented, so the first
  update uses ``schedule(0)``, which is 0 during warm-up.

Every parameter trains. The state is plain tensors and an int, so a
checkpoint needs no optax classes (training/checkpoint.py).
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..utils import profiling


def warmup_schedule(scheduler_type: str, learning_rate: float,
                    num_training_steps: int,
                    warm_up_ratio: float) -> Callable[[int], float]:
    """HF-style schedules, computed in float32 as the reference does.

    linear: lr ramps 0→lr over warm-up, then decays linearly to 0.
    cosine: lr ramps 0→lr, then follows 0.5·(1+cos(π·progress)) to 0.
    constant: the ramp, then lr.
    """
    if scheduler_type not in ("linear", "cosine", "constant"):
        raise ValueError(f"unknown scheduler_type {scheduler_type!r} "
                         "(expected linear | cosine | constant)")
    num_warmup = int(num_training_steps * warm_up_ratio)
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < num_warmup:
            return float(f32(learning_rate) * (step / f32(max(1.0,
                                                             num_warmup))))
        progress = (step - f32(num_warmup)) / f32(
            max(1.0, num_training_steps - num_warmup))
        if scheduler_type == "linear":
            decay = max(f32(0.0), f32(1.0) - progress)
        elif scheduler_type == "cosine":
            decay = max(f32(0.0), f32(0.5) * (f32(1.0) + np.cos(
                f32(math.pi) * progress, dtype=f32)))
        else:
            decay = f32(1.0)
        return float(f32(learning_rate) * decay)

    return schedule


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` (and the schedule's count, which always
    equals it): updates applied so far and the moments, one tensor per
    parameter in the parameters' order."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Optimizer:
    """The reference's optax chain over a list of parameters, updating
    them in place."""

    def __init__(self, schedule: Callable[[int], float],
                 grad_clip: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.schedule = schedule
        self.grad_clip = grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor],
               g_norm: Optional[torch.Tensor] = None) -> AdamState:
        """One step: ``params`` and the state's moments change in place;
        returns the state with the incremented count. No host sync; each
        stage is one multi-tensor (``_foreach``) launch over all the
        parameters, not one launch per parameter. ``g_norm`` is the clip's
        global norm where ``grads`` are shards of a larger gradient (the
        dp × tp step, parallel/dp.py); by default their own norm. The
        update is the ``step.update`` span."""
        with profiling.span("step.update", counters=(profiling.LAUNCHES,)):
            return self._update(grads, state, params, g_norm)

    def _update(self, grads, state, params, g_norm):
        if g_norm is None:
            g_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        keep = g_norm < self.grad_clip
        # optax: g where g_norm < clip, else g / g_norm * clip
        grads = torch._foreach_div(grads, torch.where(keep, 1.0, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, 1.0, self.grad_clip))
        torch._foreach_mul_(state.mu, self.b1)
        torch._foreach_add_(state.mu, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(state.nu, self.b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - self.b2)
        count = state.count + 1
        f32 = np.float32
        mu_hat = torch._foreach_div(
            state.mu, float(f32(1.0) - f32(self.b1) ** f32(count)))
        denom = torch._foreach_div(
            state.nu, float(f32(1.0) - f32(self.b2) ** f32(count)))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_mul_(mu_hat, self.schedule(state.count))
        torch._foreach_sub_(params, mu_hat)
        return AdamState(count, state.mu, state.nu)


def make_optimizer(learning_rate: float, scheduler_type: str,
                   num_training_steps: int, warm_up_ratio: float,
                   grad_clip: float = 1.0) -> Optimizer:
    """Adam + warm-up schedule + global-norm clipping (the reference
    Trainer's ``gradient_clip_val=1.0``)."""
    return Optimizer(warmup_schedule(scheduler_type, learning_rate,
                                     num_training_steps, warm_up_ratio),
                     grad_clip)

