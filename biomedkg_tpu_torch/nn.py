"""Initialisers, dropout and the masked BCE loss (counterpart of
biomedkg_tpu/nn.py). Random draws take an explicit ``torch.Generator``
so weights and masks come from a seed (ROADMAP.md hazard H2)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def xavier_uniform(shape, generator: Optional[torch.Generator] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ over the last two dims (glorot)."""
    fan_in, fan_out = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=dtype).uniform_(-bound, bound,
                                                    generator=generator)


def dropout(x: torch.Tensor, keep_mask: torch.Tensor,
            rate: float) -> torch.Tensor:
    """Inverted dropout with an explicit boolean ``keep_mask`` (the
    reference's ``nn.dropout``: kept entries scaled by 1/(1 - rate))."""
    return torch.where(keep_mask, x / (1.0 - rate), 0.0)


def dropout_mask(shape, rate: float, generator: torch.Generator,
                 device) -> torch.Tensor:
    """A keep mask drawn from ``generator``: True with probability
    1 - rate."""
    return torch.rand(shape, generator=generator, device=device) \
        >= rate


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 weights: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Mean BCE-with-logits, optionally masked: Σ w·loss / max(Σ w, 1)."""
    loss = -(labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))
    if weights is None:
        return loss.mean()
    return (loss * weights).sum() / weights.sum().clamp(min=1.0)
