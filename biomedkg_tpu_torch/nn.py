"""Initialisers, the dense layer, dropout, feature masking and the masked
BCE loss (counterpart of biomedkg_tpu/nn.py). Random draws take an
explicit ``torch.Generator``, or the masks are passed in, so weights and
masks come from a seed (ROADMAP.md hazard H2)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def kaiming_uniform(shape, fan_in: int,
                    generator: Optional[torch.Generator] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """torch.nn.Linear's default weight init (kaiming_uniform_, a=sqrt(5)):
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return uniform_fan(shape, fan_in, generator, dtype)


def uniform_fan(shape, fan: int, generator: Optional[torch.Generator] = None,
                dtype=torch.float32) -> torch.Tensor:
    """PyG's ``uniform(size, tensor)`` init: U(-1/sqrt(fan), 1/sqrt(fan))."""
    bound = 1.0 / math.sqrt(fan)
    return torch.empty(shape, dtype=dtype).uniform_(-bound, bound,
                                                    generator=generator)


class Linear(nn.Module):
    """Dense layer stored (in_dim, out_dim) for ``x @ w + b``, under the
    reference's parameter names ``w`` and ``b``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """The reference's ``linear_init``: both from U(±1/sqrt(in_dim))."""
        fan_in = self.w.shape[0]
        self.w.copy_(kaiming_uniform(self.w.shape, fan_in, generator))
        self.b.copy_(uniform_fan(self.b.shape, fan_in, generator))

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """``x @ w + b`` with the parameters rounded to ``dtype`` (the
        compute policy) and the product in the wider of x's type and
        ``dtype``, as the reference's ``linear_apply`` promotes."""
        wide = torch.promote_types(x.dtype, dtype)
        return (x.to(wide) @ self.w.to(dtype).to(wide)
                + self.b.to(dtype).to(wide))


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


def mask_feature(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """PyG ``mask_feature(mode='all')`` with an explicit boolean ``keep``
    of x's shape: entries where it is False become 0."""
    return x * keep.to(x.dtype)


def sigmoid_binary_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 weights: Optional[torch.Tensor] = None
                                 ) -> torch.Tensor:
    """Mean BCE-with-logits, optionally masked: Σ w·loss / max(Σ w, 1)."""
    loss = -(labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))
    if weights is None:
        return loss.mean()
    return (loss * weights).sum() / weights.sum().clamp(min=1.0)
