"""Initialisers (counterpart of biomedkg_tpu/nn.py), drawn from an explicit
``torch.Generator`` so weights come from a seed."""

from __future__ import annotations

import math
from typing import Optional

import torch


def xavier_uniform(shape, generator: Optional[torch.Generator] = None,
                   dtype=torch.float32) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ over the last two dims (glorot)."""
    fan_in, fan_out = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape, dtype=dtype).uniform_(-bound, bound,
                                                    generator=generator)
