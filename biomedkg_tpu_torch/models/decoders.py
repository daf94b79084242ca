"""DistMult decoder (counterpart of
biomedkg_tpu/models/decoders.py::DistMult): score = Σ h·r·t.

The training-side negative scoring (``score_neg_sorted`` and its fused
kernel) comes with the training slice; TransE, ComplEx and RotatE later
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import xavier_uniform
from ..ops.segment import take_rows


class DistMult(nn.Module):
    def __init__(self, num_relations: int, hidden_channels: int):
        super().__init__()
        self.num_relations = num_relations
        self.hidden_channels = hidden_channels
        self.rel_emb = nn.Parameter(
            torch.empty(num_relations, hidden_channels))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.rel_emb.copy_(xavier_uniform(self.rel_emb.shape, generator))

    def score(self, z, head, tail, rel):
        h = take_rows(z, head)
        t = take_rows(z, tail)
        r = take_rows(self.rel_emb, rel)
        return torch.sum(h * r * t, dim=-1)

    def score_all_tails(self, z, head, rel):
        """(E, N) scores of every node as the tail of (head, rel)."""
        return (take_rows(z, head) * take_rows(self.rel_emb, rel)) @ z.T

    def score_all_heads(self, z, tail, rel):
        """(E, N) scores of every node as the head of (rel, tail)."""
        return (take_rows(z, tail) * take_rows(self.rel_emb, rel)) @ z.T
