"""DistMult decoder (counterpart of
biomedkg_tpu/models/decoders.py::DistMult): score = Σ h·r·t.

Training scores its negatives with ``score_neg_sorted`` (the
stratified-sorted sampler's (K·E,) slots, through ops/negscore.py: the
CUDA kernels on the card) or ``score_neg`` (iid (K, E) sets). TransE,
ComplEx and RotatE come later (ROADMAP.md slice 3).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import xavier_uniform
from ..ops.negscore import distmult_neg_scores
from ..ops.segment import take_rows, take_rows_sorted


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

    def score(self, z, head, tail, rel, tail_sorted: bool = False):
        """Per-edge scores. ``tail_sorted``: the tails ascend (the "dst"
        layout), so the tail gather's backward runs on the sorted
        segment-sum."""
        h = take_rows(z, head)
        t = take_rows_sorted(z, tail) if tail_sorted else take_rows(z, tail)
        r = take_rows(self.rel_emb, rel)
        return torch.sum(h * r * t, dim=-1)

    def score_neg(self, z, neg_src, neg_dst, rel):
        """(K, E) negative sets sharing the batch's (E,) relation column;
        the relation rows follow z's type. Returns float32."""
        k, e = neg_src.shape
        h = take_rows(z, neg_src.reshape(-1)).reshape(k, e, -1)
        t = take_rows(z, neg_dst.reshape(-1)).reshape(k, e, -1)
        r = take_rows(self.rel_emb, rel).to(z.dtype)
        return torch.sum(h * r[None] * t, dim=-1).float()

    def score_neg_sorted(self, z, neg_src, neg_dst, rel):
        """(K·E,) float32 scores of slots with ascending int32 ``neg_src``
        and per-slot int32 relation ids (ops/negscore.py)."""
        return distmult_neg_scores(z, neg_src, neg_dst, rel, self.rel_emb)

    def score_all_tails(self, z, head, rel):
        """(E, N) scores of every node as the tail of (head, rel)."""
        return (take_rows(z, head) * take_rows(self.rel_emb, rel)) @ z.T

    def score_all_heads(self, z, tail, rel):
        """(E, N) scores of every node as the head of (rel, tail)."""
        return (take_rows(z, tail) * take_rows(self.rel_emb, rel)) @ z.T
