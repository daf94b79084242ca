"""Triplet-scoring decoders: TransE, DistMult, ComplEx, RotatE
(counterparts of biomedkg_tpu/models/decoders.py).

Each decoder holds its relation parameter ``rel_emb`` ((R, d); RotatE's is
the (R, d/2) phases) and provides ``init(generator)`` (the reference's init
rules), ``score`` (per-edge scores), ``score_neg`` (iid (K, E) negative
sets), ``score_neg_sorted`` (the stratified-sorted sampler's (K·E,) slots,
through ops/negscore.py: the CUDA kernels on the card, the dual-sorted ones
with ``dst_sorted``) and ``score_all_tails`` / ``score_all_heads`` ((E, N)
candidate scores for serving and ranking). ComplEx and RotatE split z into
real and imaginary halves.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn import xavier_uniform
from ..ops.negscore import (complex_neg_scores, complex_neg_scores_ds,
                            distmult_neg_scores, distmult_neg_scores_ds,
                            rotate_neg_scores, rotate_neg_scores_ds,
                            transe_neg_scores, transe_neg_scores_ds)
from ..ops.segment import take_rows, take_rows_sorted


def _tail_take(z, tail, tail_sorted):
    """Tail-row gather; with ``tail_sorted`` (the tails ascend: the "dst"
    layout) its backward runs on the sorted segment-sum."""
    return take_rows_sorted(z, tail) if tail_sorted else take_rows(z, tail)


def _halves(v):
    half = v.shape[-1] // 2
    return v[..., :half], v[..., half:]


class _Decoder(nn.Module):
    # float32 (rows, N, d) intermediates ``score_all_*`` holds at once;
    # eval/ranking.py caps its chunk by them (a product holds none)
    candidate_intermediates = 0

    def __init__(self, num_relations: int, hidden_channels: int,
                 rel_width: int = None):
        super().__init__()
        self.num_relations = num_relations
        self.hidden_channels = hidden_channels
        self.rel_emb = nn.Parameter(torch.empty(
            num_relations, rel_width or hidden_channels))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.rel_emb.copy_(xavier_uniform(self.rel_emb.shape, generator))

    def score_neg(self, z, neg_src, neg_dst, rel):
        """(K, E) negative sets sharing the batch's (E,) relation column;
        the relation rows follow z's type. Returns float32."""
        k, e = neg_src.shape
        h = take_rows(z, neg_src.reshape(-1)).reshape(k, e, -1)
        t = take_rows(z, neg_dst.reshape(-1)).reshape(k, e, -1)
        r = take_rows(self.rel_emb, rel).to(z.dtype)
        return self._combine(h, r[None], t).float()

    def _combine(self, h, r, t):  # pragma: no cover - overridden
        raise NotImplementedError


class TransE(_Decoder):
    """score = -|| L1norm(h) + r - L1norm(t) ||_1."""

    candidate_intermediates = 2     # the difference and its absolute value

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        bound = 6.0 / math.sqrt(self.hidden_channels)
        emb = torch.empty(self.rel_emb.shape).uniform_(-bound, bound,
                                                       generator=generator)
        self.rel_emb.copy_(emb / emb.norm(dim=-1, keepdim=True))

    @staticmethod
    def _l1_normalize(v):
        return v / v.abs().sum(-1, keepdim=True).clamp(min=1e-12)

    def _combine(self, h, r, t):
        h = self._l1_normalize(h)
        t = self._l1_normalize(t)
        return -torch.sum((h + r - t).abs(), dim=-1)

    def score_neg_sorted(self, z, neg_src, neg_dst, rel, dst_sorted=False):
        fn = transe_neg_scores_ds if dst_sorted else transe_neg_scores
        return fn(z, neg_src, neg_dst, rel, self.rel_emb)

    def score(self, z, head, tail, rel, tail_sorted: bool = False):
        h = self._l1_normalize(take_rows(z, head))
        t = self._l1_normalize(_tail_take(z, tail, tail_sorted))
        r = take_rows(self.rel_emb, rel)
        return -torch.sum((h + r - t).abs(), dim=-1)

    def score_all_tails(self, z, head, rel):
        zn = self._l1_normalize(z)
        hr = take_rows(zn, head) + take_rows(self.rel_emb, rel)
        return -torch.sum((hr[:, None, :] - zn[None]).abs(), dim=-1)

    def score_all_heads(self, z, tail, rel):
        zn = self._l1_normalize(z)
        rt = take_rows(self.rel_emb, rel) - take_rows(zn, tail)
        return -torch.sum((zn[None] + rt[:, None, :]).abs(), dim=-1)


class DistMult(_Decoder):
    """score = Σ h·r·t."""

    def _combine(self, h, r, t):
        return torch.sum(h * r * t, dim=-1)

    def score_neg_sorted(self, z, neg_src, neg_dst, rel, dst_sorted=False):
        """(K·E,) float32 scores of slots with ascending int32 ``neg_src``
        and per-slot int32 relation ids (ops/negscore.py); ``dst_sorted``:
        ``neg_dst`` is band-narrow per chunk (the "sorted2" sampler), which
        the dual-sorted kernels take."""
        fn = distmult_neg_scores_ds if dst_sorted else distmult_neg_scores
        return fn(z, neg_src, neg_dst, rel, self.rel_emb)

    def score(self, z, head, tail, rel, tail_sorted: bool = False):
        """Per-edge scores. ``tail_sorted``: the tails ascend (the "dst"
        layout), so the tail gather's backward runs on the sorted
        segment-sum."""
        h = take_rows(z, head)
        t = _tail_take(z, tail, tail_sorted)
        r = take_rows(self.rel_emb, rel)
        return torch.sum(h * r * t, dim=-1)

    def score_all_tails(self, z, head, rel):
        """(E, N) scores of every node as the tail of (head, rel)."""
        return (take_rows(z, head) * take_rows(self.rel_emb, rel)) @ z.T

    def score_all_heads(self, z, tail, rel):
        """(E, N) scores of every node as the head of (rel, tail)."""
        return (take_rows(z, tail) * take_rows(self.rel_emb, rel)) @ z.T


class ComplEx(_Decoder):
    """Re(<h, r, conj(t)>) with half-width complex embeddings:
    ``rel_emb[:, :d/2]`` is the real part, ``rel_emb[:, d/2:]`` the
    imaginary part, matching z's halves."""

    def _combine(self, h, r, t):
        h_re, h_im = _halves(h)
        t_re, t_im = _halves(t)
        r_re, r_im = _halves(r)
        s = (h_re * r_re - h_im * r_im) * t_re
        s = s + (h_re * r_im + h_im * r_re) * t_im
        return torch.sum(s, dim=-1)

    def score_neg_sorted(self, z, neg_src, neg_dst, rel, dst_sorted=False):
        fn = complex_neg_scores_ds if dst_sorted else complex_neg_scores
        return fn(z, neg_src, neg_dst, rel, self.rel_emb)

    def score(self, z, head, tail, rel, tail_sorted: bool = False):
        return self._combine(take_rows(z, head), take_rows(self.rel_emb, rel),
                             _tail_take(z, tail, tail_sorted))

    def score_all_tails(self, z, head, rel):
        h_re, h_im = _halves(take_rows(z, head))
        r_re, r_im = _halves(take_rows(self.rel_emb, rel))
        z_re, z_im = _halves(z)
        a = h_re * r_re - h_im * r_im                   # (E, d/2)
        b = h_re * r_im + h_im * r_re
        return a @ z_re.T + b @ z_im.T

    def score_all_heads(self, z, tail, rel):
        t_re, t_im = _halves(take_rows(z, tail))
        r_re, r_im = _halves(take_rows(self.rel_emb, rel))
        z_re, z_im = _halves(z)
        a = t_re * r_re + t_im * r_im                   # coeff of h_re
        b = t_im * r_re - t_re * r_im                   # coeff of h_im
        return a @ z_re.T + b @ z_im.T


class RotatE(_Decoder):
    """gamma - || h ∘ e^{iθ_r} - t ||_2 over half-width complex pairs; the
    relation parameter is the (R, d/2) phase table θ."""

    candidate_intermediates = 1.5   # three (rows, N, d/2) at the peak

    def __init__(self, num_relations: int, hidden_channels: int,
                 gamma: float = 12.0):
        super().__init__(num_relations, hidden_channels,
                         rel_width=hidden_channels // 2)
        self.gamma = gamma

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.rel_emb.copy_(torch.empty(self.rel_emb.shape).uniform_(
            -math.pi, math.pi, generator=generator))

    def _distance(self, rot_re, rot_im, t):
        t_re, t_im = _halves(t)
        return self.gamma - torch.sum(torch.sqrt(torch.clamp(
            (rot_re - t_re) ** 2 + (rot_im - t_im) ** 2, min=1e-12)), dim=-1)

    def _combine(self, h, r, t):
        h_re, h_im = _halves(h)
        c, s = torch.cos(r), torch.sin(r)
        return self._distance(h_re * c - h_im * s, h_re * s + h_im * c, t)

    def score_neg_sorted(self, z, neg_src, neg_dst, rel, dst_sorted=False):
        """γ plus the kernels' raw score: γ is a constant outside them."""
        fn = rotate_neg_scores_ds if dst_sorted else rotate_neg_scores
        return self.gamma + fn(z, neg_src, neg_dst, rel, self.rel_emb)

    def score(self, z, head, tail, rel, tail_sorted: bool = False):
        return self._combine(take_rows(z, head), take_rows(self.rel_emb, rel),
                             _tail_take(z, tail, tail_sorted))

    def _candidates(self, v_re, v_im, z):
        z_re, z_im = _halves(z)
        dist = torch.sqrt(torch.clamp(
            (v_re[:, None, :] - z_re[None]) ** 2
            + (v_im[:, None, :] - z_im[None]) ** 2, min=1e-12))
        return self.gamma - torch.sum(dist, dim=-1)

    def score_all_tails(self, z, head, rel):
        h_re, h_im = _halves(take_rows(z, head))
        theta = take_rows(self.rel_emb, rel)
        c, s = torch.cos(theta), torch.sin(theta)
        return self._candidates(h_re * c - h_im * s, h_re * s + h_im * c, z)

    def score_all_heads(self, z, tail, rel):
        # |h∘r - t| = |h - t∘conj(r)|: rotate the tail back and compare
        # with every candidate head
        t_re, t_im = _halves(take_rows(z, tail))
        theta = take_rows(self.rel_emb, rel)
        c, s = torch.cos(theta), torch.sin(theta)
        return self._candidates(t_re * c + t_im * s, -t_re * s + t_im * c, z)
