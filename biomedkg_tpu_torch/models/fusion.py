"""Modality fusion (counterpart of biomedkg_tpu/models/fusion.py):
attention fusion, ReDAF and the sinusoidal positional encoding.

The inputs are (N, M, d) stacks of per-modality features (M = 2 for the
LM features of PrimeKG++, M = 1 for GCL-initialised ones); the outputs are
fused (N, d) node features. The attention runs over the M-token modality
axis, so it is two small batched products and a softmax: no kernel of its
own, as in the JAX package, which computes it with einsum. The parameters
keep the JAX package's names and (in, out) layouts (``q.w``, ``q.b``;
ReDAF's ``modal_weights`` (M, 1, d), ``sub_type_emb.table``,
``transform``, ``rel_context``), so ``interop/jax_params.py`` copies the
``fusion`` subtree by name.

ReDAF's dropout takes an explicit boolean keep mask of the weighted
features' shape (``draw_keep`` draws it from a ``torch.Generator``; the
tests inject the JAX package's ``jax.random.bernoulli(key, 0.9, shape)``),
inverted: kept entries are divided by 0.9.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..nn import Linear, dropout, dropout_mask

REDAF_DROPOUT = 0.1
RELATIONAL_CONTEXT = 0.2


def modality_mean(h: torch.Tensor) -> torch.Tensor:
    """(N, d) features: the mean of (N, M, d) ones over the modality axis,
    (N, d) ones as they are."""
    return h.mean(dim=1) if h.dim() == 3 else h


class AttentionFusion(nn.Module):
    """Self-attention over the modality axis, then the mean over it."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.q = Linear(embed_dim, embed_dim)
        self.k = Linear(embed_dim, embed_dim)
        self.v = Linear(embed_dim, embed_dim)

    def init(self, generator: torch.Generator):
        for layer in (self.q, self.k, self.v):
            layer.init(generator)

    def draw_keep(self, x, generator,
                  training: bool) -> Optional[torch.Tensor]:
        return None

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                training: bool = False) -> torch.Tensor:
        q, k, v = self.q(x), self.k(x), self.v(x)
        scale = 1.0 / math.sqrt(q.shape[-1])
        attn = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
        return modality_mean(attn @ v)


class Embedding(nn.Module):
    """A lookup table under the reference's name ``table``; init N(0, 1)."""

    def __init__(self, num: int, dim: int):
        super().__init__()
        self.table = nn.Parameter(torch.empty(num, dim))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        """N(0, 1) drawn on the generator's device, then copied to the
        table's (the module may already be on the card)."""
        self.table.copy_(torch.empty(self.table.shape,
                                     device=generator.device).normal_(
            generator=generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table.index_select(0, ids.reshape(-1)).reshape(
            ids.shape + (self.table.shape[1],))


class ReDAF(nn.Module):
    """Relation-aware dynamic fusion: learned per-modality weights times a
    sigmoid gate of a constant relational context, over the ReLU of a
    transformed input; dropout 0.1, ReLU, the mean over modalities."""

    def __init__(self, embed_dim: int, num_modalities: int = 2):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_modalities = num_modalities
        self.modal_weights = nn.Parameter(
            torch.ones(num_modalities, 1, embed_dim))
        self.sub_type_emb = Embedding(num_modalities, embed_dim)
        self.transform = Linear(embed_dim, embed_dim)
        self.rel_context = Linear(embed_dim, embed_dim)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.modal_weights.fill_(1.0)
        self.sub_type_emb.init(generator)
        self.transform.init(generator)
        self.rel_context.init(generator)

    def _weighted(self, x: torch.Tensor,
                  sub_type_ids: Optional[torch.Tensor]) -> torch.Tensor:
        ctx = torch.full((1, self.embed_dim), RELATIONAL_CONTEXT,
                         dtype=x.dtype, device=x.device)
        zeta = torch.sigmoid(self.rel_context(ctx))
        if sub_type_ids is not None:
            x = x + self.sub_type_emb(sub_type_ids)
        transformed = torch.relu(self.transform(x))
        weights = self.modal_weights.transpose(0, 1)          # (1, M, d)
        return transformed * weights * zeta[None]

    def keep_shape(self, x: torch.Tensor):
        """The shape of the weighted features, which the keep mask takes."""
        return torch.broadcast_shapes(
            x.shape[:-1] + (self.embed_dim,),
            (1, self.num_modalities, self.embed_dim))

    def draw_keep(self, x, generator,
                  training: bool) -> Optional[torch.Tensor]:
        """The dropout's keep mask from ``generator`` (None when not
        training)."""
        if not training:
            return None
        return dropout_mask(self.keep_shape(x), REDAF_DROPOUT, generator,
                            x.device)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                training: bool = False,
                sub_type_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self._weighted(x, sub_type_ids)
        if training:
            if keep is None:
                raise ValueError("ReDAF training needs its keep mask")
            h = dropout(h, keep, REDAF_DROPOUT)
        return modality_mean(torch.relu(h))


class PositionalEncoding(nn.Module):
    """Sinusoidal positional encoding (defined by the reference, unused by
    its pipeline); even widths only, as in the JAX package."""

    def __init__(self, embed_dim: int, dropout: float = 0.1,
                 max_len: int = 5000):
        super().__init__()
        if embed_dim % 2:
            raise ValueError("PositionalEncoding requires an even "
                             f"embed_dim, got {embed_dim}")
        self.dropout = dropout
        position = torch.arange(max_len, dtype=torch.float32)[:, None]
        div = torch.exp(torch.arange(0, embed_dim, 2, dtype=torch.float32)
                        * (-math.log(10000.0) / embed_dim))
        pe = torch.zeros(1, max_len, embed_dim)
        pe[0, :, 0::2] = torch.sin(position * div)
        pe[0, :, 1::2] = torch.cos(position * div)
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                training: bool = False) -> torch.Tensor:
        x = x + self.pe[:, :x.shape[1]]
        if training and self.dropout > 0.0:
            if keep is None:
                raise ValueError("PositionalEncoding training needs its "
                                 "keep mask")
            return dropout(x, keep, self.dropout)
        return x
