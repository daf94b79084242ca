"""Graph-contrastive models DGI, GRACE and GGD (counterpart of
biomedkg_tpu/models/gcl.py) on static-shape padded batches.

The augmentations are masks, so no shape changes: feature masking (PyG
``mask_feature(mode='all')``) is an entrywise keep mask, edge dropout ANDs
the edge mask with a keep mask, and the row-permutation corruption shuffles
the real rows only (pads stay pads).

Every random draw of a forward is one entry of a ``draws`` dict that
``draw`` fills from a ``torch.Generator``, or that the caller builds (the
tests replay the reference's key splits into it): feature and edge keep
masks, permutations, GGD's ``do_aug`` and one list of dropout keep masks
per encode. Each model makes two encodes per forward. GRACE's clean view
``z`` feeds no loss, so the reference's ``jit`` never computes it, and the
port does not either.

``dtype`` is the compute policy: the parameters are rounded to it at use
(the float32 masters keep the gradients), as the reference casts its
parameter tree.

Under a dp × tp step (``tp``, a parallel/collectives.py
``TensorParallel``) every ``Linear``'s ``w`` / ``b`` and the encoder's
are the rank's columns: the encoder returns its columns of z, and each
head gathers its input's rows over tp before its product onto the rank's
columns (``_linear``). DGI's and GGD's scores are sums over the ranks'
columns; GRACE's projections come out column-split, and the module's
InfoNCE gathers them whole (training/gcl_module.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..nn import Linear, dropout_mask, mask_feature, uniform_fan
from .encoders import DROPOUT, GCNEncoder

FEATURE_MASK = EDGE_DROP = 0.4


def masked_permutation(node_mask: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """A random permutation of the real (first) rows; pad rows stay in
    place. Real nodes occupy rows [0, num_real) (sampling/batch.py), so
    random keys for real rows sort before the ordered keys of pads."""
    n = node_mask.shape[0]
    u = torch.rand(n, generator=generator, device=node_mask.device)
    tail = 2.0 + torch.arange(n, device=node_mask.device) / n
    return torch.argsort(torch.where(node_mask, u, tail), stable=True)


def drop_edges(edge_mask: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    return edge_mask & keep


def _linear(layer: Linear, h, dtype, tp=None):
    """``layer(h)``; under ``tp`` h is column-split and the layer holds the
    rank's output columns, so h's rows are gathered first."""
    return layer(h if tp is None else tp.gather_cols(h), dtype)


def _keep(shape, p: float, generator: torch.Generator, device):
    """A keep mask, True with probability 1 - p."""
    return torch.rand(shape, generator=generator, device=device) >= p


class _GCLModel(nn.Module):
    def __init__(self, encoder: GCNEncoder, hidden_dim: int):
        super().__init__()
        self.encoder = encoder
        self.hidden_dim = hidden_dim

    def _encode(self, x, edge_index, edge_mask, dropout_masks, training,
                dtype, tp=None):
        return self.encoder(x, edge_index, edge_mask, training=training,
                            compute_dtype=dtype, dropout_masks=dropout_masks,
                            tp=tp)

    def _dropout_masks(self, num_nodes: int, generator, device,
                       training: bool) -> Optional[List[torch.Tensor]]:
        """One encode's dropout keep masks (None outside training)."""
        if not (training and self.encoder.drop_out):
            return None
        return [dropout_mask((num_nodes, dout), DROPOUT, generator, device)
                for _, dout in self.encoder.dims[:-1]]


class DGI(_GCLModel):
    """Deep Graph Infomax: z = enc(x); summary g = project(sigmoid(masked
    mean of z)); negatives encode the row-permuted features."""

    def __init__(self, encoder: GCNEncoder, hidden_dim: int):
        super().__init__(encoder, hidden_dim)
        self.project = Linear(hidden_dim, hidden_dim)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.encoder.init(generator)
        self.project.init(generator)
        # PyG's ``uniform(hidden_dim, weight)``
        self.project.w.copy_(uniform_fan(self.project.w.shape,
                                         self.hidden_dim, generator))

    def draw(self, generator, x, edge_mask, node_mask, training) -> Dict:
        n, dev = node_mask.shape[0], node_mask.device
        return {"perm": masked_permutation(node_mask, generator),
                "dropout": [self._dropout_masks(n, generator, dev, training)
                            for _ in range(2)]}

    def forward(self, x, edge_index, edge_mask, node_mask, draws: Dict, *,
                training: bool = False, dtype=torch.float32, tp=None):
        """(z, g, zn) (under ``tp`` the rank's columns of each)."""
        z = self._encode(x, edge_index, edge_mask, draws["dropout"][0],
                         training, dtype, tp)
        denom = node_mask.sum().clamp(min=1).float()
        mean = (z * node_mask[:, None].to(z.dtype)).sum(
            0, keepdim=True).float() / denom
        if tp is not None:
            mean = tp.gather_cols(mean)
        g = self.project(torch.sigmoid(mean), dtype)
        xn = x.index_select(0, draws["perm"])
        zn = self._encode(xn, edge_index, edge_mask, draws["dropout"][1],
                          training, dtype, tp)
        return z, g, zn


class GRACE(_GCLModel):
    """GRACE: two views, each with feature masking and edge dropout (p =
    0.4), encoded by the shared GCN; ``project`` is fc2(elu(fc1(z)))."""

    def __init__(self, encoder: GCNEncoder, hidden_dim: int, proj_dim: int):
        super().__init__(encoder, hidden_dim)
        self.fc1 = Linear(hidden_dim, proj_dim)
        self.fc2 = Linear(proj_dim, hidden_dim)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.encoder.init(generator)
        self.fc1.init(generator)
        self.fc2.init(generator)

    def draw(self, generator, x, edge_mask, node_mask, training) -> Dict:
        n, dev = node_mask.shape[0], node_mask.device
        return {
            "feat_keep": [_keep(x.shape, FEATURE_MASK, generator, dev)
                          for _ in range(2)],
            "edge_keep": [_keep(edge_mask.shape, EDGE_DROP, generator, dev)
                          for _ in range(2)],
            "dropout": [self._dropout_masks(n, generator, dev, training)
                        for _ in range(2)]}

    def forward(self, x, edge_index, edge_mask, node_mask, draws: Dict, *,
                training: bool = False, dtype=torch.float32, tp=None):
        """(z1, z2), the two views' embeddings."""
        return tuple(
            self._encode(mask_feature(x, draws["feat_keep"][v]), edge_index,
                         drop_edges(edge_mask, draws["edge_keep"][v]),
                         draws["dropout"][v], training, dtype, tp)
            for v in range(2))

    def project(self, z, dtype=torch.float32, tp=None):
        return _linear(self.fc2, torch.nn.functional.elu(
            _linear(self.fc1, z, dtype, tp)), dtype, tp)


class GGD(_GCLModel):
    """Group Graph Discrimination: with probability ``aug_p`` feature
    masking and edge dropout, then clean against row-permuted embeddings
    through an ``n_proj``-layer MLP summed over features."""

    def __init__(self, encoder: GCNEncoder, hidden_dim: int, n_proj: int,
                 aug_p: float):
        super().__init__(encoder, hidden_dim)
        self.aug_p = aug_p
        self.mlp = nn.ModuleList(Linear(hidden_dim, hidden_dim)
                                 for _ in range(n_proj))

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        self.encoder.init(generator)
        for layer in self.mlp:
            layer.init(generator)

    def draw(self, generator, x, edge_mask, node_mask, training) -> Dict:
        n, dev = node_mask.shape[0], node_mask.device
        return {
            "do_aug": torch.rand((), generator=generator, device=dev)
            < self.aug_p,
            "feat_keep": _keep(x.shape, FEATURE_MASK, generator, dev),
            "edge_keep": _keep(edge_mask.shape, EDGE_DROP, generator, dev),
            "perm": masked_permutation(node_mask, generator),
            "dropout": [self._dropout_masks(n, generator, dev, training)
                        for _ in range(2)]}

    def _project(self, h, dtype, tp=None):
        for layer in self.mlp[:-1]:
            h = torch.relu(_linear(layer, h, dtype, tp))
        out = _linear(self.mlp[-1], h, dtype, tp)
        if tp is None:
            return out.sum(1)
        return tp.sum(out.sum(1, dtype=torch.float32)).to(out.dtype)

    def forward(self, x, edge_index, edge_mask, node_mask, draws: Dict, *,
                training: bool = False, dtype=torch.float32, tp=None):
        """(pos_h, neg_h), the summed projections. ``do_aug`` is a device
        bool, chosen by ``where`` (no host sync)."""
        do_aug = draws["do_aug"]
        x_aug = torch.where(do_aug, mask_feature(x, draws["feat_keep"]), x)
        em_aug = torch.where(do_aug,
                             drop_edges(edge_mask, draws["edge_keep"]),
                             edge_mask)
        pos_z = self._encode(x_aug, edge_index, em_aug, draws["dropout"][0],
                             training, dtype, tp)
        xn = x_aug.index_select(0, draws["perm"])
        neg_z = self._encode(xn, edge_index, em_aug, draws["dropout"][1],
                             training, dtype, tp)
        return (self._project(pos_z, dtype, tp),
                self._project(neg_z, dtype, tp))
