"""Model factories (counterpart of biomedkg_tpu/models/factory.py): RGCN
or RGAT (``num_heads`` heads, 1 when None) with any of the four decoders,
keeping the reference's ``"dismult"`` decoder key with ``"distmult"`` as an
alias; and the modality fuser of a ``fuse_method``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .decoders import ComplEx, DistMult, RotatE, TransE
from .encoders import RGAT, RGCN
from .fusion import AttentionFusion, ReDAF

DECODERS = {"dismult": DistMult, "distmult": DistMult, "transe": TransE,
            "complex": ComplEx, "rotate": RotatE}


class GAE(nn.Module):
    """Graph auto-encoder: encode with a GNN, decode triplet scores."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder

    def init(self, generator: torch.Generator):
        self.encoder.init(generator)
        self.decoder.init(generator)

    def encode(self, x, edge_index, edge_type, edge_mask, block_rel=None,
               *, training: bool = False):
        return self.encoder(x, edge_index, edge_type, edge_mask, block_rel,
                            training=training)


class FusionFactory:
    @staticmethod
    def create_fuser(method: Optional[str],
                     embed_dim: int) -> Optional[nn.Module]:
        """AttentionFusion for "attention", ReDAF for "redaf", else None
        (the modules then take the mean over the modality axis)."""
        if method == "attention":
            return AttentionFusion(embed_dim=embed_dim)
        if method == "redaf":
            return ReDAF(embed_dim=embed_dim)
        return None


class KGEModelFactory:
    @staticmethod
    def get_model(encoder_name: str, decoder_name: str, in_dim: int,
                  hidden_dim: int, out_dim: int, num_hidden_layers: int,
                  num_relation: int, num_heads: Optional[int] = None) -> GAE:
        dims = dict(in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim,
                    num_hidden_layers=num_hidden_layers,
                    num_relations=num_relation)
        if encoder_name == "rgcn":
            encoder = RGCN(**dims)
        elif encoder_name == "rgat":
            encoder = RGAT(**dims, num_heads=num_heads or 1)
        else:
            raise ValueError(f"Unknown encoder: {encoder_name!r}")
        if decoder_name not in DECODERS:
            raise ValueError(f"Unknown decoder: {decoder_name!r}")
        decoder = DECODERS[decoder_name](num_relations=num_relation,
                                         hidden_channels=out_dim)
        return GAE(encoder=encoder, decoder=decoder)


def create_kge_model(cfg) -> GAE:
    """The GAE a model config (``cfg.model``'s keys, with
    ``num_relation``) names (the reference's factory.py:104-114)."""
    return KGEModelFactory.get_model(
        encoder_name=cfg.encoder_name, decoder_name=cfg.decoder_name,
        in_dim=cfg.in_dim, hidden_dim=cfg.hidden_dim, out_dim=cfg.out_dim,
        num_hidden_layers=cfg.num_hidden_layers,
        num_relation=cfg.num_relation, num_heads=cfg.num_heads)
