"""PrimeKG data module (counterpart of
biomedkg_tpu/data/modules.py::PrimeKGModule).

What the serving path needs: ``setup`` (graph build and, for
``stage="split"``, the link split), ``edge_layout``, ``data``, ``graph`` and
``edge_map_index``. The SAINT / neighbour loaders, the inductive split and
the DPI module come in later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import List, Optional

from . import node_encoders as node
from .primekg import PrimeKG
from .split import random_link_split


def get_node_encode_method(node_init_method: Optional[str], embed_dim: int):
    if node_init_method is None or node_init_method == "random":
        return node.RandomEncode(embed_dim=embed_dim)
    if node_init_method in ("lm", "gcl"):
        raise NotImplementedError(
            f"node_init_method={node_init_method!r} is not ported yet "
            "(ROADMAP.md queue 1: Stage A / Stage B encoders)")
    raise ValueError(f"Unknown node_init_method: {node_init_method!r}")


class PrimeKGModule:
    def __init__(self, data_dir: str, embed_dim: int, node_type: List[str],
                 batch_size: int, val_ratio: float, test_ratio: float,
                 node_init_method: Optional[str] = None,
                 seed: int = 42):
        self.data_dir = data_dir
        self.node_type = node_type
        self.batch_size = batch_size
        self.val_ratio = val_ratio
        self.test_ratio = test_ratio
        self.seed = seed
        self.node_init_method = node_init_method
        # "relation" or "dst" — must match the model's ``edge_layout``
        self.edge_layout = "relation"
        self.encoder = get_node_encode_method(node_init_method, embed_dim)

    def setup(self, stage: str = "split"):
        self.primekg = PrimeKG(data_dir=self.data_dir,
                               node_type=self.node_type,
                               encoder=self.encoder)
        self.data = self.primekg
        self.edge_map_index = self.primekg.edge_map_index
        self.graph = self.primekg.graph
        if stage == "split":
            self.train_data, self.val_data, self.test_data = \
                random_link_split(self.graph, self.val_ratio,
                                  self.test_ratio, seed=self.seed)
