"""Loaders (counterpart of biomedkg_tpu/sampling/loaders.py):
``SaintRandomWalkLoader`` (KGE training batches), ``NeighborBatchLoader``
(fan-out batches, sampling/neighbor.py) and ``FullGraphLoader`` (the whole
graph as one padded batch, for serving and export). The background
prefetch comes later (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np

from .batch import GraphBatch, pad_graph_batch
from .csr import CSRGraph
from .neighbor import NeighborBatchLoader  # noqa: F401  (re-exported)
from .saint import SaintRandomWalkSampler, _round_up


# the reference's loader name; one epoch = num_steps batches
SaintRandomWalkLoader = SaintRandomWalkSampler


class FullGraphLoader:
    """Single padded batch containing the entire graph."""

    def __init__(self, graph: CSRGraph, block_size: int = 256,
                 edge_layout: str = "relation"):
        self.graph = graph
        self.block_size = block_size
        self.edge_layout = edge_layout
        self._batch = None

    def batch(self) -> GraphBatch:
        if self._batch is None:
            g = self.graph
            counts = np.bincount(g.edge_type, minlength=g.num_relations)
            edge_budget = int(np.sum(
                (counts + self.block_size - 1) // self.block_size
            ) * self.block_size)
            edge_budget = max(edge_budget, self.block_size)
            # the reference aligns to lcm(block_size, 2048) for its
            # training-side negative chunks; kept so both packages pack the
            # same envelope
            lcm = int(np.lcm(self.block_size, 2048))
            edge_budget = -(-edge_budget // lcm) * lcm
            x = g.x if g.x is not None else np.zeros((g.num_nodes, 1),
                                                     np.float32)
            self._batch = pad_graph_batch(
                x, g.edge_index, g.edge_type, num_relations=g.num_relations,
                node_budget=_round_up(g.num_nodes + 1, 128),
                edge_budget=edge_budget, block_size=self.block_size,
                num_seed=g.num_nodes,
                node_ids=np.arange(g.num_nodes, dtype=np.int32),
                layout=self.edge_layout)
        return self._batch

    def __iter__(self):
        yield self.batch()

    def __len__(self):
        return 1
