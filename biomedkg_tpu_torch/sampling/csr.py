"""Host-side multi-relational graph (counterpart of
biomedkg_tpu/sampling/csr.py::CSRGraph).

Only the container is ported so far: the full-graph serving path needs no
CSR slices. The CSR builders and ``induced_subgraph`` come with the SAINT
and neighbour samplers (ROADMAP.md queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class CSRGraph:
    num_nodes: int
    edge_index: np.ndarray          # (2, E) int32/int64
    edge_type: np.ndarray           # (E,) int32
    num_relations: int
    x: Optional[np.ndarray] = None  # (N, D) node features

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]
