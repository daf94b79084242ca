"""Triplet columns → homogeneous multi-relational graph.

Counterpart of biomedkg_tpu/data/triplet.py::TripletGraph over the numpy
columns of data/synthetic.py, with the same results:

  * node types in ``np.unique`` order; per type the names that occur in the
    rows, sorted, as one contiguous id range (``type_offset``);
  * relations in first-appearance order; each relation's (x_type, y_type)
    signature comes from its first row and only rows matching it are edges;
  * features from the encoder, called once per type in type order.

Vectorised: the reference's per-relation pandas passes take minutes at
PrimeKG scale; here every step is a numpy sort, mask or search.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ..common import clean_name
from ..sampling.csr import CSRGraph
from .synthetic import Triplets


class TripletGraph:
    def __init__(self, columns: Triplets,
                 encoder: Optional[Callable] = None):
        self.columns = columns
        self.encoder = encoder
        (self.graph, self.edge_map_index, self.node_list,
         self.node_type_names, self.node_type_of, self.type_offset,
         self.node_to_global) = self._construct()
        self.data = self.graph

    def _construct(self):
        c = self.columns
        x_type, y_type = c["x_type"], c["y_type"]
        node_types = np.unique(np.concatenate(
            [np.unique(x_type), np.unique(y_type)])).tolist()
        rel_names, rel_first, rel_code = np.unique(
            c["relation"], return_index=True, return_inverse=True)
        order = np.argsort(rel_first)            # first-appearance order

        num_rows = len(x_type)
        x_gid = np.empty(num_rows, np.int64)
        y_gid = np.empty(num_rows, np.int64)
        node_list, features, node_type_ids = [], [], []
        type_offset: Dict[str, int] = {}
        node_to_global: Dict[str, Dict[str, int]] = {}
        offset = 0
        for type_id, node_type in enumerate(node_types):
            x_sel = x_type == node_type
            y_sel = y_type == node_type
            names = np.unique(np.concatenate(
                [c["x_name"][x_sel], c["y_name"][y_sel]]))
            x_gid[x_sel] = np.searchsorted(names, c["x_name"][x_sel]) + offset
            y_gid[y_sel] = np.searchsorted(names, c["y_name"][y_sel]) + offset
            names = names.tolist()
            node_list.extend(names)
            type_offset[node_type] = offset
            node_to_global[node_type] = {
                n: i for i, n in enumerate(names, start=offset)}
            node_type_ids.append(np.full(len(names), type_id, np.int32))
            if self.encoder is not None:
                features.append(
                    np.asarray(self.encoder(names), dtype=np.float32))
            offset += len(names)

        edge_map_index: Dict[int, str] = {}
        src_parts, dst_parts, type_parts = [], [], []
        for edge_id, code in enumerate(order):
            rows = np.flatnonzero(rel_code == code)
            head_t, tail_t = x_type[rows[0]], y_type[rows[0]]
            rows = rows[(x_type[rows] == head_t) & (y_type[rows] == tail_t)]
            src_parts.append(x_gid[rows])
            dst_parts.append(y_gid[rows])
            type_parts.append(np.full(len(rows), edge_id, np.int32))
            edge_map_index[edge_id] = str(rel_names[code])

        empty = np.zeros(0, np.int64)
        edge_index = np.stack([
            np.concatenate(src_parts) if src_parts else empty,
            np.concatenate(dst_parts) if dst_parts else empty,
        ])
        edge_type = (np.concatenate(type_parts) if type_parts
                     else np.zeros(0, np.int32))
        graph = CSRGraph(
            num_nodes=offset,
            edge_index=edge_index,
            edge_type=edge_type,
            num_relations=len(rel_names),
            x=np.concatenate(features, axis=0) if features else None,
        )
        node_type_of = (np.concatenate(node_type_ids) if node_type_ids
                        else np.zeros(0, np.int32))
        clean_types = [clean_name(t) for t in node_types]
        return (graph, edge_map_index, node_list, clean_types,
                node_type_of, type_offset, node_to_global)

    @property
    def num_edge_types(self) -> int:
        return self.graph.num_relations
