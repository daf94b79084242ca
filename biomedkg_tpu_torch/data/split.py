"""Deterministic edge split (counterpart of biomedkg_tpu/data/split.py;
PyG RandomLinkSplit semantics: train and val carry the train edges for
message passing, test carries train+val)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..sampling.csr import CSRGraph


class SplitGraph(NamedTuple):
    graph: CSRGraph               # message-passing edges
    label_edge_index: np.ndarray  # (2, E_sup) supervision edges
    label_edge_type: np.ndarray


def _subgraph(base: CSRGraph, idx: np.ndarray) -> CSRGraph:
    return CSRGraph(
        num_nodes=base.num_nodes,
        edge_index=base.edge_index[:, idx],
        edge_type=base.edge_type[idx],
        num_relations=base.num_relations,
        x=base.x,
    )


def random_link_split(graph: CSRGraph, val_ratio: float, test_ratio: float,
                      seed: int = 0):
    """Returns (train, val, test) SplitGraphs."""
    rng = np.random.default_rng(seed)
    num_edges = graph.num_edges
    perm = rng.permutation(num_edges)
    n_val = int(num_edges * val_ratio)
    n_test = int(num_edges * test_ratio)
    val_idx = perm[:n_val]
    test_idx = perm[n_val:n_val + n_test]
    train_idx = perm[n_val + n_test:]

    train_mp = _subgraph(graph, train_idx)
    test_mp = _subgraph(graph, np.concatenate([train_idx, val_idx]))

    train = SplitGraph(train_mp, graph.edge_index[:, train_idx],
                       graph.edge_type[train_idx])
    val = SplitGraph(train_mp, graph.edge_index[:, val_idx],
                     graph.edge_type[val_idx])
    test = SplitGraph(test_mp, graph.edge_index[:, test_idx],
                      graph.edge_type[test_idx])
    return train, val, test
