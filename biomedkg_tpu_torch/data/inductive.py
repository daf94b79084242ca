"""Unseen-node (inductive) split (counterpart of
biomedkg_tpu/data/inductive.py), host numpy with the reference's draws in
the reference's order, so one seed gives its arrays byte for byte.

``unseen_ratio`` of the nodes (optionally only those of given node types)
is held out. Every edge touching a held-out node leaves every
message-passing graph and becomes val/test supervision only; the seen-only
edges get the transductive ``random_link_split``, so training is
unchanged. At evaluation the model encodes the seen-only graph, where the
held-out nodes are isolated and embedded from their features alone
(eval/inductive.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from ..sampling.csr import CSRGraph
from .split import SplitGraph, random_link_split


class InductiveSplit(NamedTuple):
    # the transductive split of the seen-only edges (the training path)
    train: SplitGraph
    val: SplitGraph
    test: SplitGraph
    unseen_nodes: np.ndarray      # (U,) global node ids, ascending
    unseen_mask: np.ndarray       # (N,) bool
    # every seen-only edge: the cold-start eval's message-passing graph
    eval_graph: CSRGraph
    # supervision edges touching at least one unseen node
    val_edge_index: np.ndarray    # (2, Ev)
    val_edge_type: np.ndarray     # (Ev,)
    test_edge_index: np.ndarray   # (2, Et)
    test_edge_type: np.ndarray    # (Et,)


def unseen_node_split(
    graph: CSRGraph,
    unseen_ratio: float,
    val_ratio: float,
    test_ratio: float,
    seed: int = 0,
    node_pool: Optional[np.ndarray] = None,
) -> InductiveSplit:
    """Node-holdout split. ``unseen_ratio`` of ``node_pool`` (default: all
    nodes) is held out, at least one and never all of it; ``val_ratio`` /
    ``test_ratio`` split the seen-only edges (``random_link_split``) and
    give the val:test share of the unseen-touching edges (all test when
    both are 0)."""
    rng = np.random.default_rng(seed)
    pool = (np.arange(graph.num_nodes, dtype=np.int64)
            if node_pool is None else np.asarray(node_pool, np.int64))
    if len(pool) < 2:
        raise ValueError(
            f"node_pool needs >= 2 candidates to hold some out and keep "
            f"some seen (got {len(pool)})")
    n_unseen = min(max(int(round(unseen_ratio * len(pool))), 1),
                   len(pool) - 1)
    unseen = np.sort(rng.choice(pool, size=n_unseen, replace=False))
    unseen_mask = np.zeros(graph.num_nodes, bool)
    unseen_mask[unseen] = True

    src, dst = graph.edge_index
    touching = unseen_mask[src] | unseen_mask[dst]
    seen_idx = np.nonzero(~touching)[0]
    held_idx = np.nonzero(touching)[0]

    seen_graph = CSRGraph(
        num_nodes=graph.num_nodes,
        edge_index=graph.edge_index[:, seen_idx],
        edge_type=graph.edge_type[seen_idx],
        num_relations=graph.num_relations,
        x=graph.x,
    )
    train, val, test = random_link_split(seen_graph, val_ratio, test_ratio,
                                         seed=seed)

    held_idx = rng.permutation(held_idx)
    denom = val_ratio + test_ratio
    n_val = int(len(held_idx) * (val_ratio / denom)) if denom > 0 else 0
    v_idx, t_idx = held_idx[:n_val], held_idx[n_val:]

    return InductiveSplit(
        train=train, val=val, test=test,
        unseen_nodes=unseen, unseen_mask=unseen_mask,
        eval_graph=seen_graph,
        val_edge_index=graph.edge_index[:, v_idx],
        val_edge_type=graph.edge_type[v_idx],
        test_edge_index=graph.edge_index[:, t_idx],
        test_edge_type=graph.edge_type[t_idx],
    )


def node_pool_for_types(node_type_of: np.ndarray,
                        type_names: Sequence[str],
                        wanted: Sequence[str]) -> np.ndarray:
    """Global node ids whose (cleaned) type name is in ``wanted``."""
    wanted_ids = [i for i, t in enumerate(type_names) if t in set(wanted)]
    if not wanted_ids:
        raise ValueError(
            f"unseen_node_types {list(wanted)!r} match none of "
            f"{list(type_names)!r}")
    mask = np.isin(np.asarray(node_type_of), np.asarray(wanted_ids))
    return np.nonzero(mask)[0].astype(np.int64)
