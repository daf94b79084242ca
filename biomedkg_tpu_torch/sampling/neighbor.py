"""Neighbour fan-out sampling into padded batches (counterpart of
biomedkg_tpu/sampling/neighbor.py).

PyG ``NeighborLoader`` semantics as the reference uses them: seed nodes
first in the output order, per hop at most k incoming edges of each
frontier node drawn without replacement, and the subgraph of the sampled
edges only. The hop runs in the native library (partial Fisher-Yates) or,
without it, as numpy's Gumbel-top-k over the concatenated CSR slices; for
one seed both give the reference's stream byte for byte.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..utils import profiling
from .batch import GraphBatch, pad_graph_batch
from .csr import CSRGraph, ranges_concat
from .saint import _round_up


def sample_in_neighbors(graph: CSRGraph, frontier: np.ndarray, k: int,
                        rng: np.random.Generator):
    """At most ``k`` incoming edges of each frontier node (k = -1: all).

    Returns (src_global, frontier_pos, edge_type).
    """
    from . import native

    indptr, nbr, etypes, _ = graph.in_csr()
    frontier = np.ascontiguousarray(frontier, np.int64)
    lib = native.get_lib()
    if lib is not None:
        deg = indptr[frontier + 1] - indptr[frontier]
        cap = int((np.minimum(deg, k) if k >= 0 else deg).sum())
        src = np.empty(max(cap, 1), np.int64)
        fpos = np.empty(max(cap, 1), np.int64)
        et = np.empty(max(cap, 1), np.int32)
        seed = int(rng.integers(0, 2**63 - 1))
        m = lib.sample_neighbors(
            native.i64(indptr), native.i64(nbr), native.i32(etypes),
            native.i64(frontier), len(frontier), k, seed,
            native.i64(src), native.i64(fpos), native.i32(et))
        return src[:m], fpos[:m], et[:m]
    starts = indptr[frontier]
    counts = indptr[frontier + 1] - starts
    pos = ranges_concat(starts, counts)
    seg = np.repeat(np.arange(len(frontier)), counts)
    if k >= 0 and len(pos):
        keys = rng.random(len(pos))
        order = np.lexsort((keys, seg))
        seg_sorted = seg[order]
        seg_counts = np.bincount(seg_sorted, minlength=len(frontier))
        seg_starts = np.concatenate([[0], np.cumsum(seg_counts)[:-1]])
        rank = np.arange(len(order)) - seg_starts[seg_sorted]
        sel = order[rank < k]
        pos, seg = pos[sel], seg[sel]
    return nbr[pos], seg, etypes[pos]


class NeighborSampler:
    """Multi-hop fan-out around a seed set; seeds take local ids [0, S)."""

    def __init__(self, graph: CSRGraph, fanouts: List[int],
                 rng: Optional[np.random.Generator] = None):
        self.graph = graph
        self.fanouts = fanouts
        self.rng = rng or np.random.default_rng(0)
        self._lookup = np.full(graph.num_nodes, -1, dtype=np.int64)

    def sample_raw(self, seeds: np.ndarray):
        """(global ids of the local nodes, local edge_index (2, M) int32,
        edge_type (M,) int32)."""
        lookup = self._lookup
        nodes = [np.asarray(seeds, dtype=np.int64)]
        lookup[seeds] = np.arange(len(seeds))
        num_local = len(seeds)
        frontier = nodes[0]
        src_parts, dst_parts, et_parts = [], [], []
        for k in self.fanouts:
            if len(frontier) == 0:
                break
            src_g, f_pos, et = sample_in_neighbors(
                self.graph, frontier, k, self.rng)
            dst_local = lookup[frontier][f_pos]
            is_new = lookup[src_g] < 0
            new_nodes = np.unique(src_g[is_new])
            lookup[new_nodes] = np.arange(num_local,
                                          num_local + len(new_nodes))
            num_local += len(new_nodes)
            nodes.append(new_nodes)
            src_parts.append(lookup[src_g])
            dst_parts.append(dst_local)
            et_parts.append(et)
            frontier = new_nodes
        all_nodes = np.concatenate(nodes)
        lookup[all_nodes] = -1  # restored for the next call
        if src_parts:
            ei = np.stack([np.concatenate(src_parts),
                           np.concatenate(dst_parts)]).astype(np.int32)
            et = np.concatenate(et_parts).astype(np.int32)
        else:
            ei = np.zeros((2, 0), np.int32)
            et = np.zeros(0, np.int32)
        return all_nodes, ei, et


class NeighborBatchLoader:
    """Epoch iterator over seed batches, each packed into one static
    (node_budget, edge_budget) envelope.

    Missing budgets are probed from four seed batches of the graph (a
    separate random stream): 1.5× the worst node count plus the dummy slot,
    rounded to 128, and 1.5× the worst block-padded edge count, rounded to
    lcm(block_size, 2048) as the reference aligns it. A batch whose nodes
    overflow keeps the seeds and the earliest-discovered neighbours (and
    raises when not even the seeds fit); ``dropped_edges`` counts every
    sampled edge that did not make it into a batch.
    """

    def __init__(self, graph: CSRGraph, batch_size: int, fanouts: List[int],
                 shuffle: bool = False, block_size: int = 256, seed: int = 0,
                 node_budget: Optional[int] = None,
                 edge_budget: Optional[int] = None,
                 with_features: bool = True,
                 edge_layout: str = "relation"):
        self.graph = graph
        self.with_features = with_features
        self.edge_layout = edge_layout
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.block_size = block_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.sampler = NeighborSampler(graph, fanouts, self.rng)
        self.dropped_edges = 0
        self.node_budget = node_budget
        self.edge_budget = edge_budget
        if node_budget is None or edge_budget is None:
            self._probe_budgets(seed)

    def _probe_budgets(self, seed: int, probes: int = 4):
        rng = np.random.default_rng(seed + 15485863)
        probe_sampler = NeighborSampler(self.graph, self.sampler.fanouts, rng)
        worst_nodes, worst_edges = 1, self.block_size
        n = self.graph.num_nodes
        for _ in range(probes):
            seeds = rng.choice(n, size=min(self.batch_size, n), replace=False)
            nodes, _, et = probe_sampler.sample_raw(seeds)
            counts = np.bincount(et, minlength=self.graph.num_relations)
            padded = int(np.sum(
                (counts + self.block_size - 1) // self.block_size
            ) * self.block_size)
            worst_nodes = max(worst_nodes, len(nodes))
            worst_edges = max(worst_edges, padded)
        if self.node_budget is None:
            self.node_budget = _round_up(int(worst_nodes * 1.5) + 1, 128)
        if self.edge_budget is None:
            self.edge_budget = _round_up(
                int(worst_edges * 1.5), int(np.lcm(self.block_size, 2048)))

    def set_epoch(self, epoch: int):
        """Re-key the stream for ``epoch`` (the sampler shares the rng)."""
        self.rng = np.random.default_rng((self.seed, epoch))
        self.sampler.rng = self.rng

    def _make_batch(self, seeds: np.ndarray) -> GraphBatch:
        with profiling.span("sample.hops"):
            nodes, ei, et = self.sampler.sample_raw(seeds)
        before = et.shape[0]  # counted before the node-budget truncation
        if len(nodes) > self.node_budget - 1:
            keep_n = self.node_budget - 1
            if keep_n < len(seeds):
                raise ValueError(
                    f"node_budget={self.node_budget} cannot even hold the "
                    f"{len(seeds)} seed nodes — batch rows [0, num_seed) "
                    "would be pads")
            keep_mask = (ei[0] < keep_n) & (ei[1] < keep_n)
            ei, et = ei[:, keep_mask], et[keep_mask]
            nodes = nodes[:keep_n]
        if self.with_features:
            x = self.graph.x[nodes] if self.graph.x is not None else \
                np.zeros((len(nodes), 1), np.float32)
        else:
            x = None
        with profiling.span("sample.pad"):
            batch = pad_graph_batch(
                x, ei, et, num_relations=self.graph.num_relations,
                node_budget=self.node_budget, edge_budget=self.edge_budget,
                block_size=self.block_size, num_seed=len(seeds),
                rng=self.rng, node_ids=nodes, num_nodes_hint=len(nodes),
                layout=self.edge_layout)
        self.dropped_edges += before - int(batch.edge_mask.sum())
        return batch

    def __iter__(self):
        n = self.graph.num_nodes
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for i in range(0, n, self.batch_size):
            yield self._make_batch(order[i:i + self.batch_size])

    def __len__(self):
        return -(-self.graph.num_nodes // self.batch_size)
