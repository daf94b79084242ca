"""GraphSAINT random-walk sampling → fixed-envelope padded batches
(counterpart of biomedkg_tpu/sampling/saint.py, host numpy and the native
library, the same arrays for the same seed).

PyG GraphSAINTRandomWalkSampler semantics: uniform roots with replacement,
walks over out-neighbours (dead ends stay in place), node set = unique
visited nodes, induced subgraph. Every batch is packed into one static
envelope (sampling/batch.py), probed once from a few batches; with
``fill_target`` the sampler tops up walk roots until realised edges fill
that share of the envelope.
"""

from __future__ import annotations

import numpy as np

from ..utils import profiling
from . import native
from .batch import GraphBatch, pad_graph_batch
from .csr import CSRGraph


def random_walk(graph: CSRGraph, roots: np.ndarray, walk_length: int,
                rng: np.random.Generator) -> np.ndarray:
    """(B, walk_length+1) visited-node matrix; dead ends repeat the node."""
    indptr, nbr, _, _ = graph.out_csr()
    lib = native.get_lib()
    if lib is not None:
        roots_c = np.ascontiguousarray(roots, np.int64)
        walks = np.empty((len(roots_c), walk_length + 1), np.int64)
        seed = int(rng.integers(0, 2**63 - 1))
        lib.random_walk(native.i64(indptr), native.i64(nbr),
                        native.i64(roots_c), len(roots_c), walk_length,
                        seed, native.i64(walks))
        return walks
    walks = np.empty((len(roots), walk_length + 1), dtype=np.int64)
    walks[:, 0] = roots
    cur = roots.astype(np.int64)
    if len(nbr) == 0:           # edgeless graph: every walk stays put
        walks[:, 1:] = cur[:, None]
        return walks
    for step in range(walk_length):
        starts = indptr[cur]
        deg = indptr[cur + 1] - starts
        offs = (rng.random(len(cur)) * np.maximum(deg, 1)).astype(np.int64)
        # final clamp: a zero-out-degree node whose CSR start == E (sink
        # after the last source id) would gather nbr[E] out of bounds
        # before the deg>0 select masks it away
        idx = np.minimum(starts + np.minimum(offs, np.maximum(deg - 1, 0)),
                         len(nbr) - 1)
        cur = np.where(deg > 0, nbr[idx], cur)
        walks[:, step + 1] = cur
    return walks


class SaintRandomWalkSampler:
    def __init__(self, graph: CSRGraph, batch_size: int, walk_length: int,
                 num_steps: int, block_size: int = 256,
                 seed: int = 0, edge_budget: int | None = None,
                 node_budget: int | None = None,
                 with_features: bool = True, edge_layout: str = "relation",
                 fill_target: float | None = None):
        self.graph = graph
        # False → batches carry global node_ids only; features gathered from
        # a device-resident table (sampling/batch.py GraphBatch docstring)
        self.with_features = with_features
        self.edge_layout = edge_layout
        self.batch_size = batch_size
        self.walk_length = walk_length
        self.num_steps = num_steps
        self.block_size = block_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.dropped_edges = 0
        # Occupancy-aware packing: the static envelope makes step cost
        # constant regardless of realized edges, so every empty slot is
        # padded-slot waste. With ``fill_target=f`` the sampler TOPS UP walk
        # roots per batch until realized edge capacity reaches
        # f·edge_budget (or budgets bind) — same envelope, ~f occupancy.
        self.fill_target = fill_target
        if fill_target is not None and not 0.0 < fill_target <= 1.0:
            raise ValueError(f"fill_target must be in (0, 1]: {fill_target}")

        max_nodes = batch_size * (walk_length + 1) + 1
        if fill_target is None:
            self.node_budget = node_budget or _round_up(max_nodes, 128)
            self.edge_budget = edge_budget or self._probe_edge_budget(seed)
            self.max_roots = batch_size
        else:
            probed_budget, mean_raw = self._probe_edge_budget(
                seed, with_stats=True)
            self.edge_budget = edge_budget or probed_budget
            # root headroom from the probed per-root edge yield; induced
            # edges grow superlinearly in roots, so the linear estimate
            # overshoots — safe: the top-up loop stops on realized fill
            per_root = max(mean_raw / batch_size, 1.0)
            need = int(np.ceil(fill_target * self.edge_budget / per_root))
            self.max_roots = max(batch_size, int(need * 1.3))
            self.node_budget = node_budget or _round_up(
                self.max_roots * (walk_length + 1) + 1, 128)

    def _probe_edge_budget(self, seed: int, probes: int = 8,
                           with_stats: bool = False):
        """Estimate the padded edge envelope from a few probe batches.

        Capacity is layout-dependent (see pad_graph_batch): "dst" packs
        edges contiguously — capacity is the raw edge count; "relation"
        pays per-relation block padding. Probing with the padded figure
        for dst inflated the envelope ~15% at R=30 (pure slot waste)."""
        rng = np.random.default_rng(seed + 104729)
        worst = self.block_size
        total_raw = 0
        for _ in range(probes):
            nodes, ei, et = self._sample_base(rng)
            total_raw += et.shape[0]
            worst = max(worst, self._capacity(et))
        # align to lcm(block_size, 2048), as the reference does (its TPU
        # kernels work in 2048-slot chunks), so both packages pack the same
        # envelope.
        lcm = int(np.lcm(self.block_size, 2048))
        budget = _round_up(int(worst * 1.5), lcm)
        if with_stats:
            return budget, total_raw / probes
        return budget

    def _capacity(self, et: np.ndarray) -> int:
        """Edge-slot demand of a realized edge set under the layout."""
        if self.edge_layout == "dst":
            return et.shape[0]
        counts = np.bincount(et, minlength=self.graph.num_relations)
        return int(np.sum(
            (counts + self.block_size - 1) // self.block_size
        ) * self.block_size)

    def _sample_base(self, rng: np.random.Generator):
        with profiling.span("sample.walk"):
            roots = rng.integers(0, self.graph.num_nodes, self.batch_size)
            walks = random_walk(self.graph, roots, self.walk_length, rng)
            nodes = np.unique(walks)
        with profiling.span("sample.induce"):
            ei, et = self.graph.induced_subgraph(nodes)
        return nodes, ei, et

    def _sample_raw(self, rng: np.random.Generator):
        nodes, ei, et = self._sample_base(rng)
        if self.fill_target is None:
            return nodes, ei, et
        target = int(self.fill_target * self.edge_budget)
        n_roots = self.batch_size
        for _ in range(3):                       # top-up rounds
            cap = self._capacity(et)
            if cap >= target:
                break
            # worst-case node growth per extra root is walk_length+1 rows,
            # so this cap makes the node-budget overflow impossible
            headroom = (self.node_budget - 1 - len(nodes)) \
                // (self.walk_length + 1)
            add = min(int(np.ceil((target - cap) * n_roots / max(cap, 1))),
                      self.max_roots - n_roots, headroom)
            if add <= 0:
                break
            with profiling.span("sample.walk"):
                extra = rng.integers(0, self.graph.num_nodes, add)
                w2 = random_walk(self.graph, extra, self.walk_length, rng)
                nodes = np.unique(np.concatenate([nodes, w2.ravel()]))
            with profiling.span("sample.induce"):
                ei, et = self.graph.induced_subgraph(nodes)
            n_roots += add
        return nodes, ei, et

    def sample(self) -> tuple[GraphBatch, np.ndarray]:
        """One SAINT batch; returns (padded batch, global node ids)."""
        nodes, ei, et = self._sample_raw(self.rng)
        if self.with_features:
            x = self.graph.x[nodes] if self.graph.x is not None else \
                np.zeros((len(nodes), 1), np.float32)
        else:
            x = None
        before = et.shape[0]
        with profiling.span("sample.pad"):
            batch = pad_graph_batch(
                x, ei, et, num_relations=self.graph.num_relations,
                node_budget=self.node_budget, edge_budget=self.edge_budget,
                block_size=self.block_size, num_seed=len(nodes),
                rng=self.rng, node_ids=nodes, num_nodes_hint=len(nodes),
                layout=self.edge_layout)
        self.dropped_edges += before - int(batch.edge_mask.sum())
        return batch, nodes

    def set_epoch(self, epoch: int):
        """Re-key the batch stream for an epoch so any resume point replays
        the identical batches an uninterrupted run would have seen (the
        Trainer calls this; same contract as torch's DistributedSampler)."""
        self.rng = np.random.default_rng((self.seed, epoch))

    def __iter__(self):
        for _ in range(self.num_steps):
            yield self.sample()[0]

    def __len__(self):
        return self.num_steps


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
