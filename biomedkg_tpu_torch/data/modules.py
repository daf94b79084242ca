"""PrimeKG data module (counterpart of
biomedkg_tpu/data/modules.py::PrimeKGModule).

``setup`` (graph build and, for ``stage="split"``, the link split),
``edge_layout``, ``data``, ``graph``, ``edge_map_index``, and the loaders
of every split: GraphSAINT random walks (``loader_type="saint"``) and
[30, 30, 30] neighbour fan-outs (``"neighbor"``), each kind sharing one
envelope probed once on the largest split graph, and full batches
(``"full"``: the split's whole graph as one ``FullGraphLoader`` batch,
yielded ``SAINT_TRAIN_STEPS`` times for training and once for val and
test; the Trainer copies it to the device once an epoch);
``all_dataloader`` (the fan-outs over the whole graph) and
``subgraph_dataloader`` (the whole graph as one batch, for export). The
inductive split and the DPI module come in later slices (ROADMAP.md
queue 1).
"""

from __future__ import annotations

from typing import List, Optional

from ..sampling.loaders import (FullGraphLoader, NeighborBatchLoader,
                                SaintRandomWalkLoader)
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
    SAINT_WALK_LENGTH = 10
    SAINT_TRAIN_STEPS = 1000
    SAINT_EVAL_STEPS = 100
    FANOUTS = [30, 30, 30]

    def __init__(self, data_dir: str, embed_dim: int, node_type: List[str],
                 batch_size: int, val_ratio: float, test_ratio: float,
                 node_init_method: Optional[str] = None,
                 seed: int = 42, block_size: int = 256):
        self.data_dir = data_dir
        self.node_type = node_type
        self.batch_size = batch_size
        self.val_ratio = val_ratio
        self.test_ratio = test_ratio
        self.seed = seed
        self.block_size = block_size
        self.node_init_method = node_init_method
        # "relation" or "dst" — must match the model's ``edge_layout``
        self.edge_layout = "relation"
        # True → batches carry node ids only; the training module gathers
        # features from its device-resident table (set_feature_table)
        self.device_features = False
        # None, or the share of the SAINT envelope the train batches top
        # up to (sampling/saint.py ``fill_target``); eval batches keep the
        # reference's root count
        self.saint_fill_target = None
        self.encoder = get_node_encode_method(node_init_method, embed_dim)

    def setup(self, stage: str = "split"):
        self._do_split = stage == "split"
        self.primekg = PrimeKG(data_dir=self.data_dir,
                               node_type=self.node_type,
                               encoder=self.encoder)
        self.data = self.primekg
        self.edge_map_index = self.primekg.edge_map_index
        self.graph = self.primekg.graph
        self._saint_budgets = None
        self._neighbor_budgets = None
        if self._do_split:
            self.train_data, self.val_data, self.test_data = \
                random_link_split(self.graph, self.val_ratio,
                                  self.test_ratio, seed=self.seed)

    def _probe_graph(self):
        """The largest split graph (test carries train+val message-passing
        edges): each loader kind probes its budgets once, on it, so every
        split's batches share one envelope."""
        return self.test_data.graph if self._do_split else self.graph

    def _saint(self, split, num_steps, seed_offset, fill_target=None):
        # probed with the fill plan, so train and eval share the envelope
        if self._saint_budgets is None:
            probe = SaintRandomWalkLoader(
                self._probe_graph(),
                batch_size=self.batch_size,
                walk_length=self.SAINT_WALK_LENGTH, num_steps=1,
                block_size=self.block_size, seed=self.seed,
                fill_target=self.saint_fill_target)
            self._saint_budgets = (probe.node_budget, probe.edge_budget)
        nb, eb = self._saint_budgets
        return SaintRandomWalkLoader(
            split.graph, batch_size=self.batch_size,
            walk_length=self.SAINT_WALK_LENGTH, num_steps=num_steps,
            block_size=self.block_size, seed=self.seed + seed_offset,
            node_budget=nb, edge_budget=eb, fill_target=fill_target,
            with_features=not self.device_features,
            edge_layout=self.edge_layout)

    def _neighbor(self, split, shuffle, seed_offset):
        if self._neighbor_budgets is None:
            probe = NeighborBatchLoader(
                self._probe_graph(), batch_size=self.batch_size,
                fanouts=self.FANOUTS, block_size=self.block_size,
                seed=self.seed)
            self._neighbor_budgets = (probe.node_budget, probe.edge_budget)
        nb, eb = self._neighbor_budgets
        return NeighborBatchLoader(
            split.graph, batch_size=self.batch_size, fanouts=self.FANOUTS,
            shuffle=shuffle, block_size=self.block_size,
            seed=self.seed + seed_offset, node_budget=nb, edge_budget=eb,
            with_features=not self.device_features,
            edge_layout=self.edge_layout)

    def _full(self, split, steps: int) -> "RepeatedBatch":
        return RepeatedBatch(FullGraphLoader(
            split.graph, block_size=self.block_size,
            edge_layout=self.edge_layout), steps)

    @staticmethod
    def _check_loader(loader_type: str):
        if loader_type not in ("saint", "neighbor", "full"):
            raise ValueError(f"unknown loader_type {loader_type!r}")

    def train_dataloader(self, loader_type: str = "neighbor"):
        self._check_loader(loader_type)
        if loader_type == "saint":
            return self._saint(self.train_data, self.SAINT_TRAIN_STEPS, 1,
                               fill_target=self.saint_fill_target)
        if loader_type == "full":
            return self._full(self.train_data, self.SAINT_TRAIN_STEPS)
        return self._neighbor(self.train_data, shuffle=True, seed_offset=1)

    def val_dataloader(self, loader_type: str = "neighbor"):
        self._check_loader(loader_type)
        if loader_type == "saint":
            return self._saint(self.val_data, self.SAINT_EVAL_STEPS, 2)
        if loader_type == "full":
            return self._full(self.val_data, 1)
        return self._neighbor(self.val_data, shuffle=False, seed_offset=2)

    def test_dataloader(self, loader_type: str = "neighbor"):
        self._check_loader(loader_type)
        if loader_type == "saint":
            return self._saint(self.test_data, self.SAINT_EVAL_STEPS, 3)
        if loader_type == "full":
            return self._full(self.test_data, 1)
        return self._neighbor(self.test_data, shuffle=False, seed_offset=3)

    def all_dataloader(self):
        """[30, 30, 30] fan-outs over the whole graph, budgets probed on
        it."""
        return NeighborBatchLoader(
            self.graph, batch_size=self.batch_size, fanouts=self.FANOUTS,
            shuffle=False, block_size=self.block_size, seed=self.seed,
            with_features=not self.device_features,
            edge_layout=self.edge_layout)

    def subgraph_dataloader(self):
        """The whole graph as one batch in the module's layout (the
        reference's export loader)."""
        return FullGraphLoader(self.graph, block_size=self.block_size,
                               edge_layout=self.edge_layout)


class RepeatedBatch:
    """One ``FullGraphLoader`` batch, the same host object ``steps`` times
    (``sampling/loaders.py::prefetch_to_device`` copies it to the device
    once)."""

    def __init__(self, loader: FullGraphLoader, steps: int):
        self.loader = loader
        self.steps = steps

    def __iter__(self):
        batch = self.loader.batch()
        for _ in range(self.steps):
            yield batch

    def __len__(self):
        return self.steps
