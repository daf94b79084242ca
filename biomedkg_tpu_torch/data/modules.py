"""The PrimeKG and DPI data modules (counterpart of
biomedkg_tpu/data/modules.py).

``setup`` (graph build and, for ``stage="split"``, the link split),
``edge_layout``, ``data``, ``graph``, ``edge_map_index``, and the loaders
of every split: GraphSAINT random walks (``loader_type="saint"``) and
[30, 30, 30] neighbour fan-outs (``"neighbor"``), each kind sharing one
envelope probed once on the largest split graph, and full batches
(``"full"``: the split's whole graph as one ``FullGraphLoader`` batch,
yielded ``SAINT_TRAIN_STEPS`` times for training and once for val and
test; the Trainer copies it to the device once an epoch);
``all_dataloader`` (the fan-outs over the whole graph) and
``subgraph_dataloader`` (the whole graph as one batch, for export).
``unseen_node_ratio > 0`` holds that share of the nodes out
(data/inductive.py; of the ``unseen_node_types`` only, cleaned names such
as ``["drug"]``, when given): the splits are then the seen-only edges'
and ``inductive`` carries the cold-start eval graph and the held-out
edges. ``node_init_method`` picks the features (data/node_encoders.py):
"random" (N, embed_dim), "lm" the LM cache's (N, 2, embed_dim) (read
through ``modality_config_path``), "gcl" the GCL cache's (N, 1,
embed_dim) of ``gcl_model`` / ``gcl_fuse_method``, built on ``device``
when missing. ``DPIModule`` does the same over the DPI benchmark's graph
(data/dpi.py), made undirected first.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..sampling.loaders import (FullGraphLoader, NeighborBatchLoader,
                                SaintRandomWalkLoader)
from . import node_encoders as node
from .dpi import DPI
from .inductive import node_pool_for_types, unseen_node_split
from .primekg import PrimeKG
from .split import random_link_split


def get_node_encode_method(node_init_method: Optional[str], embed_dim: int,
                           model_name: Optional[str] = None,
                           fuse_method: Optional[str] = None,
                           modality_config_path: str = node.MODALITY_CONFIG,
                           device: Optional[str] = None):
    if node_init_method is None or node_init_method == "random":
        return node.RandomEncode(embed_dim=embed_dim)
    if node_init_method == "lm":
        return node.LMMultiModalsEncode(config_file=modality_config_path,
                                        embed_dim=embed_dim)
    if node_init_method == "gcl":
        return node.GCLEncode(model_name=model_name, fuse_method=fuse_method,
                              embed_dim=embed_dim, device=device)
    raise ValueError(f"Unknown node_init_method: {node_init_method!r}")


class _BaseModule:
    """The splits and loaders the PrimeKG and DPI modules share."""

    SAINT_WALK_LENGTH = 10
    SAINT_TRAIN_STEPS = 1000
    SAINT_EVAL_STEPS = 100
    FANOUTS = [30, 30, 30]

    def __init__(self, embed_dim: int, batch_size: int, val_ratio: float,
                 test_ratio: float, node_init_method: Optional[str],
                 gcl_model: Optional[str], gcl_fuse_method: Optional[str],
                 seed: int, block_size: int, unseen_node_ratio: float,
                 unseen_node_types: Optional[List[str]],
                 modality_config_path: str, device: Optional[str]):
        self.batch_size = batch_size
        self.val_ratio = val_ratio
        self.test_ratio = test_ratio
        self.seed = seed
        self.block_size = block_size
        self.node_init_method = node_init_method
        self.unseen_node_ratio = float(unseen_node_ratio or 0.0)
        self.unseen_node_types = unseen_node_types
        self.inductive = None
        # "relation" or "dst" — must match the model's ``edge_layout``
        self.edge_layout = "relation"
        # True → batches carry node ids only; the training module gathers
        # features from its device-resident table (set_feature_table)
        self.device_features = False
        # None, or the share of the SAINT envelope the train batches top
        # up to (sampling/saint.py ``fill_target``); eval batches keep the
        # reference's root count
        self.saint_fill_target = None
        self.encoder = get_node_encode_method(
            node_init_method, embed_dim, model_name=gcl_model,
            fuse_method=gcl_fuse_method,
            modality_config_path=modality_config_path, device=device)

    def _post_setup(self, dataset):
        """``dataset``'s graph and, for ``stage="split"``, its splits."""
        self.data = dataset
        self.edge_map_index = dataset.edge_map_index
        self.graph = dataset.graph
        self._saint_budgets = None
        self._neighbor_budgets = None
        if self._do_split and self.unseen_node_ratio > 0.0:
            pool = None
            if self.unseen_node_types:
                pool = node_pool_for_types(
                    dataset.node_type_of, dataset.node_type_names,
                    self.unseen_node_types)
            self.inductive = unseen_node_split(
                self.graph, self.unseen_node_ratio, self.val_ratio,
                self.test_ratio, seed=self.seed, node_pool=pool)
            self.train_data = self.inductive.train
            self.val_data = self.inductive.val
            self.test_data = self.inductive.test
        elif self._do_split:
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


class PrimeKGModule(_BaseModule):
    def __init__(self, data_dir: str, embed_dim: int, node_type: List[str],
                 batch_size: int, val_ratio: float, test_ratio: float,
                 node_init_method: Optional[str] = None,
                 gcl_model: Optional[str] = None,
                 gcl_fuse_method: Optional[str] = None,
                 seed: int = 42, block_size: int = 256,
                 unseen_node_ratio: float = 0.0,
                 unseen_node_types: Optional[List[str]] = None,
                 modality_config_path: str = node.MODALITY_CONFIG,
                 device: Optional[str] = None):
        super().__init__(embed_dim, batch_size, val_ratio, test_ratio,
                         node_init_method, gcl_model, gcl_fuse_method, seed,
                         block_size, unseen_node_ratio, unseen_node_types,
                         modality_config_path, device)
        self.data_dir = data_dir
        self.node_type = node_type

    def setup(self, stage: str = "split"):
        self._do_split = stage == "split"
        self.primekg = PrimeKG(data_dir=self.data_dir,
                               node_type=self.node_type,
                               encoder=self.encoder)
        self._post_setup(self.primekg)


class DPIModule(_BaseModule):
    """The DPI benchmark's graph (data/dpi.py), made undirected, then split
    and batched as ``PrimeKGModule``'s (reference data_module.py:148-259)."""

    def __init__(self, data_dir: str, embed_dim: int, batch_size: int,
                 val_ratio: float, test_ratio: float,
                 node_init_method: Optional[str] = None,
                 gcl_model: Optional[str] = None,
                 gcl_fuse_method: Optional[str] = None,
                 seed: int = 42, block_size: int = 256,
                 unseen_node_ratio: float = 0.0,
                 unseen_node_types: Optional[List[str]] = None,
                 modality_config_path: str =
                 "configs/lm_modality/dpi_modality.yaml",
                 device: Optional[str] = None):
        super().__init__(embed_dim, batch_size, val_ratio, test_ratio,
                         node_init_method, gcl_model, gcl_fuse_method, seed,
                         block_size, unseen_node_ratio, unseen_node_types,
                         modality_config_path, device)
        self.data_dir = data_dir

    def setup(self, stage: str = "split"):
        self._do_split = stage == "split"
        self.dpi = DPI(data_dir=self.data_dir, encoder=self.encoder)
        # ToUndirected: every edge and its reverse with the same type, one
        # copy of each (src, dst, type), in first-occurrence order. The
        # reference then splits without is_undirected, so the reverse of a
        # test edge can sit in train; that leak is kept for parity.
        g = self.dpi.graph
        ei = np.concatenate([g.edge_index, g.edge_index[::-1]], axis=1)
        et = np.concatenate([g.edge_type, g.edge_type])
        key = (ei[0].astype(np.int64) * g.num_nodes + ei[1]
               ) * max(g.num_relations, 1) + et
        _, keep = np.unique(key, return_index=True)
        keep.sort()
        g.edge_index = ei[:, keep]
        g.edge_type = et[keep]
        g._out = g._in = None
        self._post_setup(self.dpi)


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
