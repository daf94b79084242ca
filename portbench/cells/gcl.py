"""Stage B cells: the program's ``Trainer.fit`` over a GRACE module and
its neighbour loader, built as ``train_gcl`` builds them (one node type,
the dst layout, device-resident features), on the benchmark's graph,
features and weights; and the check of the first steps against the plain
reference (reference/gcl_grace.py)."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import common

FEATURE_MASK = EDGE_DROP = 0.4
DROPOUT = 0.2


def layer_dims(cfg) -> List[tuple]:
    dims = [(cfg["in_dim"], cfg["hidden_dim"])]
    dims += [(cfg["hidden_dim"], cfg["hidden_dim"])] * cfg["num_hidden_layers"]
    return dims + [(cfg["hidden_dim"], cfg["out_dim"])]


def leaves(cfg) -> Dict[str, tuple]:
    """Each trained leaf: (shape, bound of its uniform init; 0: zeros),
    the reference's init rules (xavier-uniform GCN weights, zero biases;
    the projection's dense layers U(±1/√fan_in), weights and biases)."""
    out = {}
    for i, (din, dout) in enumerate(layer_dims(cfg)):
        out[f"model.encoder.layers.{i}.w"] = ((din, dout),
                                              math.sqrt(6.0 / (din + dout)))
        out[f"model.encoder.layers.{i}.b"] = ((dout,), 0.0)
    h = cfg["hidden_dim"]
    for name in ("model.fc1", "model.fc2"):
        out[name + ".w"] = ((h, h), 1.0 / math.sqrt(h))
        out[name + ".b"] = ((h,), 1.0 / math.sqrt(h))
    return out


def batch_counts(b) -> Dict[str, int]:
    mask = b.edge_mask
    return {"edges": int(np.count_nonzero(mask)),
            "nodes": int(np.count_nonzero(b.node_mask)),
            "seeds": int(b.num_seed), "edge_slots": int(mask.shape[0]),
            "node_slots": int(b.node_mask.shape[0])}


class Cell(common.TrainingCell):
    """One Stage B run: the program's objects and the benchmark's
    inputs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from biomedkg_tpu_torch.training.gcl_module import create_gcl_model

        super().__init__(cfg, traffic, seed, device)
        self.k = 0
        dm = self.data_module(traffic["seeds"])
        dm.FANOUTS = list(traffic["fanouts"])
        dm.edge_layout = traffic["layout"]
        module = create_gcl_model(
            {k: cfg[k] for k in ("model_name", "in_dim", "hidden_dim",
                                 "out_dim", "num_hidden_layers",
                                 "scheduler_type", "learning_rate",
                                 "warm_up_ratio", "fuse_method",
                                 "compute_dtype")},
            seed=common.G.seed_of(seed, "trainer")).to(self.device)
        module.set_feature_table(self.features)
        module.edge_layout = traffic["layout"]
        self.module = module
        self.loader = dm.train_dataloader(loader_type="neighbor")
        self.total_steps = cfg["epochs"] * len(self.loader)
        self.leaves = leaves(cfg)
        self.weights = common.make_weights(self.leaves, seed, self.device)
        self.counts = batch_counts

    def work(self, counts: Dict[str, int]) -> float:
        """Seed nodes a step trains (an epoch is one pass of seeds)."""
        return counts["seeds"]

    def step_flops(self, counts: Dict[str, int]) -> float:
        from ..bounds import gcn_grace_step_flops
        return gcn_grace_step_flops(counts["nodes"], counts["edges"],
                                    layer_dims(self.cfg),
                                    self.cfg["hidden_dim"],
                                    self.cfg["out_dim"])

    def draws(self, i: int, batch, n_real: int) -> dict:
        """Step i's augmentations and dropout masks, from the seed, as the
        module's ``draws``: per view an entrywise feature keep mask and an
        edge keep mask (keep with 0.6), and keep-with-0.8 masks after each
        hidden conv."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(common.G.seed_of(self.seed, "draws", i))
        n_pad = batch.node_mask.shape[0]
        e_pad = batch.edge_mask.shape[0]
        dev = self.device

        def keep(shape, p):
            return torch.rand(shape, generator=gen, device=dev) >= p

        return {"draws": {
            "feat_keep": [keep((n_pad, self.cfg["in_dim"]), FEATURE_MASK)
                          for _ in range(2)],
            "edge_keep": [keep((e_pad,), EDGE_DROP) for _ in range(2)],
            "dropout": [[keep((n_pad, dout), DROPOUT)
                         for _, dout in layer_dims(self.cfg)[:-1]]
                        for _ in range(2)]}}

    def batch_faults(self, b) -> int:
        faults, _, _ = common.batch_faults(b, self.graph, self.train_keys)
        return faults

    def reference_loss(self, b, i: int, params, dtype):
        from ..reference import gcl_grace as ref
        dev = self.device
        mask = torch.as_tensor(b.edge_mask, device=dev)
        n_real = int(np.count_nonzero(b.node_mask))
        ids = torch.as_tensor(b.node_ids[:n_real].astype(np.int64),
                              device=dev)
        ei = torch.as_tensor(b.edge_index.astype(np.int64), device=dev)
        d = self.draws(i, common.shapes_of(b, dev), n_real)["draws"]
        batch = {"x": self.features[ids], "src": ei[0][mask],
                 "dst": ei[1][mask],
                 "feat_keep": [m[:n_real] for m in d["feat_keep"]],
                 "edge_keep": [m[mask] for m in d["edge_keep"]],
                 "keep": [[m[:n_real] for m in v] for v in d["dropout"]]}
        return ref.step_loss(batch, params, len(layer_dims(self.cfg)),
                             dtype)
