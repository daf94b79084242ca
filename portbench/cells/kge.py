"""Stage C cells: the program's ``Trainer.fit`` over a ``KGEModule`` and
its SAINT loader, built as ``train_kge`` builds them, on the benchmark's
graph, features and weights; and the check of the first steps against
the plain reference (reference/kge_rgcn_distmult.py).

The data module is set up from the benchmark's triplet columns through
the program's own triplet layer and link split (``TripletGraph``, the
module's ``_post_setup``), in place of ``PrimeKG``'s csv or synthetic
source, so both sides read one graph.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .. import graph as G
from . import common



def layer_dims(cfg) -> List[tuple]:
    dims = [(cfg["in_dim"], cfg["hidden_dim"])]
    dims += [(cfg["hidden_dim"], cfg["hidden_dim"])] * cfg["num_hidden_layers"]
    return dims + [(cfg["hidden_dim"], cfg["out_dim"])]


def leaves(cfg, num_relations: int) -> Dict[str, tuple]:
    """Each trained leaf: (shape, bound of its uniform init; 0: zeros),
    the reference's init rules (xavier-uniform relation and root
    weights, zero biases, xavier-uniform relation embeddings)."""
    out = {}
    for i, (din, dout) in enumerate(layer_dims(cfg)):
        xav = math.sqrt(6.0 / (din + dout))
        out[f"model.encoder.layers.{i}.w_rel"] = ((num_relations, din, dout),
                                                  xav)
        out[f"model.encoder.layers.{i}.w_root"] = ((din, dout), xav)
        out[f"model.encoder.layers.{i}.b"] = ((dout,), 0.0)
    out["model.decoder.rel_emb"] = (
        (num_relations, cfg["out_dim"]),
        math.sqrt(6.0 / (num_relations + cfg["out_dim"])))
    return out


def kge_module(cfg, num_relations: int, k: int, seed: int,
               neg_sampler: str = "sorted"):
    """The program's ``KGEModule`` as ``train_kge`` builds it from the
    configuration (random node features of width in_dim)."""
    from biomedkg_tpu_torch.training.kge_module import KGEModule
    return KGEModule(
        encoder_name=cfg["encoder_name"], decoder_name=cfg["decoder_name"],
        in_dim=cfg["in_dim"], hidden_dim=cfg["hidden_dim"],
        out_dim=cfg["out_dim"], num_hidden_layers=cfg["num_hidden_layers"],
        num_relation=num_relations, num_heads=cfg["num_heads"],
        scheduler_type=cfg["scheduler_type"],
        learning_rate=cfg["learning_rate"],
        warm_up_ratio=cfg["warm_up_ratio"], fuse_method=cfg["fuse_method"],
        neg_ratio=k, node_init_method="random",
        seed=G.seed_of(seed, "trainer"), compute_dtype=cfg["compute_dtype"],
        neg_sampler=neg_sampler)


def batch_counts(num_relations: int):
    """Host counts of one batch, on the prefetch thread: real edges, real
    rows, edge and row slots, seeds, and the fewer of its distinct
    (destination, relation) and (source, relation) pairs (the batch's
    dst layout keeps both orders sorted, so each is a count of changes)."""
    def counts(b) -> Dict[str, int]:
        mask = b.edge_mask
        e = int(np.count_nonzero(mask))
        key = b.edge_index[1][mask].astype(np.int64) * num_relations \
            + b.edge_type[mask]
        pairs = 1 + int(np.count_nonzero(np.diff(key))) if e else 0
        if b.src_edges.size:
            se = b.src_edges
            keep = se[3] > 0
            skey = se[0][keep].astype(np.int64) * num_relations + se[2][keep]
            pairs = min(pairs, 1 + int(np.count_nonzero(np.diff(skey)))
                        if e else 0)
        return {"edges": e, "nodes": int(np.count_nonzero(b.node_mask)),
                "seeds": int(b.num_seed), "edge_slots": int(mask.shape[0]),
                "node_slots": int(b.node_mask.shape[0]), "pairs": pairs}
    return counts


class Cell(common.TrainingCell):
    """One Stage C run: the program's objects and the benchmark's
    inputs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        self.k = int(traffic["neg_ratio"])
        dm = self.data_module(traffic["roots"])
        dm.SAINT_WALK_LENGTH = traffic["walk_length"]
        dm.SAINT_TRAIN_STEPS = cfg["steps_per_epoch"]
        dm.saint_fill_target = traffic["saint_fill"]
        module = kge_module(cfg, dm.data.num_edge_types, self.k, seed,
                            traffic["neg_sampler"]).to(self.device)
        module.edge_mapping = dm.edge_map_index
        module.edge_layout = dm.edge_layout = traffic["layout"]
        module.set_feature_table(self.features)
        self.module = module
        self.loader = dm.train_dataloader(loader_type="saint")
        self.total_steps = cfg["epochs"] * cfg["steps_per_epoch"]
        self.leaves = leaves(cfg, self.graph.num_relations)
        self.weights = common.make_weights(self.leaves, seed, self.device)
        self.counts = batch_counts(self.graph.num_relations)

    # -- what the window counts ------------------------------------------

    def work(self, counts: Dict[str, int]) -> float:
        """Triplets a step trains: real positive edges × (1 + K)."""
        return counts["edges"] * (1 + self.k)

    def step_flops(self, counts: Dict[str, int]) -> float:
        from ..bounds import rgcn_step_flops
        return rgcn_step_flops(counts["nodes"], counts["edges"],
                               counts["pairs"], layer_dims(self.cfg), self.k,
                               self.cfg["out_dim"])

    # -- the checked steps' draws ----------------------------------------

    def draws(self, i: int, batch, n_real: int) -> dict:
        """Step i's negatives and dropout keep masks, from the seed: the
        "sorted" sampler's distribution (sources a sorted uniform draw
        over the batch's real rows, destinations iid uniform, K offsets
        over the edge slots) and keep-with-0.8 masks per hidden conv."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(G.seed_of(self.seed, "draws", i))
        n_pad = batch.node_mask.shape[0]
        e_pad = batch.edge_mask.shape[0]
        ke = self.k * e_pad
        dev = self.device
        neg_src = torch.sort(torch.randint(0, n_real, (ke,), generator=gen,
                                           device=dev)).values.int()
        neg_dst = torch.randint(0, n_real, (ke,), generator=gen,
                                device=dev).int()
        off = torch.randint(0, e_pad, (self.k,), generator=gen, device=dev)
        keep = [torch.rand(n_pad, dout, generator=gen, device=dev) >= 0.2
                for _, dout in layer_dims(self.cfg)[:-1]]
        return {"negatives": (neg_src, neg_dst, off), "dropout_masks": keep}

    # -- the check ---------------------------------------------------------

    def batch_faults(self, b) -> int:
        return common.saint_batch_faults(b, self.graph, self.train_keys,
                                         self.induced_count)

    def reference_loss(self, b, i: int, params, dtype):
        from ..reference import kge_rgcn_distmult as ref
        dev = self.device
        mask = torch.as_tensor(b.edge_mask, device=dev)
        n_real = int(np.count_nonzero(b.node_mask))
        ids = torch.as_tensor(b.node_ids[:n_real].astype(np.int64),
                              device=dev)
        ei = torch.as_tensor(b.edge_index.astype(np.int64), device=dev)
        et = torch.as_tensor(b.edge_type.astype(np.int64), device=dev)
        d = self.draws(i, common.shapes_of(b, dev), n_real)
        neg_src, neg_dst, off = d["negatives"]
        batch = {"x": self.features[ids], "src": ei[0][mask],
                 "dst": ei[1][mask], "rel": et[mask],
                 "keep": [m[:n_real] for m in d["dropout_masks"]],
                 "edge_mask": mask, "edge_type": et,
                 "neg_src": neg_src.long(), "neg_dst": neg_dst.long(),
                 "off": off}
        return ref.step_loss(batch, params, len(layer_dims(self.cfg)),
                             self.graph.num_relations, dtype)
