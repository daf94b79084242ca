"""What the training cells share: the benchmark's weights, the readings
of the program's checked steps, the comparison with the reference's, and
the checks of a sampled batch against the graph. Plain torch and numpy."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .. import graph as G
from ..reference.optim import B1, Adam, leaf_norms, schedule, worst_leaf_gap

# a leaf whose reference gradient is under this share of the median
# leaf's moves under Adam by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def make_weights(leaves: Dict[str, tuple], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every leaf U(-bound, bound) (zeros where the bound is 0), from one
    draw of the seed's generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(G.seed_of(seed, "weights"))
    total = sum(int(np.prod(shape)) for shape, _ in leaves.values())
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, (shape, bound) in leaves.items():
        n = int(np.prod(shape))
        out[name] = (flat[at:at + n] * bound).reshape(shape).contiguous()
        at += n
    return out


def program_readings(timed, weights) -> dict:
    """The program's checked steps as the check reads them: each step's
    loss, each leaf's first gradient as the optimizer got it (Adam's
    first moment after one step over 1 - b1) and each leaf's change over
    the checked steps."""
    grads = {name: m / (1.0 - B1)
             for name, m in zip(timed.param_names, timed.first_mu)}
    change = {name: timed.checked_params[name] - weights[name]
              for name in timed.param_names}
    return {"losses": [float(x) for x in timed.losses],
            "grad_norms": leaf_norms(grads), "change_norms": leaf_norms(change)}


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers compared: the widest relative gap of a step's
    loss; of a leaf's first-gradient norm; of a leaf's change norm over
    the checked steps (leaves the reference's gradient leaves still, by
    ``STILL_LEAF``, left out), each gap of norms against the reference's
    norm of that leaf or of the median leaf, whichever is larger."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                  ref["losses"])]
    if len(losses) != len(ref["losses"]) or not losses:
        raise RuntimeError("the program took fewer checked steps than the "
                           "reference")
    names = list(ref["grad_norms"])
    median = float(np.median([ref["grad_norms"][k] for k in names]))
    moving = [k for k in names
              if ref["grad_norms"][k] >= STILL_LEAF * median]
    return {"loss_gap": max(losses),
            "grad_gap": worst_leaf_gap(prog["grad_norms"], ref["grad_norms"],
                                       names),
            "update_gap": worst_leaf_gap(prog["change_norms"],
                                         ref["change_norms"], moving)}


def graph_mismatch(csr, graph: G.Graph) -> int:
    """Edges (and counts) where the program's graph differs from the
    benchmark's."""
    ei = np.asarray(csr.edge_index)
    if ei.shape[1] != len(graph.src) or csr.num_nodes != graph.num_nodes:
        return max(abs(ei.shape[1] - len(graph.src)), 1)
    return int(np.count_nonzero((ei[0] != graph.src) | (ei[1] != graph.dst)
                                | (np.asarray(csr.edge_type) != graph.rel)))


def batch_faults(b, graph: G.Graph, keys: np.ndarray) -> tuple:
    """(faults, global real node ids, real edge count) of a padded batch:
    real rows not a prefix, node ids out of range or repeated, real edges
    with ends outside the real rows, duplicated, missing from ``keys``
    (the edge set the batch is drawn from), or out of (dst, rel) order in
    the dst layout."""
    faults = 0
    n_real = int(np.count_nonzero(b.node_mask))
    faults += int(np.count_nonzero(b.node_mask[n_real:]))
    ids = np.asarray(b.node_ids[:n_real], np.int64)
    faults += int(np.count_nonzero((ids < 0) | (ids >= graph.num_nodes)))
    faults += n_real - len(np.unique(ids))
    mask = np.asarray(b.edge_mask, bool)
    src = np.asarray(b.edge_index[0][mask], np.int64)
    dst = np.asarray(b.edge_index[1][mask], np.int64)
    rel = np.asarray(b.edge_type[mask], np.int64)
    bad = (src >= n_real) | (dst >= n_real) | (src < 0) | (dst < 0)
    faults += int(np.count_nonzero(bad))
    src, dst, rel = src[~bad], dst[~bad], rel[~bad]
    gkeys = G.edge_keys(ids[src], ids[dst], rel, graph.num_nodes,
                        graph.num_relations)
    faults += len(gkeys) - len(np.unique(gkeys))
    pos = np.searchsorted(keys, gkeys)
    found = keys[np.minimum(pos, len(keys) - 1)] == gkeys
    faults += int(np.count_nonzero(~found))
    if b.src_edges.size:        # the dst layout: (dst, rel) ascending
        local = dst * graph.num_relations + rel
        faults += int(np.count_nonzero(np.diff(local) < 0))
    return faults, ids, int(np.count_nonzero(mask))


def saint_batch_faults(b, graph, keys, induced_count) -> int:
    """``batch_faults``, and a SAINT batch must hold every train edge
    among its nodes (the induced subgraph) unless it filled its edge
    slots."""
    faults, ids, e_real = batch_faults(b, graph, keys)
    if e_real < b.edge_mask.shape[0]:
        faults += abs(induced_count(ids) - e_real)
    return faults


def shapes_of(b, device):
    """A host batch's masks on ``device``, as the draws read them."""
    class Shapes:
        node_mask = torch.as_tensor(b.node_mask, device=device)
        edge_mask = torch.as_tensor(b.edge_mask, device=device)
    return Shapes


class TrainingCell:
    """What a training cell's driver shares: the benchmark's graph and
    features, the program's data module set up on them, the train split's
    edge set, and the check of the checked steps against the reference.
    A stage defines ``batch_faults(b)`` and ``reference_loss(b, i,
    params, dtype)``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        gspec = cfg["graph"]
        self.graph = G.primekg_edges(gspec["sizes"], gspec["num_edges"],
                                     gspec["seed"], cfg["node_types"])
        self.data_seed = G.seed_of(seed, "data")
        self.features = G.node_features(self.graph.num_nodes, cfg["in_dim"],
                                        seed, self.device)

    def fit(self, timed, loader):
        """Drive the window: the program's ``Trainer.fit`` as the stage's
        entry point builds it (no validation, checkpoints or logger)."""
        from biomedkg_tpu_torch.training.trainer import Trainer
        trainer = Trainer(max_epochs=1, gradient_clip_val=1.0, callbacks=[],
                          logger=None, enable_checkpointing=False,
                          devices=1, enable_progress_bar=False,
                          steps_per_execution=int(
                              self.cfg["steps_per_execution"]))
        return trainer.fit(timed, train_dataloaders=loader)

    def data_module(self, batch_size: int):
        """The program's data module on the benchmark's triplet columns,
        split by its own link split under the configuration's
        ``split_seed`` (the reference's ``seed: 42``), features kept on the
        device."""
        from biomedkg_tpu_torch.data.modules import PrimeKGModule
        from biomedkg_tpu_torch.data.triplet import TripletGraph
        cfg = self.cfg
        dm = PrimeKGModule(
            data_dir="", embed_dim=cfg["in_dim"],
            node_type=cfg["node_types"], batch_size=batch_size,
            val_ratio=cfg["val_ratio"], test_ratio=cfg["test_ratio"],
            node_init_method="random", seed=cfg["split_seed"])
        dm._do_split = True
        dm._post_setup(TripletGraph(columns=G.triplet_columns(self.graph)))
        # the split is the dataset's, fixed; the loaders' streams follow
        # the run's seed
        dm.seed = self.data_seed
        dm.device_features = True
        self.graph_mismatch = graph_mismatch(dm.graph, self.graph)
        return dm

    @property
    def train_keys(self) -> np.ndarray:
        """The sorted edge keys of the train split (graph.link_split)."""
        if not hasattr(self, "_train_keys"):
            g = self.graph
            self._train_idx = G.link_split(len(g.src), self.cfg["val_ratio"],
                                           self.cfg["test_ratio"],
                                           self.cfg["split_seed"])
            idx = self._train_idx
            self._train_keys = np.sort(G.edge_keys(
                g.src[idx], g.dst[idx], g.rel[idx], g.num_nodes,
                g.num_relations))
        return self._train_keys

    def induced_count(self, nodes: np.ndarray) -> int:
        """How many train edges have both ends in ``nodes``."""
        self.train_keys
        inside = np.zeros(self.graph.num_nodes, bool)
        inside[nodes] = True
        idx = self._train_idx
        return int(np.count_nonzero(inside[self.graph.src[idx]]
                                    & inside[self.graph.dst[idx]]))

    def check(self, timed, loader) -> Dict[str, float]:
        """The numbers compared: the program's graph and checked batches
        against the benchmark's graph, and its checked steps against the
        float32 reference's (TF32 off)."""
        readings = {"graph_mismatch": float(self.graph_mismatch),
                    "batch_faults": float(sum(self.batch_faults(b)
                                              for b in loader.kept))}
        prog = program_readings(timed, self.weights)
        ref = self.reference_readings(loader.kept, torch.float32)
        readings.update(compare(prog, ref))
        return readings

    def lr_of(self, step: int) -> float:
        """The configuration's warm-up schedule over the run's steps."""
        cfg = self.cfg
        return schedule(cfg["scheduler_type"], cfg["learning_rate"],
                        self.total_steps, cfg["warm_up_ratio"], step)

    def reference_readings(self, kept, dtype) -> dict:
        """Losses, first clipped gradients and the parameters' change over
        the checked steps, by the plain reference in ``dtype`` from the
        benchmark's weights, draws and the checked batches."""
        params = {k: v.clone() for k, v in self.weights.items()}
        opt = Adam(params, self.lr_of)
        losses, first = [], None
        for i, b in enumerate(kept):
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in opt.params.items()}
            loss = self.reference_loss(b, i, leaves, dtype)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            clipped = opt.step(dict(zip(leaves, grads)))
            losses.append(float(loss.detach()))
            if first is None:
                first = leaf_norms(clipped)
            del loss, grads
        change = leaf_norms({k: opt.params[k] - self.weights[k]
                             for k in params})
        return {"losses": losses, "grad_norms": first,
                "change_norms": change}
