"""Typed-table cells: the step ``typed_full_train`` takes (the program's
``full_batch_loss`` over ``train_split_typed``'s tables, then
``typed_update``, with ``iid_negatives``), in a loop of the benchmark's
own as the program's is, on the benchmark's graph, features and weights;
and the check of the first steps against the plain reference's
full-batch loss (reference/kge_rgcn_distmult.py: the typed tables are
the RGCN on the whole train graph)."""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from . import common
from .kge import kge_module, layer_dims, leaves


class State(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: object
    step: int


class TypedStep:
    """One step of ``typed_full_train``'s loop as a module with
    ``train_step``: iid negatives (or the injected ``negatives``), the
    full-batch loss, the clip + Adam update in place."""

    def __init__(self, module, typed, src, dst, rel, k: int):
        from biomedkg_tpu_torch.training.typed_train import (
            typed_optimizer, typed_params)
        self.module = module
        self.typed = typed
        self.src, self.dst, self.rel = src, dst, rel
        self.k = k
        self.params = typed_params(module)
        self.tx = typed_optimizer(module.hparams["learning_rate"])

    @property
    def device(self):
        return self.module.device

    def named_parameters(self):
        return self.params.items()

    def init_state(self, generator=None) -> State:
        return State(self.params, self.tx.init(list(self.params.values())),
                     0)

    def train_step(self, state, batch, generator=None, group=None,
                   negatives=None):
        from biomedkg_tpu_torch.training.typed_train import (
            full_batch_loss, iid_negatives, typed_update)
        enc, dec = self.module.model.encoder, self.module.model.decoder
        ns, nd = negatives if negatives is not None else iid_negatives(
            generator, self.k, self.rel.shape[0], self.typed.num_nodes)
        loss = full_batch_loss(enc, dec, self.typed, self.src, self.dst,
                               self.rel, ns, nd)
        opt = typed_update(loss, self.params, self.tx, state.opt_state)
        return State(state.params, opt, state.step + 1), \
            {"train_loss": loss.detach()}


class Repeat:
    """The whole train graph as every step's batch."""

    def __init__(self, token, steps: int):
        self.token, self.steps = token, steps

    def set_epoch(self, epoch: int):
        pass

    def __iter__(self):
        for _ in range(self.steps):
            yield self.token


class Cell(common.TrainingCell):
    """One typed full-batch run: the program's objects and the benchmark's
    inputs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from biomedkg_tpu_torch.models.typed import typed_to_device
        from biomedkg_tpu_torch.training.typed_train import (
            train_split_typed)

        super().__init__(cfg, traffic, seed, device)
        self.k = int(traffic["neg_ratio"])
        dm = self.data_module(1)
        g = dm.train_data.graph
        g.x = self.features.cpu().numpy()
        module = kge_module(cfg, dm.data.num_edge_types, self.k,
                            seed).to(self.device)
        self.typed_host = train_split_typed(dm)
        typed = typed_to_device(self.typed_host, self.device)
        g.x = None
        src, dst, rel = (torch.as_tensor(np.asarray(a, np.int64),
                                         device=self.device)
                         for a in (g.edge_index[0], g.edge_index[1],
                                   g.edge_type))
        self.module = TypedStep(module, typed, src, dst, rel, self.k)
        self.train_edges = (src, dst, rel)
        e = int(rel.shape[0])
        r = self.graph.num_relations
        pairs = min(len(np.unique(np.asarray(g.edge_index[0], np.int64) * r
                                  + g.edge_type)),
                    len(np.unique(np.asarray(g.edge_index[1], np.int64) * r
                                  + g.edge_type)))
        n = self.graph.num_nodes
        self.step_counts = {"edges": e, "nodes": n, "seeds": 0,
                            "edge_slots": e, "node_slots": n,
                            "pairs": pairs}
        self.loader = Repeat("train graph", 10**9)
        self.total_steps = 10**9
        self.leaves = leaves(cfg, r)
        self.weights = common.make_weights(self.leaves, seed, self.device)
        self.counts = lambda _: dict(self.step_counts)

    def fit(self, timed, loader):
        """``typed_full_train``'s loop: one generator for the negatives,
        the steps one after another on the main thread."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(common.G.seed_of(self.seed, "negatives"))
        state = timed.init_state()
        for batch in loader:
            state, _ = timed.train_step(state, batch, gen)
        return state

    def lr_of(self, step: int) -> float:
        """The typed loop's constant rate, rounded to float32."""
        return float(np.float32(self.cfg["learning_rate"]))

    def work(self, counts: Dict[str, int]) -> float:
        """Triplets a step trains: every train edge × (1 + K)."""
        return counts["edges"] * (1 + self.k)

    def step_flops(self, counts: Dict[str, int]) -> float:
        from ..bounds import rgcn_step_flops
        return rgcn_step_flops(counts["nodes"], counts["edges"],
                               counts["pairs"], layer_dims(self.cfg), self.k,
                               self.cfg["out_dim"])

    def draws(self, i: int, batch, n_real: int) -> dict:
        """Step i's (K, E) iid negatives over every node, from the seed."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(common.G.seed_of(self.seed, "draws", i))
        shape = (self.k, self.step_counts["edges"])
        n = self.graph.num_nodes
        return {"negatives": (
            torch.randint(0, n, shape, generator=gen, device=self.device),
            torch.randint(0, n, shape, generator=gen, device=self.device))}

    def batch_faults(self, b) -> int:
        """The program's typed tables against the train split: each
        signature block's edges, and each (destination, relation)
        count."""
        g, typed = self.graph, self.typed_host
        keys, counts = [], np.zeros((g.num_nodes, g.num_relations))
        for (s_t, r, t_t), (sl, dl) in typed.sigs.items():
            s = np.asarray(sl, np.int64) + typed.type_offset[s_t]
            d = np.asarray(dl, np.int64) + typed.type_offset[t_t]
            keys.append(common.G.edge_keys(s, d, np.full(len(s), r),
                                           g.num_nodes, g.num_relations))
            np.add.at(counts, (d, r), 1.0)
        keys = np.sort(np.concatenate(keys))
        faults = int(len(keys) != len(self.train_keys)
                     or np.count_nonzero(keys != self.train_keys))
        want = np.concatenate([typed.counts[t] for t in typed.type_names])
        return faults + int(np.count_nonzero(want != counts))

    def reference_loss(self, b, i: int, params, dtype):
        from ..reference import kge_rgcn_distmult as ref
        src, dst, rel = self.train_edges
        ns, nd = self.draws(i, None, 0)["negatives"]
        return ref.full_batch_loss(self.features, src, dst, rel, ns, nd,
                                   params, len(layer_dims(self.cfg)),
                                   self.graph.num_relations, dtype)
