"""Stage C cells with the RGAT encoder and the ComplEx decoder: the
program's ``Trainer.fit`` over a ``KGEModule`` (``encoder_name: rgat``,
``decoder_name: complex``) and its SAINT loader in the relation layout,
built as ``train_kge`` builds them (cells/kge.py), on the benchmark's
graph, features and weights; and the check of the first steps against
the plain reference (reference/kge_rgat_complex.py).

In a traced run the program's span recorder (``utils/profiling.py``) is
on from before ``Trainer.fit`` to its end, and the cell keeps the spans,
the recorder's counters and the profiler's events for the readers
(rgat_readers.py); an untraced run never turns it on. A program without
the recorder runs the cell all the same, and those readers find
nothing.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..spans import _profiling
from . import common
from .kge import Cell as KGECell
from .kge import batch_counts, layer_dims


def leaves(cfg, num_relations: int) -> Dict[str, tuple]:
    """Each trained leaf: (shape, bound of its uniform init; 0: zeros),
    the reference's init rules (xavier-uniform over the last two axes of
    the relation weights and attention vectors, zero biases,
    xavier-uniform relation embeddings). The relation weights' last axis
    holds the heads side by side."""
    heads, out = cfg["num_heads"], {}
    for i, (din, dout) in enumerate(layer_dims(cfg)):
        n = heads * dout
        prefix = f"model.encoder.layers.{i}."
        out[prefix + "w_rel"] = ((num_relations, din, n),
                                 math.sqrt(6.0 / (din + n)))
        for name in ("att_src", "att_dst"):
            out[prefix + name] = ((num_relations, heads, dout),
                                  math.sqrt(6.0 / (heads + dout)))
        out[prefix + "b"] = ((dout,), 0.0)
    out["model.decoder.rel_emb"] = (
        (num_relations, cfg["out_dim"]),
        math.sqrt(6.0 / (num_relations + cfg["out_dim"])))
    return out


def pair_counts(num_relations: int):
    """``batch_counts``, and the batch's distinct (source, relation) and
    (destination, relation) pairs among its real edges."""
    base = batch_counts(num_relations)

    def counts(b) -> Dict[str, int]:
        out = base(b)
        mask = b.edge_mask
        rel = b.edge_type[mask].astype(np.int64)
        seen = np.empty(b.node_mask.shape[0] * num_relations, bool)
        for end, name in ((0, "src_pairs"), (1, "dst_pairs")):
            seen[:] = False
            seen[b.edge_index[end][mask].astype(np.int64) * num_relations
                 + rel] = True
            out[name] = int(np.count_nonzero(seen))
        return out
    return counts


class Cell(KGECell):
    """One RGAT + ComplEx Stage C run: the program's objects and the
    benchmark's inputs."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        r = self.graph.num_relations
        self.leaves = leaves(cfg, r)
        self.weights = common.make_weights(self.leaves, seed, self.device)
        self.counts = pair_counts(r)
        self.spans = self.counters = self.events = self.traced = None

    def data_module(self, batch_size: int):
        """``TrainingCell.data_module``, with the SAINT loaders' padded
        envelope probed under the configuration's seed, as a run of the
        reference configuration (``seed: 42``) probes it: the envelope is
        the deployment's batch shape, and the walks follow the run's
        seed."""
        dm = super().data_module(batch_size)
        dm.SAINT_WALK_LENGTH = self.traffic["walk_length"]
        dm.saint_fill_target = self.traffic["saint_fill"]
        dm.seed = self.cfg["split_seed"]
        dm._saint(dm.train_data, 1, 0)
        dm.seed = self.data_seed
        return dm

    def fit(self, timed, loader):
        """``Trainer.fit``, with the recorder on in a traced run."""
        profiling = _profiling() if timed.trace_steps > 0 else None
        if profiling is not None:
            profiling.start()
        try:
            return super().fit(timed, loader)
        finally:
            if profiling is not None:
                self.spans = profiling.stop()
                self.counters = profiling.counters()
            if timed.profiler is not None:
                self.events = timed.profiler.events()
                self.traced = list(timed.traced)

    def step_flops(self, counts: Dict[str, int]) -> float:
        from ..rgat_bounds import rgat_complex_step_flops
        cfg = self.cfg
        return rgat_complex_step_flops(
            counts["edges"], counts["src_pairs"], counts["dst_pairs"],
            layer_dims(cfg), cfg["num_heads"], self.k, cfg["out_dim"])

    def reference_loss(self, b, i: int, params, dtype):
        from ..reference import kge_rgat_complex as ref
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
                             self.cfg["num_heads"], self.graph.num_relations,
                             dtype)
