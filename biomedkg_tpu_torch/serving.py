"""Serving: checkpoint → resident embeddings → scoring / top-k queries
(counterpart of biomedkg_tpu/serving.py::KGEScorer).

One full-graph encode over every known edge, then

  * ``score(head, relation, tail)``      → probability
  * ``score_many([(h, r, t), ...])``     → probabilities, one device pass
  * ``topk_tails(head, relation, k)``    → ranked candidates of the
    relation's observed tail types, never the head itself

RGCN encodes in the destination-sorted ("dst") layout, so its aggregation
runs on the CUDA sorted segment-sum (ops/segsum.py); RGAT in the
"relation" layout, its messages through the CUDA grouped GEMM
(ops/relmm.py). The answers equal the JAX scorer's, which encodes in its
default "relation" layout.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device
from .sampling.batch import batch_to_device
from .sampling.loaders import FullGraphLoader
from .training.kge_module import load_kge_module


class KGEScorer:
    def __init__(self, ckpt_path: str, data_module,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        self.module = load_kge_module(ckpt_path, self.device)
        self.module.edge_layout = self.module.default_layout
        data_module.setup(stage="split")
        self.dm = data_module
        tg = data_module.data
        self.name_to_id = {}
        for type_map in tg.node_to_global.values():
            self.name_to_id.update(type_map)
        # names are unique only within a type: id → name comes from the
        # id-ordered node list, not from inverting name_to_id
        self.id_to_name = dict(enumerate(tg.node_list))
        self.rel_to_id = {v: k for k, v in tg.edge_map_index.items()}

        batch = FullGraphLoader(
            tg.graph, edge_layout=self.module.edge_layout).batch()
        z = self.module.encode(batch_to_device(batch, self.device))
        self.z = z[: tg.graph.num_nodes].clone()
        self.decoder = self.module.model.decoder

        # (R, N) candidate mask: each relation's observed tail types
        ntype = np.asarray(tg.node_type_of)
        ei, et = tg.graph.edge_index, tg.graph.edge_type
        mask = np.ones((len(self.rel_to_id), len(ntype)), bool)
        for rid in self.rel_to_id.values():
            sel = et == rid
            if sel.any():
                mask[rid] = np.isin(ntype, np.unique(ntype[ei[1][sel]]))
        self._tail_type_mask = torch.from_numpy(mask).to(self.device)

    def _ids(self, head: str, relation: str):
        if head not in self.name_to_id:
            raise KeyError(f"unknown node: {head!r}")
        if relation not in self.rel_to_id:
            raise KeyError(f"unknown relation: {relation!r}")
        return self.name_to_id[head], self.rel_to_id[relation]

    def _tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(values, dtype=torch.int64).to(self.device)

    @torch.inference_mode()
    def score(self, head: str, relation: str, tail: str) -> float:
        h, r = self._ids(head, relation)
        if tail not in self.name_to_id:
            raise KeyError(f"unknown node: {tail!r}")
        t = self.name_to_id[tail]
        logit = self.decoder.score(self.z, self._tensor([h]),
                                   self._tensor([t]), self._tensor([r]))
        return float(torch.sigmoid(logit)[0])

    @torch.inference_mode()
    def score_many(
            self, triples: List[Tuple[str, str, str]]) -> List[float]:
        """Score a batch of (head, relation, tail) name triples in one
        device pass; the sigmoid runs on the host in float64."""
        if not triples:
            return []
        ids = np.empty((3, len(triples)), np.int64)
        for i, (head, relation, tail) in enumerate(triples):
            h, r = self._ids(head, relation)
            if tail not in self.name_to_id:
                raise KeyError(f"unknown node: {tail!r}")
            ids[:, i] = (h, self.name_to_id[tail], r)
        ids = self._tensor(ids)
        logits = self.decoder.score(self.z, ids[0], ids[1], ids[2])
        lg = logits.cpu().numpy().astype(np.float64)
        return (1.0 / (1.0 + np.exp(-lg))).tolist()

    @torch.inference_mode()
    def topk_tails(self, head: str, relation: str,
                   k: int = 10) -> List[Tuple[str, float]]:
        h, r = self._ids(head, relation)
        if k <= 0:
            raise ValueError(f"k must be positive, got {k}")
        scores = self.decoder.score_all_tails(
            self.z, self._tensor([h]), self._tensor([r]))[0]
        mask = self._tail_type_mask[r].clone()
        mask[h] = False
        probs = torch.where(mask, torch.sigmoid(scores), -torch.inf)
        vals, idxs = torch.topk(probs, min(k, probs.shape[0]))
        vals, idxs = vals.cpu().numpy(), idxs.cpu().numpy()
        return [(self.id_to_name[int(i)], float(v))
                for i, v in zip(idxs, vals) if np.isfinite(v)]
