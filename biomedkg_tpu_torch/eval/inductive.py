"""Cold-start evaluation on unseen-node edges (counterpart of
biomedkg_tpu/eval/inductive.py; the split is data/inductive.py's):

  1. encode the whole graph over its seen-only edges, in the module's
     layout (the CUDA segsum for RGCN "dst", relmm for RGAT): unseen nodes
     are isolated and embedded from their features by the root transform;
  2. binary metrics: each held-out test edge against ``neg_ratio``
     corruptions that replace its unseen endpoint by another unseen node
     (host numpy draws, the reference's), scored by the decoder;
  3. filtered ranking of the unseen-touching test triples
     (eval/ranking.py), filtered by every known triple.

The module holds the weights evaluated: after ``Trainer.test`` those the
test loaded, where the reference reads ``trainer.tested_params``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..sampling.batch import batch_to_device
from ..sampling.csr import CSRGraph
from ..sampling.loaders import FullGraphLoader
from ..training.metrics import BootstrappedBinaryMetrics
from .ranking import filtered_ranking_metrics


def encode_full_graph(module, graph: CSRGraph,
                      block_size: int = 256) -> torch.Tensor:
    """The (N, d) node embeddings of the module's deterministic forward
    over ``graph`` as one batch, on the module's device."""
    batch = FullGraphLoader(graph, block_size=block_size,
                            edge_layout=module.edge_layout).batch()
    z = module.encode(batch_to_device(batch, module.device))
    return z[:graph.num_nodes]


def unseen_binary_metrics(module, z, split, neg_ratio: int = 3,
                          seed: int = 0, prefix: str = "unseen_",
                          which: str = "test") -> Dict[str, float]:
    """AUROC/AP/F1 of the unseen-touching edges against corruptions of
    their unseen endpoint."""
    ei = split.test_edge_index if which == "test" else split.val_edge_index
    et = split.test_edge_type if which == "test" else split.val_edge_type
    if ei.shape[1] == 0:
        return {}
    rng = np.random.default_rng(seed)
    src, dst = ei[0].copy(), ei[1].copy()
    unseen = split.unseen_nodes
    decoder = module.model.decoder

    def score(h, t, r):
        ids = [torch.as_tensor(np.asarray(a, np.int64)).to(z.device)
               for a in (h, t, r)]
        with torch.inference_mode():
            return decoder.score(z, *ids).cpu().numpy()

    pos = score(src, dst, et)
    if len(unseen) < 2:
        raise ValueError(
            f"unseen-node eval needs >= 2 held-out nodes to corrupt "
            f"against (got {len(unseen)}): every 'negative' would equal "
            "its positive and AUROC would pin at 0.5")
    negs = []
    src_unseen = split.unseen_mask[src]
    for _ in range(max(1, neg_ratio)):
        repl = rng.choice(unseen, size=len(src))
        # never the edge's own endpoint: that corruption is the positive
        # relabelled 0
        true_end = np.where(src_unseen, src, dst)
        coll = repl == true_end
        while coll.any():
            repl = np.where(coll, rng.choice(unseen, size=len(src)), repl)
            coll = repl == true_end
        # the head when it is unseen, else the tail
        ns = np.where(src_unseen, repl, src)
        nd = np.where(src_unseen, dst, repl)
        negs.append(score(ns, nd, et))
    neg = np.concatenate(negs)

    m = BootstrappedBinaryMetrics(prefix=prefix, seed=seed)
    m.update(np.concatenate([pos, neg]),
             np.concatenate([np.ones_like(pos), np.zeros_like(neg)]))
    return m.compute()


def unseen_ranking_metrics(module, z, split, graph: CSRGraph,
                           ks=(1, 3, 10), chunk: int = 1024,
                           max_triples: Optional[int] = None,
                           seed: int = 0) -> Dict[str, float]:
    """Filtered MRR/Hits@K of the unseen-touching test triples (at most
    ``max_triples`` of them, drawn from ``seed``)."""
    ei, et = split.test_edge_index, split.test_edge_type
    if ei.shape[1] == 0:
        return {}
    test_triples = np.stack([ei[0], et.astype(np.int64), ei[1]], axis=1)
    if max_triples is not None and len(test_triples) > max_triples:
        rng = np.random.default_rng(seed)
        test_triples = test_triples[
            rng.choice(len(test_triples), max_triples, replace=False)]
    all_triples = np.stack([graph.edge_index[0],
                            graph.edge_type.astype(np.int64),
                            graph.edge_index[1]], axis=1)
    out = filtered_ranking_metrics(module.model.decoder, z, test_triples,
                                   all_triples, ks=ks, chunk=chunk)
    return {f"unseen_{k}": v for k, v in out.items()}


def inductive_eval(module, split, graph: CSRGraph, neg_ratio: int = 3,
                   seed: int = 0, block_size: int = 256,
                   ranking: bool = True,
                   max_rank_triples: Optional[int] = 2048
                   ) -> Dict[str, float]:
    """The whole cold-start eval: encode the seen-only graph, score the
    unseen edges."""
    g = split.eval_graph
    if g.x is None:
        g = CSRGraph(num_nodes=g.num_nodes, edge_index=g.edge_index,
                     edge_type=g.edge_type, num_relations=g.num_relations,
                     x=graph.x)
    z = encode_full_graph(module, g, block_size=block_size)
    out = unseen_binary_metrics(module, z, split, neg_ratio=neg_ratio,
                                seed=seed)
    if ranking:
        out.update(unseen_ranking_metrics(
            module, z, split, graph, max_triples=max_rank_triples,
            seed=seed))
    out["unseen_num_nodes"] = float(len(split.unseen_nodes))
    out["unseen_num_test_edges"] = float(split.test_edge_index.shape[1])
    return out


def run_entrypoint_inductive_eval(module, trainer, data_module,
                                  args: dict) -> Optional[Dict[str, float]]:
    """The entry points' closing step: with ``data.unseen_node_ratio > 0``
    the cold-start eval of the module's (just tested) weights, printed
    and logged. ``args``: ``seed`` (42), ``unseen_ranking`` (True) and
    ``unseen_rank_max_triples`` (2048)."""
    split = data_module.inductive
    if split is None:
        return None
    out = inductive_eval(
        module, split, data_module.graph,
        neg_ratio=module.neg_ratio or 3,
        seed=args.get("seed", 42),
        block_size=data_module.block_size,
        ranking=bool(args.get("unseen_ranking", True)),
        max_rank_triples=int(args.get("unseen_rank_max_triples", 2048)))
    print("unseen-node (inductive) metrics:")
    for k in sorted(out):
        print(f"  {k}: {out[k]:.6f}")
    if trainer is not None and trainer.logger:
        trainer.logger.log(out, trainer.global_step)
    return out
