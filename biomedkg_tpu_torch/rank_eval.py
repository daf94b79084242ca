"""Filtered-ranking evaluation of a KGE checkpoint (counterpart of
rank_eval.py at the repo root):

    python -m biomedkg_tpu_torch.rank_eval pretrained_path=ckpt/kge/exp/best.ckpt

The arguments are overrides of configs/kge.yaml, read by the config layer
(config.py) as the root rank_eval.py reads them: ``pretrained_path``
(required), ``seed``, the ``data.*`` keys the checkpoint was trained with
(``data.node_init_method``, ``data.embed_dim``, ``gcl_model``,
``gcl_fuse_method``, ``data.unseen_node_ratio``, ...), and the port's
``device`` (cuda). It splits the PrimeKG graph as ``train_kge`` does,
loads the checkpoint, encodes the test split's message-passing graph (the
train and val edges) as one batch in the module's layout (RGCN "dst"
through the CUDA segsum, RGAT "relation" through relmm), ranks every test
triple in both directions against all candidates, filtered by train ∪
val ∪ test (eval/ranking.py, full float32), and prints the filtered MRR,
mean rank and Hits@{1, 3, 10}.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from .device import resolve_device
from .eval.ranking import Clock, filtered_ranking_metrics
from .sampling.batch import batch_to_device
from .sampling.loaders import FullGraphLoader
from .config import CONFIG_DIR, cli_overrides, load_config
from .train_kge import data_module
from .training.kge_module import load_kge_module


def triples(split) -> np.ndarray:
    """A split's supervision edges as (head, rel, tail) rows."""
    ei, et = split.label_edge_index, split.label_edge_type
    return np.stack([ei[0], et, ei[1]], axis=1)


def rank_eval(module, dm, timings: Optional[dict] = None
              ) -> Dict[str, float]:
    """The filtered-ranking metrics of ``module`` on ``dm``'s test
    triples; ``timings`` as ``filtered_ranking_metrics``', with the
    encode's seconds as ``encode_s``."""
    graph = dm.test_data.graph
    clock = Clock(timings, module.device)
    t0 = clock.start()
    batch = FullGraphLoader(graph, block_size=dm.block_size,
                            edge_layout=module.edge_layout).batch()
    z = module.encode(batch_to_device(batch, module.device))
    z = z[:dm.graph.num_nodes]
    clock.stop("encode_s", t0)
    test = triples(dm.test_data)
    known = np.concatenate([triples(dm.train_data), triples(dm.val_data),
                            test])
    return filtered_ranking_metrics(module.model.decoder, z, test, known,
                                    timings=timings)


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    cfg = load_config(CONFIG_DIR, "kge", cli_overrides(
        sys.argv[1:] if argv is None else argv))
    if not cfg.get("pretrained_path"):
        raise SystemExit("rank_eval: pretrained_path=<ckpt> is required")
    device = resolve_device(cfg.get("device"))
    dm = data_module(cfg)
    print(f"Load from checkpoint: {cfg.pretrained_path}")
    module = load_kge_module(cfg.pretrained_path, device)
    module.edge_layout = module.default_layout
    metrics = rank_eval(module, dm)
    print("filtered-ranking metrics:")
    for k, v in metrics.items():
        print(f"  {k}: {v:.6f}")
    return metrics


if __name__ == "__main__":
    main()
