"""KGE evaluation of a checkpoint (counterpart of test_kge.py at the repo
root):

    python -m biomedkg_tpu_torch.test_kge pretrained_path=ckpt/kge/exp/best.ckpt

Keys: ``pretrained_path`` (required), ``neg_ratio`` (10; none scores one
negative an edge), ``filter_neg`` (false; true redraws sampled negatives
that hit a real batch edge), ``steps`` (none; as ``train_kge``'s, the
test epoch then takes max(1, steps // 10) SAINT batches, else 100),
``seed`` (42), ``device`` (cuda) and ``train_kge``'s
``data.unseen_node_ratio``, ``data.unseen_node_types``,
``unseen_ranking`` and ``unseen_rank_max_triples``.

It splits the PrimeKG graph as ``train_kge`` does, loads the checkpoint
with the features in a device-resident table, in the reference's layout
("dst" for RGCN, through the CUDA segsum), runs a test epoch on the test
split's SAINT batches through the Trainer and prints the ``test_*``
metrics; with ``data.unseen_node_ratio > 0`` it then runs the cold-start
eval of those weights (eval/inductive.py) and prints the ``unseen_*``
metrics. ``main`` returns both.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from .device import resolve_device
from .eval.inductive import run_entrypoint_inductive_eval
from .train_kge import KINDS, data_module, parse_keys
from .training.kge_module import _parse_neg_ratio, load_kge_module
from .training.trainer import Trainer

DEFAULTS = {"pretrained_path": None, "neg_ratio": "10", "filter_neg": False,
            "steps": None, "seed": 42, "device": None,
            "data.unseen_node_ratio": 0.0, "data.unseen_node_types": None,
            "unseen_ranking": True, "unseen_rank_max_triples": 2048}


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    args = parse_keys(sys.argv[1:] if argv is None else argv, DEFAULTS,
                      dict(KINDS, filter_neg=bool, neg_ratio=str),
                      "test_kge")
    if not args["pretrained_path"]:
        raise SystemExit("test_kge: pretrained_path=<ckpt> is required")
    device = resolve_device(args["device"])
    dm = data_module(args)
    if args["steps"] is not None:
        dm.SAINT_EVAL_STEPS = max(1, args["steps"] // 10)

    print("=" * 20)
    print(f"Load from checkpoint: {args['pretrained_path']}")
    print("=" * 20)
    module = load_kge_module(args["pretrained_path"], device)
    module.neg_ratio = _parse_neg_ratio(args["neg_ratio"])
    module.filter_negatives = args["filter_neg"]
    module.edge_mapping = dm.edge_map_index
    dm.device_features = True
    module.set_feature_table(dm.graph.x)
    module.edge_layout = dm.edge_layout = module.default_layout
    print("=" * 20)
    print(f"Neg Ratio: {module.neg_ratio}")
    print("=" * 20)

    trainer = Trainer(log_every_n_steps=10)
    metrics = trainer.test(module,
                           dataloaders=dm.test_dataloader(loader_type="saint"))
    metrics.update(run_entrypoint_inductive_eval(module, trainer, dm, args)
                   or {})
    return metrics


if __name__ == "__main__":
    main()
