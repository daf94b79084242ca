"""KGE evaluation of a checkpoint (counterpart of test_kge.py at the repo
root):

    python -m biomedkg_tpu_torch.test_kge pretrained_path=ckpt/kge/exp/best.ckpt

The arguments are overrides of configs/kge.yaml, read by the config layer
(config.py), so ``scripts/test_kge.sh``'s arguments work verbatim:
``pretrained_path`` (required), ``neg_ratio`` (10; none scores one
negative an edge), ``seed``, the ``data.*`` keys the checkpoint was
trained with (``data.node_init_method``, ``data.embed_dim``,
``gcl_model``, ``gcl_fuse_method``, ``data.unseen_node_ratio``, ...); the
``model.*`` and ``devices`` keys are read from the checkpoint and the one
card ``device`` names. The port's keys: ``filter_neg`` (false; true
redraws sampled negatives that hit a real batch edge, as the root
test_kge.py's), ``steps`` (none; as ``train_kge``'s, the test epoch then
takes max(1, steps // 10) SAINT batches, else 100), ``device`` (cuda),
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
from .config import CONFIG_DIR, cli_overrides, load_config
from .train_kge import data_module
from .training.kge_module import _parse_neg_ratio, load_kge_module
from .training.trainer import Trainer


def evaluate(config_name: str, entry: str,
             argv: Optional[List[str]]) -> Dict[str, float]:
    """``main`` of test_kge (configs/kge.yaml) and test_dpi
    (configs/dpi.yaml): the two reference scripts differ only in their
    config."""
    cfg = load_config(CONFIG_DIR, config_name, cli_overrides(
        sys.argv[1:] if argv is None else argv))
    if not cfg.get("pretrained_path"):
        raise SystemExit(f"{entry}: pretrained_path=<ckpt> is required")
    device = resolve_device(cfg.get("device"))
    dm = data_module(cfg)

    print("=" * 20)
    print(f"Load from checkpoint: {cfg.pretrained_path}")
    print("=" * 20)
    module = load_kge_module(cfg.pretrained_path, device)
    module.neg_ratio = _parse_neg_ratio(cfg.neg_ratio)
    module.filter_negatives = bool(cfg.get("filter_neg", False))
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
    metrics.update(run_entrypoint_inductive_eval(module, trainer, dm, cfg)
                   or {})
    return metrics


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    return evaluate("kge", "test_kge", argv)


if __name__ == "__main__":
    main()
