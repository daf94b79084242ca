"""KGE link-prediction training (counterpart of train_kge.py at the repo
root), the reference's flow on the port's Trainer:

    python -m biomedkg_tpu_torch.train_kge [key=value ...]

The arguments are overrides of configs/kge.yaml (with configs/data/
primekg.yaml and configs/model/kge.yaml), read by the config layer
(config.py), so ``scripts/kge.sh``'s arguments work verbatim:
``devices=[0] epochs=100 neg_ratio=1 gcl_model=ggd gcl_fuse_method=attention
data.batch_size=64 data.embed_dim=256 data.node_init_method=gcl
model.in_dim=256 model.learning_rate=0.001 model.fuse_method=none
model.encoder_name=rgcn model.decoder_name=dismult``. Besides the config's
keys (``epochs``, ``val_every_epoch``, ``neg_ratio``, ``saint_fill``,
``steps_per_execution``, ``debug``, ``seed``, ``ckpt_dir``, ``log_dir``,
``model.*``, ``data.*`` with ``data.unseen_node_ratio`` and
``data.unseen_node_types``), the port takes ``steps`` (SAINT steps per
epoch; default the data module's 1000; it also sets the val and test
epochs to max(1, steps // 10) batches, else 100), ``device`` (cuda),
``unseen_ranking`` (true) and ``unseen_rank_max_triples`` (2048).

``data.node_init_method`` picks the features: random, lm (the LM cache
``data/embed/primekg_modality_lm.pickle`` must be present: building it,
Stage A, is not ported) or gcl (the GCL cache
``data/gcl_embed/<gcl_model>_<gcl_fuse_method>.pickle``, built when missing
from the ``train_gcl`` checkpoints under ``ckpt/gcl/``). The model's input
width is the features' (``data.embed_dim``: configs/model/kge.yaml's
in_dim of 256 is the GCL width, and the scripts pass both).
``model.fuse_method`` (attention, redaf) fuses LM features; otherwise
multi-modal features take the mean over the modality axis.

It trains the chosen encoder and decoder on GraphSAINT batches of the
train split (features gathered from a device-resident table) in the
layout the reference picks: "dst" for RGCN, "relation" for RGAT, whose
grouped GEMM needs single-relation blocks; validates on the val split's
SAINT batches every ``val_every_epoch`` epochs, keeping the 3 checkpoints
of least ``val_loss`` and ``last.ckpt`` under
``<ckpt_dir>/kge/<experiment>/``; then tests the best of them on the test
split and, with ``data.unseen_node_ratio > 0``, runs the cold-start eval
of the tested weights (eval/inductive.py: ``unseen_*`` metrics). Metrics
go to ``<log_dir>/kge/<experiment>/metrics.{jsonl,csv}``.
Every checkpoint holds the optimizer state, which ``KGEScorer`` serves and
``Trainer.fit(resume_from=...)`` resumes. ``devices`` (the config's
``0,1``) is the Trainer's: clamped to the cards present; with more than
one the run re-launches itself once per card (parallel/launch.py) and
trains data-parallel over NCCL, rank 0 writing the checkpoints and logs.
``train`` returns the path of the checkpoint the test loaded
(None when it tested the weights in memory: ``debug``, or no validation
ran).

``typed_tables=true`` trains the hetero-native typed tables instead
(training/typed_train.py: per-type feature tables and per-signature edge
blocks, the RGCN in float32): full-batch on the train split's edges, or
typed GraphSAINT sub-batches with ``typed_loader=saint``, ``typed_steps``
(300) steps an epoch; it prints and returns the test metrics of the
full-graph typed encode and writes no checkpoint, as the JAX package does.
It runs as one process on one device whatever ``devices`` asks for (a
warning says so): launched as more than one rank it raises, since
data-parallel typed training is not ported (ROADMAP.md item 12c).
"""

from __future__ import annotations

import os
import sys
import time
import warnings
from typing import List, Optional

from .config import CONFIG_DIR, Config, cli_overrides, load_config
from .eval.inductive import run_entrypoint_inductive_eval
from .parallel.launch import cards_asked, per_card
from .parallel.mesh import distributed_init_if_needed
from .serve import make_data_module
from .training.checkpoint import ModelCheckpoint
from .training.kge_module import KGEModule
from .training.logger import MetricsLogger
from .training.trainer import Trainer
from .training.typed_train import typed_full_train, typed_saint_train


def data_module(cfg: Config):
    """The run's data module (``cfg.data``, the GCL cache keys, ``seed``,
    ``device``), set up with its splits; ``steps`` cuts its SAINT
    epochs."""
    dm = make_data_module(cfg)
    dm.setup(stage="split")
    steps = cfg.get("steps")
    if steps is not None:
        dm.SAINT_TRAIN_STEPS = int(steps)
        dm.SAINT_EVAL_STEPS = max(1, int(steps) // 10)
    return dm


def saint_fill(cfg: Config) -> Optional[float]:
    """``saint_fill`` as a float, None for none / null / empty."""
    fill = cfg.get("saint_fill")
    if fill is None or str(fill).lower() in ("none", "null", ""):
        return None
    return float(fill)


def experiment_name(cfg: Config, gcl_sep: str = "_") -> str:
    """The run's name: encoder, decoder, node init, then for a GCL init
    ``gcl_sep`` and the GCL model and fuser, then the time."""
    name = (f"{cfg.model.encoder_name}_{cfg.model.decoder_name}"
            f"_{cfg.data.node_init_method}")
    if cfg.data.node_init_method == "gcl":
        name += f"{gcl_sep}{cfg.gcl_model}_{cfg.gcl_fuse_method}"
    return name + str(int(time.time()))


def fit_and_test(cfg: Config, dm, module: KGEModule, stage: str,
                 exp_name: str, project: str, init_params=None,
                 note: str = "") -> Optional[str]:
    """The reference's flow for ``module`` (on its device) over ``dm``'s
    SAINT batches: fit (from ``init_params`` when given), validating every
    ``val_every_epoch`` epochs with the top 3 checkpoints by ``val_loss``
    and ``last.ckpt`` kept under ``<ckpt_dir>/<stage>/<exp_name>/``; test
    the best; the cold-start eval. Returns the tested checkpoint's path."""
    dm.device_features = True
    dm.saint_fill_target = saint_fill(cfg)
    module.edge_mapping = dm.edge_map_index
    module.edge_layout = dm.edge_layout = module.default_layout
    module.set_feature_table(dm.graph.x)
    loader = dm.train_dataloader(loader_type="saint")
    checkpoint = ModelCheckpoint(
        dirpath=os.path.join(cfg.ckpt_dir, stage, exp_name),
        monitor="val_loss", save_top_k=3, mode="min", save_last=True)
    logger = MetricsLogger(save_dir=os.path.join(cfg.log_dir, stage,
                                                 exp_name),
                           experiment_name=exp_name, project_name=project)
    trainer = Trainer(max_epochs=cfg.epochs,
                      check_val_every_n_epoch=cfg.val_every_epoch,
                      gradient_clip_val=1.0, callbacks=[checkpoint],
                      logger=logger, fast_dev_run=cfg.debug,
                      log_every_n_steps=10, devices=cfg.get("devices"),
                      steps_per_execution=cfg.get("steps_per_execution", 1))
    print(f"train_{stage}: {dm.graph.num_nodes} nodes, {dm.graph.num_edges} "
          f"edges, features {tuple(dm.graph.x.shape[1:])} "
          f"({cfg.data.node_init_method}); SAINT envelope "
          f"{loader.node_budget} nodes x {loader.edge_budget} edges; "
          f"{len(loader)} steps x {cfg.epochs} epochs on {module.device}"
          f"{note}", flush=True)
    try:
        trainer.fit(module, train_dataloaders=loader,
                    val_dataloaders=dm.val_dataloader(loader_type="saint"),
                    init_params=init_params)
        trainer.test(module,
                     dataloaders=dm.test_dataloader(loader_type="saint"),
                     ckpt_path=None if cfg.debug else "best")
        run_entrypoint_inductive_eval(module, trainer, dm, cfg)
    finally:
        logger.close()
    print(f"checkpoint: {trainer.tested_ckpt_path}", flush=True)
    return trainer.tested_ckpt_path


def new_module(cfg: Config, num_relation: int) -> KGEModule:
    """The KGE module ``cfg.model`` describes, its input width the
    features' (``data.embed_dim``)."""
    return KGEModule(**dict(cfg.model, in_dim=cfg.data.embed_dim),
                     num_relation=num_relation, neg_ratio=cfg.neg_ratio,
                     node_init_method=cfg.data.node_init_method,
                     seed=cfg.seed)


def train(cfg: Config):
    """Train, validate and test as ``cfg`` says; returns the path of the
    checkpoint the test loaded, or with ``typed_tables`` the test
    metrics."""
    typed = cfg.get("typed_tables", False)
    if typed and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            "typed_tables trains on one device: data-parallel typed "
            "training is not ported (ROADMAP.md queue 1, item 12c); run it "
            "as one process, without a launcher")
    device = distributed_init_if_needed(cfg.get("device"))
    dm = data_module(cfg)
    if typed:
        module = new_module(cfg, dm.data.num_edge_types)
        if cfg.get("typed_loader", "full") == "saint":
            return typed_saint_train(module, dm, cfg, device)
        return typed_full_train(module, dm, cfg, device)
    module = new_module(cfg, dm.data.num_edge_types).to(device)
    return fit_and_test(cfg, dm, module, "kge", experiment_name(cfg),
                        "BioMedKG-KGE")


def main(argv: Optional[List[str]] = None):
    argv = sys.argv[1:] if argv is None else argv
    cfg = load_config(CONFIG_DIR, "kge", cli_overrides(argv))
    if cfg.get("typed_tables", False):
        # the typed loops run on one device, as the JAX package's do
        if cards_asked(cfg.get("devices"), cfg.get("device")) > 1:
            warnings.warn(f"typed_tables trains on one card, not the "
                          f"devices={cfg.get('devices')!r} asked for "
                          "(ROADMAP.md queue 1, item 12c)", stacklevel=2)
    elif per_card(__spec__.name, argv, cfg.get("devices"),
                  cfg.get("device")):
        return None
    return train(cfg)


if __name__ == "__main__":
    main()
