"""Stage B: graph contrastive pretraining of one node type's graph
(counterpart of train_gcl.py at the repo root), the reference's flow on
the port's Trainer:

    python -m biomedkg_tpu_torch.train_gcl [key=value ...]

The arguments are overrides of configs/gcl.yaml (with configs/data/
primekg.yaml, configs/model/gcl.yaml and configs/model/base.yaml), read by
the config layer (config.py), so ``scripts/gcl.sh``'s arguments work
verbatim: ``devices=[0] epochs=100 data.node_type=gene
data.node_init_method=lm data.batch_size=64 model.model_name=ggd
model.learning_rate=0.001 model.fuse_method=attention``. Besides the
config's keys (``epochs``, ``val_every_epoch``, ``steps_per_execution``,
``debug``, ``seed``, ``ckpt_dir``, ``log_dir``, ``model.*`` with
``model.compute_dtype`` float32 or bfloat16, ``data.*``), the port takes
``steps`` (neighbour batches per train epoch; default all; the val and
test epochs stay whole) and ``device`` (cuda). ``data.node_type`` must
name one type (gene, drug or disease; the config's three are refused, as
the reference refuses them). ``data.node_init_method=lm`` reads the LM
cache ``data/embed/primekg_modality_lm.pickle``, which must be present
(building it, Stage A, is not ported); ``model.fuse_method`` attention or
redaf fuses its two modalities (none: their mean).

It trains the model's GCN on [30, 30, 30] neighbour batches of
``data.batch_size`` seeds from the node type's train split,
destination-sorted (the GCN's sums on the CUDA segment-sum) with the
features gathered from a device-resident table, Adam with the cosine
warm-up and clip 1.0; validates on the val split's neighbour batches
every ``val_every_epoch`` epochs, keeps the one checkpoint of least
``val_loss`` and stops after 5 validations without a better one; then
tests that checkpoint on the test split. Checkpoints go to
``<ckpt_dir>/gcl/<data.node_type>/<model>_<fuse>_<init>_<time>/``, the
layout the GCL node encoder globs (data/node_encoders.py::GCLEncode;
``load_gcl_module`` loads them in either package), metrics to the same
path under ``<log_dir>``. Like ``train_kge``, it trains on the one card
``device`` names (the config's two-card ``devices`` is ROADMAP.md queue
1, item 12). ``train`` returns the path of the checkpoint the test
loaded.
"""

from __future__ import annotations

import itertools
import os
import sys
import time
from typing import List, Optional

from .config import CONFIG_DIR, Config, cli_overrides, instantiate, \
    load_config
from .device import resolve_device
from .training.checkpoint import EarlyStopping, ModelCheckpoint
from .training.gcl_module import create_gcl_model
from .training.logger import MetricsLogger
from .training.trainer import Trainer

PATIENCE = 5
GRAD_CLIP = 1.0


def node_types(value) -> List[str]:
    """The data key's node type as the data module takes it: the reference
    maps gene to gene/protein and trains exactly one."""
    if isinstance(value, (list, tuple)):
        if len(value) > 1:
            raise ValueError("Please select only one node type")
        value = value[0]
    return ["gene/protein" if str(value).startswith("gene") else value]


class FirstBatches:
    """The first ``steps`` batches of ``loader`` each epoch."""

    def __init__(self, loader, steps: int):
        self.loader = loader
        self.steps = steps

    def set_epoch(self, epoch: int):
        self.loader.set_epoch(epoch)

    def __iter__(self):
        return itertools.islice(self.loader, self.steps)

    def __len__(self):
        return self.steps


def train(cfg: Config) -> Optional[str]:
    """Train, validate and test as ``cfg`` says; returns the path of the
    checkpoint the test loaded."""
    log_name = (f"{cfg.model.model_name}_{cfg.model.fuse_method}"
                f"_{cfg.data.node_init_method}_{int(time.time())}")
    type_dir = str(cfg.data.node_type)
    cfg.data.node_type = node_types(cfg.data.node_type)
    device = resolve_device(cfg.get("device"))

    dm = instantiate(cfg.data, seed=cfg.seed, device=cfg.get("device"))
    dm.setup(stage="split")
    module = create_gcl_model(cfg.model, seed=cfg.seed).to(device)
    dm.device_features = True
    module.set_feature_table(dm.graph.x)
    dm.edge_layout = module.edge_layout = "dst"
    loader = dm.train_dataloader(loader_type="neighbor")
    steps = len(loader) if cfg.get("steps") is None else min(
        int(cfg.steps), len(loader))

    checkpoint = ModelCheckpoint(
        dirpath=os.path.join(cfg.ckpt_dir, "gcl", type_dir, log_name),
        monitor="val_loss", save_top_k=1, mode="min")
    early_stopping = EarlyStopping(monitor="val_loss", mode="min",
                                   patience=PATIENCE)
    logger = MetricsLogger(
        save_dir=os.path.join(cfg.log_dir, "gcl", type_dir, log_name),
        experiment_name=log_name,
        project_name=f"BioMedKG-GCL-{cfg.data.node_type}")
    trainer = Trainer(max_epochs=cfg.epochs,
                      check_val_every_n_epoch=cfg.val_every_epoch,
                      gradient_clip_val=GRAD_CLIP,
                      callbacks=[checkpoint, early_stopping], logger=logger,
                      fast_dev_run=cfg.debug, log_every_n_steps=10,
                      steps_per_execution=cfg.get("steps_per_execution", 1))
    print(f"train_gcl: {cfg.model.model_name} on {cfg.data.node_type[0]}: "
          f"{dm.graph.num_nodes} nodes, {dm.graph.num_edges} edges; "
          f"features {tuple(dm.graph.x.shape[1:])} "
          f"({cfg.data.node_init_method}), fusion {cfg.model.fuse_method}; "
          f"neighbour envelope {loader.node_budget} nodes x "
          f"{loader.edge_budget} edges; {steps} steps x {cfg.epochs} epochs "
          f"on {device}", flush=True)
    try:
        trainer.fit(module, train_dataloaders=FirstBatches(loader, steps),
                    val_dataloaders=dm.val_dataloader(loader_type="neighbor"))
        trainer.test(module, dataloaders=dm.test_dataloader(),
                     ckpt_path=None if cfg.debug else "best")
    finally:
        logger.close()
    print(f"checkpoint: {trainer.tested_ckpt_path}", flush=True)
    return trainer.tested_ckpt_path


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    return train(load_config(CONFIG_DIR, "gcl", cli_overrides(
        sys.argv[1:] if argv is None else argv)))


if __name__ == "__main__":
    main()
