"""Stage B: graph contrastive pretraining of one node type's graph
(counterpart of train_gcl.py at the repo root), the reference's flow on
the port's Trainer:

    python -m biomedkg_tpu_torch.train_gcl [key=value ...]

Keys: ``model.model_name`` (ggd, dgi or grace; default ggd),
``data.node_type`` (gene, drug or disease; the default, the config's three
types, is refused as the reference refuses it), ``epochs`` (100),
``val_every_epoch`` (2), ``steps`` (neighbour batches per train epoch;
default all; the val and test epochs stay whole), ``steps_per_execution``
(8: batches per prefetch item), ``debug`` (false; true runs one train and
one val batch and tests the trained weights), ``seed`` (42), ``device``
(cuda), ``ckpt_dir`` (./ckpt), ``log_dir`` (./log) and
``model.compute_dtype`` (float32 or bfloat16). The other settings are the
defaults of configs/gcl.yaml, configs/model/gcl.yaml,
configs/model/base.yaml and configs/data/primekg.yaml, written out below
until the config layer is ported.

It trains the model's GCN on [30, 30, 30] neighbour batches of 128 seeds
from the node type's train split, destination-sorted (the GCN's sums on
the CUDA segment-sum) with the features gathered from a device-resident
table, Adam with the cosine warm-up and clip 1.0; validates on the val
split's neighbour batches every ``val_every_epoch`` epochs, keeps the one
checkpoint of least ``val_loss`` and stops after 5 validations without a
better one; then tests that checkpoint on the test split. Checkpoints go
to ``<ckpt_dir>/gcl/<node_type>/<model>_<fuse>_<init>_<time>/``, the
layout the reference's GCL node encoder globs (``load_gcl_module`` loads
them in either package), metrics to the same path under ``<log_dir>``.
Like ``train_kge``, it trains on the one card ``device`` names (the
config's two-card ``devices`` is ROADMAP.md queue 1, item 12).
``train`` returns the path of the checkpoint the test loaded.
"""

from __future__ import annotations

import itertools
import os
import sys
import time
from typing import List, Optional

from .data.modules import PrimeKGModule
from .device import resolve_device
from .serve import PRIMEKG_DATA
from .train_kge import parse_keys
from .training.checkpoint import EarlyStopping, ModelCheckpoint
from .training.gcl_module import create_gcl_model
from .training.logger import MetricsLogger
from .training.trainer import Trainer

MODEL = dict(model_name="ggd", in_dim=768, hidden_dim=256, out_dim=256,
             num_hidden_layers=2, compute_dtype="float32",
             scheduler_type="cosine", learning_rate=0.001,
             warm_up_ratio=0.2, fuse_method="none")
DEFAULTS = {"model.model_name": MODEL["model_name"],
            "data.node_type": ",".join(PRIMEKG_DATA["node_type"]),
            "epochs": 100, "val_every_epoch": 2, "steps": None,
            "steps_per_execution": 8, "debug": False, "seed": 42,
            "device": None, "ckpt_dir": "./ckpt", "log_dir": "./log",
            "model.compute_dtype": MODEL["compute_dtype"]}
KINDS = {"epochs": int, "val_every_epoch": int, "steps": int,
         "steps_per_execution": int, "seed": int, "debug": bool}
PATIENCE = 5
GRAD_CLIP = 1.0


def parse_args(argv: List[str]) -> dict:
    return parse_keys(argv, DEFAULTS, KINDS, "train_gcl")


def node_types(value: str) -> List[str]:
    """The data key's node types: the reference maps gene to
    gene/protein and trains exactly one."""
    names = [v.strip() for v in value.strip("[]").split(",") if v.strip()]
    if len(names) != 1:
        raise ValueError("Please select only one node type")
    return ["gene/protein" if names[0].startswith("gene") else names[0]]


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


def train(args: dict) -> Optional[str]:
    """Train, validate and test as ``args`` says; returns the path of the
    checkpoint the test loaded."""
    node_type = node_types(args["data.node_type"])
    device = resolve_device(args["device"])
    seed, epochs = args["seed"], args["epochs"]
    model = dict(MODEL, model_name=args["model.model_name"],
                 compute_dtype=args["model.compute_dtype"])
    log_name = (f"{model['model_name']}_{model['fuse_method']}_"
                f"{PRIMEKG_DATA['node_init_method']}_{int(time.time())}")

    dm = PrimeKGModule(**dict(PRIMEKG_DATA, node_type=node_type), seed=seed)
    dm.setup(stage="split")
    module = create_gcl_model(model, seed=seed).to(device)
    dm.device_features = True
    module.set_feature_table(dm.graph.x)
    dm.edge_layout = module.edge_layout = "dst"
    loader = dm.train_dataloader(loader_type="neighbor")
    steps = len(loader) if args["steps"] is None else min(args["steps"],
                                                          len(loader))

    checkpoint = ModelCheckpoint(
        dirpath=os.path.join(args["ckpt_dir"], "gcl", args["data.node_type"],
                             log_name),
        monitor="val_loss", save_top_k=1, mode="min")
    early_stopping = EarlyStopping(monitor="val_loss", mode="min",
                                   patience=PATIENCE)
    logger = MetricsLogger(
        save_dir=os.path.join(args["log_dir"], "gcl", args["data.node_type"],
                              log_name),
        experiment_name=log_name, project_name=f"BioMedKG-GCL-{node_type}")
    trainer = Trainer(max_epochs=epochs,
                      check_val_every_n_epoch=args["val_every_epoch"],
                      gradient_clip_val=GRAD_CLIP,
                      callbacks=[checkpoint, early_stopping], logger=logger,
                      fast_dev_run=args["debug"], log_every_n_steps=10,
                      steps_per_execution=args["steps_per_execution"])
    print(f"train_gcl: {model['model_name']} on {node_type[0]}: "
          f"{dm.graph.num_nodes} nodes, {dm.graph.num_edges} edges; "
          f"neighbour envelope {loader.node_budget} nodes x "
          f"{loader.edge_budget} edges; {steps} steps x {epochs} epochs on "
          f"{device}", flush=True)
    try:
        trainer.fit(module, train_dataloaders=FirstBatches(loader, steps),
                    val_dataloaders=dm.val_dataloader(loader_type="neighbor"))
        trainer.test(module, dataloaders=dm.test_dataloader(),
                     ckpt_path=None if args["debug"] else "best")
    finally:
        logger.close()
    print(f"checkpoint: {trainer.tested_ckpt_path}", flush=True)
    return trainer.tested_ckpt_path


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    return train(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
