"""KGE link-prediction training (counterpart of train_kge.py at the repo
root), the reference's flow on the port's Trainer:

    python -m biomedkg_tpu_torch.train_kge [key=value ...]

Keys: ``epochs`` (default 100), ``val_every_epoch`` (2), ``neg_ratio``
(10), ``saint_fill`` (none; e.g. 0.92 tops SAINT batches up to that share
of the envelope), ``steps`` (SAINT steps per epoch; default the data
module's 1000; it also sets the val and test epochs to max(1, steps // 10)
batches, else 100), ``steps_per_execution`` (16: batches per prefetch
item), ``debug`` (false; true runs one train and one val batch and tests
the trained weights), ``seed`` (42), ``device`` (cuda), ``ckpt_dir``
(./ckpt), ``log_dir`` (./log), ``model.compute_dtype`` (float32 or
bfloat16), ``model.encoder_name`` (rgcn or rgat), ``model.num_heads``
(RGAT's heads, 2), ``model.decoder_name`` (dismult, distmult, transe,
complex or rotate), ``model.neg_sampler`` (sorted, sorted2 or iid),
``model.cold_start_dropout`` (0.0; p > 0 isolates each node in the
encoder with probability p every step), ``data.unseen_node_ratio`` (0.0;
> 0 holds that share of the nodes out, data/inductive.py),
``data.unseen_node_types`` (none; e.g. [drug] holds out only those),
``unseen_ranking`` (true: the cold-start eval also ranks) and
``unseen_rank_max_triples`` (2048: the most triples it ranks).
The other settings are the defaults of configs/kge.yaml,
configs/model/kge.yaml and configs/data/primekg.yaml, written out below
until the config layer is ported; the model's input width is
data.embed_dim (768), which the reference's scripts also pass as
model.in_dim.

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
``Trainer.fit(resume_from=...)`` resumes. It trains on the one card
``device`` names, whatever the host holds: configs/kge.yaml's
``devices: 0,1`` asks for data parallelism over two, which is not ported
(ROADMAP.md queue 1, item 12). ``train`` returns the path of
the checkpoint the test loaded (None when it tested the weights in
memory: ``debug``, or no validation ran).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

from .data.modules import PrimeKGModule
from .device import resolve_device
from .eval.inductive import run_entrypoint_inductive_eval
from .serve import PRIMEKG_DATA
from .training.checkpoint import ModelCheckpoint
from .training.kge_module import KGEModule
from .training.logger import MetricsLogger
from .training.trainer import Trainer

MODEL = dict(encoder_name="rgcn", decoder_name="dismult",
             in_dim=PRIMEKG_DATA["embed_dim"], hidden_dim=256, out_dim=256,
             num_hidden_layers=2, num_heads=2, scheduler_type="cosine",
             learning_rate=0.001, warm_up_ratio=0.2, fuse_method="none",
             neg_sampler="sorted", cold_start_dropout=0.0)
DEFAULTS = {"epochs": 100, "val_every_epoch": 2, "neg_ratio": 10,
            "saint_fill": None, "steps": None, "steps_per_execution": 16,
            "debug": False, "seed": 42, "device": None,
            "ckpt_dir": "./ckpt", "log_dir": "./log",
            "model.compute_dtype": "float32",
            "model.encoder_name": MODEL["encoder_name"],
            "model.num_heads": MODEL["num_heads"],
            "model.decoder_name": MODEL["decoder_name"],
            "model.neg_sampler": MODEL["neg_sampler"],
            "model.cold_start_dropout": 0.0,
            "data.unseen_node_ratio": 0.0, "data.unseen_node_types": None,
            "unseen_ranking": True, "unseen_rank_max_triples": 2048}
# the type of each key that is not a string (none / null give a key whose
# default is None its default)
KINDS = {"epochs": int, "val_every_epoch": int, "neg_ratio": int,
         "steps": int, "steps_per_execution": int, "seed": int,
         "model.num_heads": int, "unseen_rank_max_triples": int,
         "saint_fill": float, "model.cold_start_dropout": float,
         "data.unseen_node_ratio": float, "debug": bool,
         "unseen_ranking": bool, "data.unseen_node_types": list}


def parse_bool(value: str) -> bool:
    if value.lower() in ("true", "1", "yes"):
        return True
    if value.lower() in ("false", "0", "no"):
        return False
    raise SystemExit(f"not a boolean: {value!r}")


def parse_list(value: str) -> List[str]:
    """``[drug, disease]``, ``["drug"]`` or ``drug,disease``."""
    items = (v.strip().strip("'\"") for v in value.strip("[]").split(","))
    return [v for v in items if v]


def parse_keys(argv: List[str], defaults: dict, kinds: dict,
               prog: str) -> dict:
    """``key=value`` arguments over ``defaults``, each converted to its
    type in ``kinds`` (a string otherwise; none or null leave a key whose
    default is None at None); an unknown key exits with the usage."""
    args = dict(defaults)
    convert = {int: int, float: float, bool: parse_bool, list: parse_list}
    for arg in argv:
        key, sep, value = arg.partition("=")
        if not sep or key not in args:
            raise SystemExit(f"usage: {prog} [key=value ...] with keys "
                             f"{sorted(defaults)}; got {arg!r}")
        if defaults[key] is None and value.lower() in ("none", "null", ""):
            args[key] = None
        else:
            args[key] = convert.get(kinds.get(key), str)(value)
    return args


def parse_args(argv: List[str]) -> dict:
    return parse_keys(argv, DEFAULTS, KINDS, "train_kge")


def data_module(args: dict) -> PrimeKGModule:
    """The PrimeKG module of ``args`` (``seed`` and the unseen-node keys),
    set up with its splits."""
    dm = PrimeKGModule(**PRIMEKG_DATA, seed=args["seed"],
                       unseen_node_ratio=args["data.unseen_node_ratio"],
                       unseen_node_types=args["data.unseen_node_types"])
    dm.setup(stage="split")
    return dm


def train(args: dict) -> Optional[str]:
    """Train, validate and test as ``args`` says; returns the path of the
    checkpoint the test loaded."""
    device = resolve_device(args["device"])
    seed = args["seed"]
    dm = data_module(args)
    dm.device_features = True
    dm.saint_fill_target = args["saint_fill"]
    if args["steps"] is not None:
        dm.SAINT_TRAIN_STEPS = args["steps"]
        dm.SAINT_EVAL_STEPS = max(1, args["steps"] // 10)

    model = dict(MODEL, encoder_name=args["model.encoder_name"],
                 num_heads=args["model.num_heads"],
                 decoder_name=args["model.decoder_name"],
                 neg_sampler=args["model.neg_sampler"],
                 cold_start_dropout=args["model.cold_start_dropout"])
    module = KGEModule(**model, num_relation=dm.data.num_edge_types,
                       neg_ratio=args["neg_ratio"],
                       node_init_method=PRIMEKG_DATA["node_init_method"],
                       seed=seed, compute_dtype=args["model.compute_dtype"])
    module.to(device)
    module.edge_mapping = dm.edge_map_index
    module.edge_layout = dm.edge_layout = module.default_layout
    module.set_feature_table(dm.graph.x)
    loader = dm.train_dataloader(loader_type="saint")

    exp_name = (f"{model['encoder_name']}_{model['decoder_name']}_"
                f"{PRIMEKG_DATA['node_init_method']}{int(time.time())}")
    checkpoint = ModelCheckpoint(
        dirpath=os.path.join(args["ckpt_dir"], "kge", exp_name),
        monitor="val_loss", save_top_k=3, mode="min", save_last=True)
    logger = MetricsLogger(save_dir=os.path.join(args["log_dir"], "kge",
                                                 exp_name),
                           experiment_name=exp_name,
                           project_name="BioMedKG-KGE")
    trainer = Trainer(max_epochs=args["epochs"],
                      check_val_every_n_epoch=args["val_every_epoch"],
                      gradient_clip_val=1.0, callbacks=[checkpoint],
                      logger=logger, fast_dev_run=args["debug"],
                      log_every_n_steps=10,
                      steps_per_execution=args["steps_per_execution"])
    print(f"train_kge: {dm.graph.num_nodes} nodes, {dm.graph.num_edges} "
          f"edges; SAINT envelope {loader.node_budget} nodes x "
          f"{loader.edge_budget} edges; {len(loader)} steps x "
          f"{args['epochs']} epochs on {device}", flush=True)
    try:
        trainer.fit(module, train_dataloaders=loader,
                    val_dataloaders=dm.val_dataloader(loader_type="saint"))
        trainer.test(module,
                     dataloaders=dm.test_dataloader(loader_type="saint"),
                     ckpt_path=None if args["debug"] else "best")
        run_entrypoint_inductive_eval(module, trainer, dm, args)
    finally:
        logger.close()
    print(f"checkpoint: {trainer.tested_ckpt_path}", flush=True)
    return trainer.tested_ckpt_path


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    return train(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
