"""KGE link-prediction training (counterpart of train_kge.py at the repo
root), the training step of this slice:

    python -m biomedkg_tpu_torch.train_kge [key=value ...]

Keys: ``epochs`` (default 100), ``neg_ratio`` (10), ``saint_fill`` (none;
e.g. 0.92 tops SAINT batches up to that share of the envelope), ``steps``
(SAINT steps per epoch; default the data module's 1000), ``seed`` (42),
``device`` (cuda), ``ckpt_dir`` (./ckpt), ``model.compute_dtype``
(float32 or bfloat16), ``model.encoder_name`` (rgcn or rgat),
``model.num_heads`` (RGAT's heads, 2), ``model.decoder_name`` (dismult,
distmult, transe, complex or rotate) and ``model.neg_sampler`` (sorted,
sorted2 or iid).
The other settings are the defaults of configs/kge.yaml,
configs/model/kge.yaml and configs/data/primekg.yaml, written out below
until the config layer is ported; the model's input width is
data.embed_dim (768), which the reference's scripts also pass as
model.in_dim.

It trains the chosen encoder and decoder on GraphSAINT batches of the
train split (features gathered from a device-resident table) in the
layout the reference picks: "dst" for RGCN, "relation" for RGAT, whose
grouped GEMM needs single-relation blocks. It writes ``<ckpt_dir>/kge/<experiment>/last.ckpt`` with the optimizer
state, which ``KGEScorer`` serves and ``load_train_state`` resumes. The Trainer
(validation and test metrics, top-k checkpoints, early stopping, resume)
comes in a later slice (ROADMAP.md).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Optional

import torch

from .data.modules import PrimeKGModule
from .device import resolve_device
from .sampling.batch import batch_to_device
from .serve import PRIMEKG_DATA
from .training.checkpoint import save_train_state
from .training.kge_module import KGEModule

MODEL = dict(encoder_name="rgcn", decoder_name="dismult",
             in_dim=PRIMEKG_DATA["embed_dim"], hidden_dim=256, out_dim=256,
             num_hidden_layers=2, num_heads=2, scheduler_type="cosine",
             learning_rate=0.001, warm_up_ratio=0.2, fuse_method="none",
             neg_sampler="sorted", cold_start_dropout=0.0)
DEFAULTS = {"epochs": 100, "neg_ratio": 10, "saint_fill": None,
            "steps": None, "seed": 42, "device": None, "ckpt_dir": "./ckpt",
            "model.compute_dtype": "float32",
            "model.encoder_name": MODEL["encoder_name"],
            "model.num_heads": MODEL["num_heads"],
            "model.decoder_name": MODEL["decoder_name"],
            "model.neg_sampler": MODEL["neg_sampler"]}
_INTS = ("epochs", "neg_ratio", "steps", "seed", "model.num_heads")


def parse_args(argv: List[str]) -> dict:
    args = dict(DEFAULTS)
    for arg in argv:
        key, sep, value = arg.partition("=")
        if not sep or key not in args:
            raise SystemExit(f"usage: train_kge [key=value ...] with keys "
                             f"{sorted(DEFAULTS)}; got {arg!r}")
        none = value.lower() in ("none", "null", "")
        if key in _INTS:
            args[key] = None if none and key == "steps" else int(value)
        elif key == "saint_fill":
            args[key] = None if none else float(value)
        else:
            args[key] = value
    return args


def train(args: dict) -> str:
    """Train as ``args`` says; returns the checkpoint's path."""
    device = resolve_device(args["device"])
    seed = args["seed"]
    dm = PrimeKGModule(**PRIMEKG_DATA, seed=seed)
    dm.setup(stage="split")
    dm.device_features = True
    dm.saint_fill_target = args["saint_fill"]
    if args["steps"] is not None:
        dm.SAINT_TRAIN_STEPS = args["steps"]

    model = dict(MODEL, encoder_name=args["model.encoder_name"],
                 num_heads=args["model.num_heads"],
                 decoder_name=args["model.decoder_name"],
                 neg_sampler=args["model.neg_sampler"])
    module = KGEModule(**model, num_relation=dm.data.num_edge_types,
                       neg_ratio=args["neg_ratio"],
                       node_init_method=PRIMEKG_DATA["node_init_method"],
                       seed=seed, compute_dtype=args["model.compute_dtype"])
    module.to(device)
    module.edge_layout = dm.edge_layout = module.default_layout
    module.set_feature_table(dm.graph.x)
    loader = dm.train_dataloader(loader_type="saint")
    module.configure_optimizers(len(loader) * args["epochs"])
    state = module.init_state(torch.Generator().manual_seed(seed))
    generator = torch.Generator(device=device).manual_seed(seed)
    print(f"train_kge: {dm.graph.num_nodes} nodes, {dm.graph.num_edges} "
          f"edges; SAINT envelope {loader.node_budget} nodes x "
          f"{loader.edge_budget} edges; {len(loader)} steps x "
          f"{args['epochs']} epochs on {device}", flush=True)

    for epoch in range(args["epochs"]):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        losses = []
        for batch in loader:
            state, logs = module.train_step(
                state, batch_to_device(batch, device), generator)
            losses.append(logs["train_loss"])
        mean = float(torch.stack(losses).mean())
        print(f"epoch {epoch}: {len(losses)} steps, mean train_loss "
              f"{mean:.6f}, {time.perf_counter() - t0:.2f} s", flush=True)

    exp_name = (f"{model['encoder_name']}_{model['decoder_name']}_"
                f"{PRIMEKG_DATA['node_init_method']}{int(time.time())}")
    path = os.path.join(args["ckpt_dir"], "kge", exp_name, "last.ckpt")
    save_train_state(path, module, state, extras={"epoch": args["epochs"]})
    print(f"checkpoint: {path}", flush=True)
    return path


def main(argv: Optional[List[str]] = None) -> str:
    return train(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
