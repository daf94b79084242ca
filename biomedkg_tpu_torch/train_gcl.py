"""Stage B: graph contrastive pretraining of one node type's graph
(counterpart of train_gcl.py at the repo root):

    python -m biomedkg_tpu_torch.train_gcl [key=value ...]

Keys: ``model.model_name`` (ggd, dgi or grace; default ggd),
``data.node_type`` (gene, drug or disease; the default, the config's three
types, is refused as the reference refuses it), ``epochs`` (100), ``steps``
(neighbour batches per epoch; default all), ``seed`` (42), ``device``
(cuda), ``ckpt_dir`` (./ckpt) and ``model.compute_dtype`` (float32 or
bfloat16). The other settings are the defaults of configs/gcl.yaml,
configs/model/gcl.yaml, configs/model/base.yaml and
configs/data/primekg.yaml, written out below until the config layer is
ported.

It trains the model's GCN on [30, 30, 30] neighbour batches of 128 seeds
from the node type's train split, destination-sorted (the GCN's sums on
the CUDA segment-sum) with the features gathered from a device-resident
table, Adam with the cosine warm-up and clip 1.0, and writes
``<ckpt_dir>/gcl/<node_type>/<model>_<fuse>_<init>_<time>/last.ckpt``, the
layout the reference's GCL node encoder globs; ``load_gcl_module`` loads
it in either package. Validation and test epochs, top-1 checkpoints and
early stopping wait for the Trainer (ROADMAP.md).
"""

from __future__ import annotations

import itertools
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
from .training.gcl_module import create_gcl_model

MODEL = dict(model_name="ggd", in_dim=768, hidden_dim=256, out_dim=256,
             num_hidden_layers=2, compute_dtype="float32",
             scheduler_type="cosine", learning_rate=0.001,
             warm_up_ratio=0.2, fuse_method="none")
DEFAULTS = {"model.model_name": MODEL["model_name"],
            "data.node_type": ",".join(PRIMEKG_DATA["node_type"]),
            "epochs": 100, "steps": None, "seed": 42, "device": None,
            "ckpt_dir": "./ckpt",
            "model.compute_dtype": MODEL["compute_dtype"]}
_INTS = ("epochs", "steps", "seed")
GRAD_CLIP = 1.0


def parse_args(argv: List[str]) -> dict:
    args = dict(DEFAULTS)
    for arg in argv:
        key, sep, value = arg.partition("=")
        if not sep or key not in args:
            raise SystemExit(f"usage: train_gcl [key=value ...] with keys "
                             f"{sorted(DEFAULTS)}; got {arg!r}")
        if key in _INTS:
            args[key] = (None if key == "steps" and value.lower() in
                         ("none", "null", "") else int(value))
        else:
            args[key] = value
    return args


def node_types(value: str) -> List[str]:
    """The data key's node types: the reference maps gene to
    gene/protein and trains exactly one."""
    names = [v.strip() for v in value.strip("[]").split(",") if v.strip()]
    if len(names) != 1:
        raise ValueError("Please select only one node type")
    return ["gene/protein" if names[0].startswith("gene") else names[0]]


def train(args: dict) -> str:
    """Train as ``args`` says; returns the checkpoint's path."""
    node_type = node_types(args["data.node_type"])
    device = resolve_device(args["device"])
    seed, epochs = args["seed"], args["epochs"]
    model = dict(MODEL, model_name=args["model.model_name"],
                 compute_dtype=args["model.compute_dtype"])
    log_name = (f"{model['model_name']}_{model['fuse_method']}_"
                f"{PRIMEKG_DATA['node_init_method']}_{int(time.time())}")
    path = os.path.join(args["ckpt_dir"], "gcl", args["data.node_type"],
                        log_name, "last.ckpt")

    dm = PrimeKGModule(**dict(PRIMEKG_DATA, node_type=node_type), seed=seed)
    dm.setup(stage="split")
    module = create_gcl_model(model, seed=seed).to(device)
    dm.device_features = True
    module.set_feature_table(dm.graph.x)
    dm.edge_layout = module.edge_layout = "dst"
    loader = dm.train_dataloader(loader_type="neighbor")
    steps = len(loader) if args["steps"] is None else min(args["steps"],
                                                          len(loader))
    module.configure_optimizers(steps * epochs, grad_clip=GRAD_CLIP)
    state = module.init_state(torch.Generator().manual_seed(seed))
    generator = torch.Generator(device=device).manual_seed(seed)
    print(f"train_gcl: {model['model_name']} on {node_type[0]}: "
          f"{dm.graph.num_nodes} nodes, {dm.graph.num_edges} edges; "
          f"neighbour envelope {loader.node_budget} nodes x "
          f"{loader.edge_budget} edges; {steps} steps x {epochs} epochs on "
          f"{device}", flush=True)

    for epoch in range(epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        losses = []
        for batch in itertools.islice(loader, steps):
            state, logs = module.train_step(
                state, batch_to_device(batch, device), generator)
            losses.append(logs["train_loss"])
        mean = float(torch.stack(losses).mean())
        print(f"epoch {epoch}: {len(losses)} steps, mean train_loss "
              f"{mean:.6f}, {time.perf_counter() - t0:.2f} s", flush=True)

    save_train_state(path, module, state,
                     extras={"epoch": epochs,
                             "model_name": model["model_name"]})
    print(f"checkpoint: {path}", flush=True)
    return path


def main(argv: Optional[List[str]] = None) -> str:
    return train(parse_args(sys.argv[1:] if argv is None else argv))


if __name__ == "__main__":
    main()
