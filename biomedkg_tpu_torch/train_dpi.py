"""DPI fine-tuning (counterpart of train_dpi.py at the repo root), the
reference's flow on the port's Trainer:

    python -m biomedkg_tpu_torch.train_dpi [key=value ...]

The arguments are overrides of configs/dpi.yaml (with configs/data/
dpi.yaml and configs/model/kge.yaml), read by the config layer
(config.py), so ``scripts/dpi.sh``'s arguments work verbatim; the keys are
``train_kge``'s (train_kge.py: ``steps``, ``device``, ``epochs``,
``val_every_epoch``, ``neg_ratio``, ``data.*``, ``model.*``, ...) and
``pretrained_path``.

The data are the DPI benchmark's (data/modules.py::DPIModule: the csv
``BIOMEDKG_DPI_CSV`` names, else ``data.data_dir``, else the synthetic DTI
graph), made undirected and split. ``pretrained_path`` empty (or none /
null) trains ``model.*`` from scratch over the DPI graph's one relation; a
``.ckpt`` file (the port's own, the JAX package's, or a reference
Lightning checkpoint) warm-starts from its weights and hyper-parameters,
with every edge pinned to PrimeKG's drug-protein relation (``fix_edge_id
= 1``) so the pretrained relation row transfers, and ``neg_ratio`` from
the config; a directory (an orbax checkpoint) raises, as does any other
value. Then it fits on SAINT batches in the encoder's layout ("dst" for
RGCN), validates every ``val_every_epoch`` epochs keeping the 3
checkpoints of least ``val_loss`` and ``last.ckpt`` under
``<ckpt_dir>/dpi/<experiment>/``, tests the best, and with
``data.unseen_node_ratio > 0`` (e.g. ``data.unseen_node_types=[drug]``)
runs the cold-start eval. It trains on the card unless ``device=cpu``.
``train`` returns the path of the checkpoint the test loaded.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

from .config import CONFIG_DIR, Config, cli_overrides, load_config
from .device import resolve_device
from .train_kge import (data_module, experiment_name, fit_and_test,
                        new_module)
from .training.checkpoint import load_any
from .training.kge_module import KGEModule, _parse_neg_ratio

# PrimeKG's drug-protein relation id (reference train_dpi.py:33-35)
DRUG_PROTEIN = 1


def warm_start_path(cfg: Config) -> Optional[str]:
    """``pretrained_path`` when it names a checkpoint to warm-start from
    (a ``.ckpt`` file or a directory), None when it is empty, none or
    null; anything else raises."""
    path = str(cfg.get("pretrained_path") or "")
    if path.endswith(".ckpt") or os.path.isdir(path):
        return path
    if path.lower() not in ("none", "null", ""):
        raise ValueError(
            f"pretrained_path={path!r} is neither a .ckpt file nor an "
            "orbax checkpoint directory")
    return None


def train(cfg: Config) -> Optional[str]:
    """Fine-tune, validate and test as ``cfg`` says; returns the path of
    the checkpoint the test loaded."""
    device = resolve_device(cfg.get("device"))
    dm = data_module(cfg)
    path = warm_start_path(cfg)
    init_params, note = None, " from scratch"
    if path is None:
        module = new_module(cfg, dm.data.num_edge_types)
    else:
        ckpt = load_any(path)
        if ckpt["kind"] != "kge":
            raise ValueError(f"not a KGE checkpoint: {path}")
        module = KGEModule(**ckpt["hparams"])
        width = dm.graph.x.shape[-1]
        if module.hparams["in_dim"] != width:
            raise ValueError(
                f"{path}: the model takes {module.hparams['in_dim']}-wide "
                f"features, the data {width} (data.embed_dim)")
        module.fix_edge_id = DRUG_PROTEIN
        module.neg_ratio = _parse_neg_ratio(cfg.neg_ratio)
        init_params = ckpt["params"]
        note = f", warm-started from {path} (fix_edge_id {DRUG_PROTEIN})"
    return fit_and_test(cfg, dm, module.to(device), "dpi",
                        # the reference's train_dpi.py joins the GCL
                        # model to the node init without a separator
                        experiment_name(cfg, gcl_sep=""), "BioMedKG-DPI",
                        init_params=init_params, note=note)


def main(argv: Optional[List[str]] = None) -> Optional[str]:
    return train(load_config(CONFIG_DIR, "dpi", cli_overrides(
        sys.argv[1:] if argv is None else argv)))


if __name__ == "__main__":
    main()
