"""KGE module (counterpart of biomedkg_tpu/training/kge_module.py): the
hyper-parameters, the GAE model and the deterministic full-graph encode.

This slice serves: ``fuse_method`` "none" and ``node_init_method``
"random" only (fusion and LM/GCL features raise), and no training step,
which comes with its own slice (ROADMAP.md queue 1). Encoding runs in
float32, as the reference's ``encode`` does whatever ``compute_dtype``
training used.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import resolve_device
from ..interop.jax_params import load_jax_params
from ..models.factory import KGEModelFactory
from ..sampling.batch import GraphBatch
from .checkpoint import load_checkpoint


class KGEModule(nn.Module):
    kind = "kge"

    def __init__(self, encoder_name: str, decoder_name: str, in_dim: int,
                 hidden_dim: int, out_dim: int, num_hidden_layers: int,
                 num_relation: int, num_heads: int, scheduler_type: str,
                 learning_rate: float, warm_up_ratio: float,
                 fuse_method: str, neg_ratio, node_init_method: str,
                 seed: int = 42, compute_dtype: str = "float32",
                 remat: bool = False, neg_sampler: str = "sorted",
                 cold_start_dropout: float = 0.0):
        super().__init__()
        if fuse_method not in (None, "none"):
            raise NotImplementedError(
                f"fuse_method={fuse_method!r} is not ported yet "
                "(ROADMAP.md queue 1: Stage B fusion)")
        if node_init_method not in (None, "random"):
            raise NotImplementedError(
                f"node_init_method={node_init_method!r} is not ported yet "
                "(ROADMAP.md queue 1: Stage A / Stage B encoders)")
        self.hparams = dict(
            encoder_name=encoder_name, decoder_name=decoder_name,
            in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim,
            num_hidden_layers=num_hidden_layers, num_relation=num_relation,
            num_heads=num_heads, scheduler_type=scheduler_type,
            learning_rate=learning_rate, warm_up_ratio=warm_up_ratio,
            fuse_method=fuse_method, neg_ratio=neg_ratio,
            node_init_method=node_init_method, seed=seed,
            compute_dtype=compute_dtype, remat=remat,
            neg_sampler=neg_sampler, cold_start_dropout=cold_start_dropout)
        self.model = KGEModelFactory.get_model(
            encoder_name=encoder_name, decoder_name=decoder_name,
            in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim,
            num_hidden_layers=num_hidden_layers, num_relation=num_relation,
            num_heads=num_heads)

    def init(self, generator: torch.Generator):
        """Fresh weights from ``generator`` (reference init rules)."""
        self.model.init(generator)

    @property
    def edge_layout(self) -> str:
        return self.model.encoder.edge_layout

    @edge_layout.setter
    def edge_layout(self, value: str):
        """"relation" or "dst"; must match the batches' layout."""
        if value not in ("relation", "dst"):
            raise ValueError(f"unknown edge_layout {value!r}")
        self.model.encoder.edge_layout = value

    @property
    def dst_bwd(self) -> str:
        return "scatter"

    @dst_bwd.setter
    def dst_bwd(self, value: str):
        if value in ("perm", "agg"):
            raise NotImplementedError(
                f"dst_bwd={value!r} is not ported yet (ROADMAP.md queue 1: "
                "opt-in variants)")
        if value != "scatter":
            raise ValueError(f"unknown dst_bwd {value!r}")

    @torch.inference_mode()
    def encode(self, batch: GraphBatch) -> torch.Tensor:
        """Deterministic full forward over a device batch
        (sampling/batch.py::batch_to_device) → (N_pad, out_dim)."""
        if batch.x.numel() == 0:
            raise NotImplementedError(
                "batches without features (device-resident feature table) "
                "come with the training slice")
        return self.model.encode(batch.x, batch.edge_index, batch.edge_type,
                                 batch.edge_mask, training=False)


def load_kge_module(ckpt_path: str,
                    device: Optional[torch.device] = None) -> KGEModule:
    """A KGE checkpoint (written by either package) as a module on
    ``device``."""
    ckpt = load_checkpoint(ckpt_path)
    if ckpt["kind"] != "kge":
        raise ValueError(f"not a KGE checkpoint: {ckpt_path}")
    module = KGEModule(**ckpt["hparams"])
    load_jax_params(module.model, ckpt["params"])
    return module.to(resolve_device(device))
