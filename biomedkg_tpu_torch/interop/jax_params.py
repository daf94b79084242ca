"""Carry parameters between the JAX package's tree and the port's modules.

The JAX ``KGEModule`` keeps its parameters as a tree of arrays
(``params["model"]["encoder"]["layers"][i]`` with ``w_rel`` (R, din,
dout), ``w_root`` (din, dout), ``b`` (dout,), and
``params["model"]["decoder"]["rel_emb"]`` (R, d)); native checkpoints
store that tree as numpy. The port keeps the same tensors, under the same
names and layouts, in ``model.encoder.layers[i]`` and
``model.decoder.rel_emb``, so the mapping is a checked copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def _copy(dst: nn.Parameter, src, name: str):
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: checkpoint shape {tuple(src.shape)} != "
                         f"model shape {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))


def load_jax_params(model: nn.Module, params: Dict) -> None:
    """Copy a JAX KGE params tree (``params["model"]``'s parent) into the
    port's ``GAE`` ``model``."""
    if set(params) != {"model"}:
        raise NotImplementedError(
            f"params subtrees {sorted(set(params) - {'model'})} (modality "
            "fusion) are not ported yet (ROADMAP.md queue 1: Stage B)")
    layers = params["model"]["encoder"]["layers"]
    if len(layers) != len(model.encoder.layers):
        raise ValueError(f"checkpoint has {len(layers)} encoder layers, "
                         f"model {len(model.encoder.layers)}")
    for i, (src, dst) in enumerate(zip(layers, model.encoder.layers)):
        if set(src) != {"w_rel", "w_root", "b"}:
            raise ValueError(f"encoder layer {i}: not an RGCN layer "
                             f"({sorted(src)})")
        for name in ("w_rel", "w_root", "b"):
            _copy(getattr(dst, name), src[name], f"layers[{i}].{name}")
    _copy(model.decoder.rel_emb, params["model"]["decoder"]["rel_emb"],
          "decoder.rel_emb")


def to_jax_params(model: nn.Module) -> Dict:
    """The port's ``GAE`` ``model`` as the JAX params tree (numpy leaves)."""
    def np_(t):
        return t.detach().cpu().numpy().copy()

    return {"model": {
        "encoder": {"layers": [
            {"w_rel": np_(layer.w_rel), "w_root": np_(layer.w_root),
             "b": np_(layer.b)} for layer in model.encoder.layers]},
        "decoder": {"rel_emb": np_(model.decoder.rel_emb)},
    }}
