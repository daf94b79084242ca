"""Carry parameters between the JAX package's tree and the port's modules.

The JAX ``KGEModule`` keeps its parameters as a tree of arrays
(``params["model"]["encoder"]["layers"][i]`` with, for RGCN, ``w_rel``
(R, din, dout), ``w_root`` (din, dout), ``b`` (dout,); for RGAT ``w_rel``
(R, din, H·dout), ``att_src`` and ``att_dst`` (R, H, dout), ``b``; and
``params["model"]["decoder"]["rel_emb"]`` (R, d)). The JAX GCL modules
keep ``params["model"]["encoder"]["layers"][i]`` = {``w`` (din, dout),
``b``} of the GCN and, per model, ``fc1``/``fc2`` (GRACE), ``project``
(DGI) or the ``mlp`` list (GGD), each {``w`` (in, out), ``b``}. Native
checkpoints store the tree as numpy, and optax's Adam moments have the same
tree. The port keeps the same tensors, under the same names and layouts, so
the tree's dotted paths (``model.encoder.layers.0.w_rel``,
``model.mlp.0.w``) are exactly the port modules' parameter names and the
mapping is a checked copy.

A module with a modality fuser (``fuse_method`` attention or redaf) has a
second subtree, ``params["fusion"]``: ``q``, ``k``, ``v`` (attention) or
``modal_weights`` (M, 1, d), ``sub_type_emb.table``, ``transform`` and
``rel_context`` (ReDAF), each dense layer {``w`` (in, out), ``b``}; it maps
onto the training module's ``fusion`` submodule by the same rule.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{dotted path: array}`` of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}{key}."))
    return out


def unflatten_tree(named: Dict[str, Any]) -> Any:
    """The inverse of ``flatten_tree``: integer path parts become lists."""
    root: Dict = {}
    for path, value in named.items():
        node = root
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def tensors_from_tree(module: nn.Module, tree: Any,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """float32 CPU tensors of ``tree`` (the JAX layout), one per parameter
    of ``module``, by name, checked against the parameters' shapes."""
    flat = flatten_tree(tree)
    out = {}
    for name, p in module.named_parameters():
        key = prefix + name
        if key not in flat:
            raise ValueError(f"{key}: missing from the checkpoint tree")
        src = flat.pop(key)
        if tuple(src.shape) != tuple(p.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)} "
                             f"!= model shape {tuple(p.shape)}")
        out[name] = torch.from_numpy(np.array(src, dtype=np.float32))
    if flat:
        raise ValueError(f"checkpoint tree has unknown leaves {sorted(flat)}")
    return out


def load_jax_params(model: nn.Module, params: Dict,
                    fusion: Optional[nn.Module] = None) -> None:
    """Copy a JAX params tree (``params["model"]``'s parent) into the
    port's ``model`` (a KGE ``GAE``, or a GCL model) and its ``fusion``
    subtree into ``fusion`` (the module's fuser, None without one)."""
    want_keys = {"model"} | ({"fusion"} if fusion is not None else set())
    if set(params) != want_keys:
        raise ValueError(f"params subtrees {sorted(params)} do not match "
                         f"the module's {sorted(want_keys)} (a fusion "
                         "subtree needs the checkpoint's fuse_method)")
    layers = params["model"]["encoder"]["layers"]
    if len(layers) != len(model.encoder.layers):
        raise ValueError(f"checkpoint has {len(layers)} encoder layers, "
                         f"model {len(model.encoder.layers)}")
    want = {name for name, _ in model.encoder.layers[0].named_parameters()}
    for i, src in enumerate(layers):
        if set(src) != want:
            raise ValueError(f"encoder layer {i}: not an "
                             f"{type(model.encoder).__name__} layer "
                             f"({sorted(src)})")
    parts = [(model, params["model"])]
    if fusion is not None:
        parts.append((fusion, params["fusion"]))
    for module, tree in parts:
        tensors = tensors_from_tree(module, tree)
        with torch.no_grad():
            for name, p in module.named_parameters():
                p.copy_(tensors[name])


def to_jax_tree(named: Dict[str, torch.Tensor]) -> Any:
    """Tensors by dotted name as the JAX tree (numpy leaves)."""
    return unflatten_tree({name: t.detach().cpu().numpy().copy()
                           for name, t in named.items()})


def to_jax_params(model: nn.Module,
                  fusion: Optional[nn.Module] = None) -> Dict:
    """The port's ``model`` (and ``fusion``, the module's fuser, when it
    has one) as the JAX params tree (numpy leaves)."""
    named = {"model." + name: p for name, p in model.named_parameters()}
    if fusion is not None:
        named.update({"fusion." + name: p
                      for name, p in fusion.named_parameters()})
    return to_jax_tree(named)
