"""The reference's Lightning checkpoints (counterpart of
biomedkg_tpu/interop/torch_ckpt.py).

A Lightning ``.ckpt`` is a torch zip-archive save of ``{"state_dict",
"hyper_parameters", "global_step", ...}`` in the reference's parameter
names. ``from_torch_checkpoint`` turns one into the port's native payload
``{"kind", "hparams", "params", "opt_state", "step", "extras"}``
(training/checkpoint.py), its ``params`` the JAX layout's numpy tree that
interop/jax_params.py loads, so every loader of a ``.ckpt`` takes the
reference's weights: ``load_kge_module``, ``load_gcl_module``,
``KGEScorer``, ``rank_eval``, ``test_kge``, ``train_dpi``'s warm start and
the GCL / KGE embedding caches.

Names on the torch side: the RGCN encoder's PyG ``RGCNConv`` ``weight``
(R, din, dout), ``root`` (din, dout) and ``bias`` under
``model.encoder.graph_layers.{i}``, the GCN's ``GCNConv`` ``lin.weight``
(dout, din, transposed here) and ``bias``; the decoders'
``model.decoder.rel_emb`` (and ComplEx's ``rel_emb_imag``); the fusers'
``modality_transform.*``; the GCL heads' ``model.project`` (DGI),
``model.fc1`` / ``fc2`` (GRACE) and ``model.mlp.{i}`` (GGD). Hyper-
parameters missing from the file are derived from the weights' shapes or
assumed, with a warning, and listed in ``extras["derived_hparams"]``.

The file is read by ``torch.load(weights_only=False)`` through a restricted
unpickler: torch's tensor-rebuild functions, storages, sizes and dtypes,
and what training/checkpoint.py's own unpickler admits (numpy's arrays,
scalars and dtypes, plain containers) load; every other class the file
names (Lightning's ``AttributeDict``, PyGCL objects, anything else)
becomes training/checkpoint.py's ``Inert``, which keeps its arguments
and state. No code the file names runs, and neither Lightning nor PyG
need be installed.
"""

from __future__ import annotations

import types
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..training.checkpoint import CheckpointUnpickler

__all__ = ["from_torch_checkpoint"]

# what a torch save of tensors and parameters names (the storages are
# resolved by torch.load's own wrapper before the unpickler is asked)
_TORCH_REBUILDS = frozenset({
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_tensor_v3"),
    ("torch._utils", "_rebuild_parameter"), ("torch", "Size")})


class _RestrictedUnpickler(CheckpointUnpickler):
    """The native checkpoints' unpickler, admitting torch's tensor
    rebuilds and dtypes too."""

    def admitted(self, module: str, name: str) -> bool:
        if (module, name) in _TORCH_REBUILDS or super().admitted(module,
                                                                 name):
            return True
        # torch.float32 and the other dtypes
        return module == "torch" and isinstance(getattr(torch, name, None),
                                                torch.dtype)


def _load_torch_file(path: str) -> Dict:
    shim = types.ModuleType("biomedkg_tpu_torch_pickle_shim")
    shim.Unpickler = _RestrictedUnpickler
    shim.load = lambda f, **kw: _RestrictedUnpickler(f, **kw).load()
    return torch.load(path, map_location="cpu", pickle_module=shim,
                      weights_only=False)


def _np(t) -> np.ndarray:
    arr = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
    return np.ascontiguousarray(arr.astype(np.float32, copy=False))


def _group_layers(sd: Dict[str, Any], prefix: str) -> list:
    """``{prefix}.{i}.*`` as a list of dicts in index order."""
    layers: Dict[int, Dict[str, Any]] = {}
    for key, val in sd.items():
        if not key.startswith(prefix + "."):
            continue
        idx, _, leaf = key[len(prefix) + 1:].partition(".")
        layers.setdefault(int(idx), {})[leaf] = val
    if not layers:
        raise KeyError(f"no '{prefix}.*' keys in state_dict")
    missing = [i for i in range(max(layers) + 1) if i not in layers]
    if missing:
        raise KeyError(f"missing layer indices {missing} under '{prefix}'")
    return [layers[i] for i in range(len(layers))]


def _convert_encoder(sd: Dict[str, Any], prefix: str) -> Dict:
    """An RGCN or GCN stack → ``{"layers": [...]}``."""
    out = []
    for i, lp in enumerate(_group_layers(sd, prefix)):
        if "comp" in lp:
            raise NotImplementedError(
                "RGCNConv num_bases/num_blocks decomposition is not used by "
                "the reference configs and is not supported by the importer")
        if "weight" in lp and "root" in lp:          # RGCNConv
            out.append({"w_rel": _np(lp["weight"]), "w_root": _np(lp["root"]),
                        "b": _np(lp.get("bias", np.zeros(
                            lp["root"].shape[-1])))})
        elif "lin.weight" in lp:                      # GCNConv
            out.append({"w": _np(lp["lin.weight"]).T,
                        "b": _np(lp.get("bias", np.zeros(
                            lp["lin.weight"].shape[0])))})
        elif any(k.startswith(("att", "lin_")) for k in lp):
            raise NotImplementedError(
                "RGAT checkpoint import is not supported: the reference's "
                "RGAT never trained, so no such checkpoint can exist")
        else:
            raise KeyError(f"unrecognized conv params at layer {i}: "
                           f"{sorted(lp)}")
    return {"layers": out}


def _convert_linear(sd: Dict[str, Any], prefix: str) -> Dict:
    p = {"w": _np(sd[prefix + ".weight"]).T}
    if prefix + ".bias" in sd:
        p["b"] = _np(sd[prefix + ".bias"])
    return p


def _convert_decoder(sd: Dict[str, Any], out_dim: int, notes: Dict) -> Dict:
    rel = _np(sd["model.decoder.rel_emb"])
    if "model.decoder.rel_emb_imag" not in sd:
        return {"rel_emb": rel}
    # ComplEx: the half-width packed [real (d/2) | imag (d/2)] table
    imag = _np(sd["model.decoder.rel_emb_imag"])
    if 2 * rel.shape[1] == out_dim:
        return {"rel_emb": np.concatenate([rel, imag], axis=1)}
    # full-width tables (the reference as shipped, whose forward cannot
    # run): the first half of each, the scores of its minimal repair
    half = rel.shape[1] // 2
    msg = (f"ComplEx repack: checkpoint stores FULL-width rel tables "
           f"({rel.shape[1]} vs encoder out_dim {out_dim}); keeping the "
           f"first {half} columns of rel_emb/rel_emb_imag (minimal-fix "
           f"semantics) and DROPPING the second halves")
    warnings.warn(msg, UserWarning, stacklevel=3)
    notes["complex_repack"] = msg
    return {"rel_emb": np.concatenate([rel[:, :half], imag[:, :half]],
                                      axis=1)}


def _convert_fusion(sd: Dict[str, Any]) -> Tuple[str, Dict]:
    """(fuse_method, the fuser's params), or ("none", {})."""
    if "modality_transform.q_proj.weight" in sd:
        return "attention", {
            name: _convert_linear(sd, f"modality_transform.{name}_proj")
            for name in ("q", "k", "v")}
    if "modality_transform.modal_weights" in sd:
        return "redaf", {
            "modal_weights": _np(sd["modality_transform.modal_weights"]),
            "sub_type_emb": {"table": _np(
                sd["modality_transform.sub_type_embeddings.weight"])},
            "transform": _convert_linear(
                sd, "modality_transform.transform_layer"),
            "rel_context": _convert_linear(
                sd, "modality_transform.relational_context_layer"),
        }
    return "none", {}


_KGE_HPARAM_KEYS = (
    "encoder_name", "decoder_name", "in_dim", "hidden_dim", "out_dim",
    "num_hidden_layers", "num_relation", "num_heads", "scheduler_type",
    "learning_rate", "warm_up_ratio", "fuse_method", "neg_ratio",
    "node_init_method")
_GCL_HPARAM_KEYS = (
    "in_dim", "hidden_dim", "out_dim", "num_hidden_layers",
    "scheduler_type", "learning_rate", "warm_up_ratio", "fuse_method")
_SHAPE_INFERRED = frozenset({
    "encoder_name", "decoder_name", "in_dim", "hidden_dim", "out_dim",
    "num_hidden_layers", "num_relation", "fuse_method"})


def _fill_hparams(hp: Dict, keys, derived: Dict) -> Tuple[Dict, Dict]:
    """The checkpoint's hyper-parameters, ``derived`` for each key it
    lacks; every derived one is returned apart and warned about."""
    hparams, used = {}, {}
    for k in keys:
        if k in hp:
            hparams[k] = hp[k]
        else:
            hparams[k] = used[k] = derived[k]
    if used:
        inferred = sorted(set(used) & _SHAPE_INFERRED)
        assumed = sorted(set(used) - _SHAPE_INFERRED)
        parts = []
        if inferred:
            parts.append("inferred from weight shapes: " + ", ".join(
                f"{k}={used[k]!r}" for k in inferred))
        if assumed:
            parts.append("ASSUMED defaults (not in the checkpoint — "
                         "verify before training/eval depends on them): "
                         + ", ".join(f"{k}={used[k]!r}" for k in assumed))
        warnings.warn("torch checkpoint 'hyper_parameters' is missing "
                      f"{len(used)} field(s); " + "; ".join(parts),
                      UserWarning, stacklevel=3)
    return hparams, used


def _plain(v):
    """Inert and container hyper-parameter leaves as plain values."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    return v


def _detect_kind(sd: Dict[str, Any]) -> Tuple[str, str]:
    """(kind, model_name) of a reference module's state_dict."""
    if "model.decoder.rel_emb" in sd:
        return "kge", "kge"
    if "model.project.weight" in sd:
        return "gcl", "dgi"
    if "model.fc1.weight" in sd:
        return "gcl", "grace"
    if "model.mlp.0.weight" in sd:
        return "gcl", "ggd"
    raise ValueError(
        "unrecognized Lightning checkpoint: expected a reference KGEModule "
        "(model.decoder.rel_emb) or DGI/GRACE/GGD module state_dict, got "
        f"keys like {sorted(sd)[:6]}")


def _kge(sd: Dict, hp: Dict, params: Dict, fuse_method: str, notes: Dict):
    enc0 = params["model"]["encoder"]["layers"][0]
    wkey = "w_rel" if "w_rel" in enc0 else "w"
    out_dim = int(params["model"]["encoder"]["layers"][-1][wkey].shape[-1])
    params["model"]["decoder"] = _convert_decoder(sd, out_dim, notes)
    rel_emb = params["model"]["decoder"]["rel_emb"]
    derived = dict(
        encoder_name="rgcn" if "w_rel" in enc0 else "gcn",
        decoder_name=hp.get("decoder_name", "dismult"),
        in_dim=enc0[wkey].shape[-2], hidden_dim=enc0[wkey].shape[-1],
        out_dim=out_dim,
        num_hidden_layers=len(params["model"]["encoder"]["layers"]) - 2,
        num_relation=(enc0["w_rel"].shape[0] if "w_rel" in enc0
                      else rel_emb.shape[0]),
        num_heads=1, scheduler_type="cosine", learning_rate=1e-3,
        warm_up_ratio=0.03, fuse_method=fuse_method, neg_ratio=1,
        node_init_method="random")
    hparams, used = _fill_hparams(hp, _KGE_HPARAM_KEYS, derived)
    if fuse_method != "none":
        hparams["fuse_method"] = fuse_method
        hparams["node_init_method"] = "lm"
    return hparams, used, {}


def _gcl(sd: Dict, hp: Dict, params: Dict, fuse_method: str,
         model_name: str):
    if model_name == "dgi":
        params["model"]["project"] = _convert_linear(sd, "model.project")
    elif model_name == "grace":
        params["model"]["fc1"] = _convert_linear(sd, "model.fc1")
        params["model"]["fc2"] = _convert_linear(sd, "model.fc2")
    else:
        params["model"]["mlp"] = [
            _convert_linear(sd, f"model.mlp.{i}")
            for i in range(len(_group_layers(sd, "model.mlp")))]
    layers = params["model"]["encoder"]["layers"]
    if "w" not in layers[0]:
        raise NotImplementedError(
            "reference GCL modules always wrap GCNEncoder "
            "(gcl_module.py DGIModule/GRACEModule/GGDModule)")
    derived = dict(
        in_dim=layers[0]["w"].shape[0], hidden_dim=layers[0]["w"].shape[-1],
        out_dim=layers[-1]["w"].shape[-1],
        num_hidden_layers=len(layers) - 2, scheduler_type="cosine",
        learning_rate=2e-4, warm_up_ratio=0.03, fuse_method=fuse_method)
    hparams, used = _fill_hparams(hp, _GCL_HPARAM_KEYS, derived)
    if fuse_method != "none":
        hparams["fuse_method"] = fuse_method
    return hparams, used, {"model_name": model_name}


def from_torch_checkpoint(path: str) -> Dict:
    """The reference Lightning ``.ckpt`` at ``path`` as a native
    checkpoint payload."""
    raw = _load_torch_file(path)
    if "state_dict" not in raw:
        raise ValueError(f"{path}: no 'state_dict' — not a Lightning ckpt")
    sd = dict(raw["state_dict"])
    hp = {k: _plain(v) for k, v in dict(raw.get("hyper_parameters",
                                                {})).items()}
    kind, model_name = _detect_kind(sd)
    params: Dict[str, Any] = {"model": {"encoder": _convert_encoder(
        sd, "model.encoder.graph_layers")}}
    fuse_method, fusion = _convert_fusion(sd)
    if fusion:
        params["fusion"] = fusion
    notes: Dict[str, Any] = {}
    if kind == "kge":
        hparams, used, extras = _kge(sd, hp, params, fuse_method, notes)
    else:
        hparams, used, extras = _gcl(sd, hp, params, fuse_method, model_name)
    if hparams.get("fuse_method") is None:
        hparams["fuse_method"] = "none"
    if used:
        extras["derived_hparams"] = used
    extras.update(notes)
    return {"kind": kind, "hparams": hparams, "params": params,
            "opt_state": None, "step": int(raw.get("global_step", 0) or 0),
            "extras": extras}
