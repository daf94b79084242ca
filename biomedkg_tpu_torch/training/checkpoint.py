"""Native checkpoint files (counterpart of
biomedkg_tpu/training/checkpoint.py::save_checkpoint / load_checkpoint).

A checkpoint is one pickle of ``{"kind", "hparams", "params", "opt_state",
"step", "extras"}`` whose array leaves are numpy, written to a temporary
file and renamed into place. Files are interchangeable with the JAX
package: ``params`` holds the reference's parameter tree
(interop/jax_params.py maps it onto the port's modules).

Loading uses an unpickler that lets numpy and plain containers through
and turns every other class into an inert stand-in: a JAX-written
``opt_state`` holds optax state classes, and a plain ``pickle.load`` would
load optax and, through it, JAX. ``load_train_state`` reads Adam's count
and moments from either package's ``opt_state``: the port writes
``{"count", "mu", "nu"}`` with the moments in the params tree's layout, so
its files need no optax classes, and the JAX package still loads their
params. The reference's Lightning-checkpoint import (interop/torch_ckpt.py)
is not ported yet.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..interop.jax_params import (load_jax_params, tensors_from_tree,
                                  to_jax_params, to_jax_tree)
from .optim import AdamState
from .stepping import TrainState

_SAFE_BUILTINS = frozenset({
    "dict", "list", "tuple", "set", "frozenset", "int", "float", "complex",
    "bool", "str", "bytes", "bytearray", "slice", "range", "object"})


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, kind: str, hparams: Dict, params: Any,
                    opt_state: Any = None, step: int = 0,
                    extras: Optional[Dict] = None) -> None:
    payload = {
        "kind": kind,
        "hparams": dict(hparams),
        "params": _to_numpy(params),
        "opt_state": _to_numpy(opt_state) if opt_state is not None else None,
        "step": int(step),
        "extras": extras or {},
    }
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, path)  # atomic: a kill mid-save keeps the old file
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


class Inert:
    """Stand-in for a pickled class the port does not import; keeps the
    constructor arguments and state it was given."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        obj.state = None
        return obj

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.state = state


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        root = module.split(".")[0]
        if (root == "numpy"
                or (module == "builtins" and name in _SAFE_BUILTINS)
                or (module, name) in {("collections", "OrderedDict"),
                                      ("copyreg", "_reconstructor"),
                                      ("_codecs", "encode")}):
            return super().find_class(module, name)
        return type(name, (Inert,), {"__module__": module})


def load_checkpoint(path: str) -> Dict:
    if zipfile.is_zipfile(path):
        raise NotImplementedError(
            f"{path} is a Lightning/torch zip checkpoint; its importer "
            "(interop/torch_ckpt.py) is not ported yet (ROADMAP.md queue 1)")
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def save_train_state(path: str, module, state: TrainState,
                     extras: Optional[Dict] = None) -> None:
    """A checkpoint of ``module``'s weights and ``state``'s optimizer
    state and step."""
    opt, names = state.opt_state, list(state.params)
    save_checkpoint(path, module.kind, module.hparams,
                    to_jax_params(module.model),
                    opt_state={"count": np.int32(opt.count),
                               "mu": to_jax_tree(dict(zip(names, opt.mu))),
                               "nu": to_jax_tree(dict(zip(names, opt.nu)))},
                    step=state.step, extras=extras)


def _adam_state(opt_state):
    """(count, mu tree, nu tree) from the port's ``opt_state`` or from the
    JAX package's optax chain (clip, Adam, schedule, scale), whose
    namedtuples arrive as inert stand-ins holding their fields."""
    if isinstance(opt_state, dict) and set(opt_state) == {"count", "mu",
                                                          "nu"}:
        return int(opt_state["count"]), opt_state["mu"], opt_state["nu"]
    if isinstance(opt_state, (tuple, list)):
        by_name = {type(s).__name__: s for s in opt_state
                   if isinstance(s, Inert)}
        adam = by_name.get("ScaleByAdamState")
        schedule = by_name.get("ScaleByScheduleState")
        if adam is not None and schedule is not None:
            count, mu, nu = adam.args
            if int(schedule.args[0]) != int(count):
                raise ValueError(f"optax state: Adam count {int(count)} != "
                                 f"schedule count {int(schedule.args[0])}")
            return int(count), mu, nu
    raise ValueError("checkpoint opt_state is neither the port's nor the "
                     "JAX package's Adam chain state")


def load_train_state(path: str, module) -> TrainState:
    """Resume: ``module``'s weights, its Adam state and the step from a
    checkpoint written by either package, on the module's device."""
    ckpt = load_checkpoint(path)
    if ckpt["kind"] != module.kind:
        raise ValueError(f"{path} is a {ckpt['kind']!r} checkpoint")
    if ckpt["opt_state"] is None:
        raise ValueError(f"{path} holds no optimizer state")
    load_jax_params(module.model, ckpt["params"])
    count, mu, nu = _adam_state(ckpt["opt_state"])
    params = dict(module.named_parameters())
    mu, nu = tensors_from_tree(module, mu), tensors_from_tree(module, nu)
    return TrainState(params, AdamState(
        count, [mu[n].to(p.device) for n, p in params.items()],
        [nu[n].to(p.device) for n, p in params.items()]), int(ckpt["step"]))
