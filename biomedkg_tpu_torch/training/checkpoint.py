"""Checkpoints (counterpart of biomedkg_tpu/training/checkpoint.py): the
native file format, the background writer, and the top-k and early-stop
callbacks the Trainer drives.

A checkpoint is one pickle of ``{"kind", "hparams", "params", "opt_state",
"step", "extras"}`` whose array leaves are numpy, written to a temporary
file and renamed into place. Files are interchangeable with the JAX
package: ``params`` holds the reference's parameter tree
(interop/jax_params.py maps it onto the port's modules).

Loading uses an unpickler that lets numpy's arrays, scalars and dtypes
and plain containers through and turns every other class into an inert
stand-in that runs nothing: a JAX-written ``opt_state`` holds optax state
classes, and a plain ``pickle.load`` would load optax and, through it,
JAX. ``load_train_state`` reads Adam's count and moments from either
package's ``opt_state``: the port writes ``{"count", "mu", "nu"}`` with
the moments in the params tree's layout, so its files need no optax
classes, and the JAX package still loads their params.

A train state is copied to host memory by ``train_state_payload`` before
anything is written: the port's steps update the module's parameters and
Adam's moments in place, so a write that read them later (on
``AsyncSaver``'s thread) would hold a later step's weights.

A reference Lightning ``.ckpt`` (a torch zip archive) loads through
interop/torch_ckpt.py as the same payload. Not ported: the orbax
directory checkpoints (orbax imports JAX; ROADMAP.md queue 1, item 6),
which raise.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import threading
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..interop.jax_params import (load_jax_params, tensors_from_tree,
                                  to_jax_params, to_jax_tree)
from ..parallel.mesh import is_global_zero
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


class Inert(dict):
    """Stand-in for a pickled class the port does not load. A mapping, so
    that a dict subclass (Lightning's ``AttributeDict``) comes back with
    its items and another object's dict state lands in it too; the
    arguments of the constructor or call the file asked for are kept in
    ``args`` and its state in ``state``, not acted on."""

    def __new__(cls, *args, **kwargs):
        obj = super().__new__(cls)
        obj.args = args
        obj.state = None
        return obj

    def __init__(self, *args, **kwargs):
        super().__init__()

    def __setstate__(self, state):
        self.state = state
        for part in state if isinstance(state, tuple) else (state,):
            if isinstance(part, dict):
                self.update(part)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None


# what a pickle of numpy arrays, scalars and dtypes names, under numpy 1's
# numpy.core and numpy 2's numpy._core: nothing else of numpy loads (some
# of its functions evaluate strings)
_NUMPY_NAMES = frozenset(
    [(f"numpy.{core}.multiarray", name) for core in ("core", "_core")
     for name in ("_reconstruct", "scalar")]
    + [(f"numpy.{core}.numeric", "_frombuffer") for core in ("core", "_core")]
    + [("numpy", "ndarray"), ("numpy", "dtype")])


def _numpy_dtype_class(module: str, name: str) -> bool:
    """``numpy.dtypes.Float32DType`` and the other dtype classes."""
    cls = getattr(getattr(np, "dtypes", None), name, None)
    return (module == "numpy.dtypes" and isinstance(cls, type)
            and issubclass(cls, np.dtype))


class CheckpointUnpickler(pickle.Unpickler):
    def admitted(self, module: str, name: str) -> bool:
        """Whether to load ``module.name``: numpy arrays, scalars and
        dtypes, plain containers and the helpers their pickles name."""
        return ((module, name) in _NUMPY_NAMES
                or _numpy_dtype_class(module, name)
                or (module == "builtins" and name in _SAFE_BUILTINS)
                or (module, name) in {("collections", "OrderedDict"),
                                      ("copyreg", "_reconstructor"),
                                      ("_codecs", "encode")})

    def find_class(self, module, name):
        if self.admitted(module, name):
            return super().find_class(module, name)
        return type(name, (Inert,), {"__module__": module})


def load_checkpoint(path: str) -> Dict:
    """A native checkpoint, or a reference Lightning ``.ckpt`` (a torch
    zip archive) converted to the same payload."""
    if zipfile.is_zipfile(path):
        from ..interop.torch_ckpt import from_torch_checkpoint
        return from_torch_checkpoint(path)
    with open(path, "rb") as f:
        return CheckpointUnpickler(f).load()


def train_state_payload(module, state: TrainState) -> Dict:
    """``save_checkpoint``'s arguments for ``module``'s weights and
    ``state``'s optimizer state and step, copied to host memory now."""
    opt, names = state.opt_state, list(state.params)
    return dict(kind=module.kind, hparams=module.hparams,
                params=to_jax_params(module.model, module.fusion),
                opt_state={"count": np.int32(opt.count),
                           "mu": to_jax_tree(dict(zip(names, opt.mu))),
                           "nu": to_jax_tree(dict(zip(names, opt.nu)))},
                step=state.step)


def save_train_state(path: str, module, state: TrainState,
                     extras: Optional[Dict] = None) -> None:
    """A checkpoint of ``module``'s weights and ``state``'s optimizer
    state and step."""
    save_checkpoint(path, **train_state_payload(module, state),
                    extras=extras)


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


def train_state_from(ckpt: Dict, module) -> TrainState:
    """Resume from a loaded checkpoint (written by either package):
    ``module``'s weights, its Adam state and the step, on the module's
    device."""
    if ckpt["kind"] != module.kind:
        raise ValueError(f"a {ckpt['kind']!r} checkpoint, not "
                         f"{module.kind!r}")
    if ckpt["opt_state"] is None:
        raise ValueError("the checkpoint holds no optimizer state")
    load_jax_params(module.model, ckpt["params"], module.fusion)
    count, mu, nu = _adam_state(ckpt["opt_state"])
    params = dict(module.named_parameters())
    mu, nu = tensors_from_tree(module, mu), tensors_from_tree(module, nu)
    return TrainState(params, AdamState(
        count, [mu[n].to(p.device) for n, p in params.items()],
        [nu[n].to(p.device) for n, p in params.items()]), int(ckpt["step"]))


def load_train_state(path: str, module) -> TrainState:
    """``train_state_from`` the checkpoint file at ``path``."""
    return train_state_from(load_checkpoint(path), module)


def load_any(path: str) -> Dict:
    """A checkpoint file. A directory (the JAX package's orbax checkpoint,
    or one whose atomic swap was cut short) raises: orbax imports JAX."""
    if any(os.path.isdir(p) for p in (path, path + ".new", path + ".old")):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory; the orbax backend is "
            "not ported (ROADMAP.md queue 1, item 6)")
    return load_checkpoint(path)


class AsyncSaver:
    """One background checkpoint writer. ``submit`` takes a write whose
    data is already in host memory and waits for the previous write first
    (one write in flight, the latest wins). ``wait`` flushes and re-raises
    a failed write, so no caller takes a checkpoint that was never written
    for a durable one. Every write ends in an atomic rename, so a kill
    mid-write leaves the previous file."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def submit(self, fn):
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # surfaced on the next wait()
                self._exc = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


class ModelCheckpoint:
    """The best ``save_top_k`` checkpoints by ``monitor``, and
    ``last.ckpt`` after every validation when ``save_last``.
    ``save_top_k`` 0 keeps none (``last.ckpt`` still applies), -1 every
    one (Lightning's rules)."""

    def __init__(self, dirpath: str, monitor: str = "val_loss",
                 save_top_k: int = 3, mode: str = "min",
                 save_last: bool = False):
        self.dirpath = dirpath
        self.monitor = monitor
        self.save_top_k = save_top_k
        self.sign = 1.0 if mode == "min" else -1.0
        self.save_last = save_last
        self._kept: List[tuple] = []  # (signed value, path), best first
        os.makedirs(dirpath, exist_ok=True)

    @property
    def best_model_path(self) -> Optional[str]:
        if not self._kept:
            return None
        return min(self._kept)[1]

    def on_validation_end(self, trainer, metrics: Dict[str, float]):
        if self.monitor not in metrics:
            return
        value = float(metrics[self.monitor])
        epoch = trainer.current_epoch
        path = os.path.join(
            self.dirpath,
            f"epoch={epoch}-{self.monitor}={value:.4f}.ckpt")
        signed = self.sign * value
        should = self.save_top_k != 0 and (
            self.save_top_k == -1
            or len(self._kept) < self.save_top_k
            or signed < max(self._kept)[0])
        if should:
            trainer.save(path)
            self._kept.append((signed, path))
            self._kept.sort()
            while self.save_top_k >= 0 and \
                    len(self._kept) > self.save_top_k:
                _, drop = self._kept.pop()
                # rank 0 writes the files (Trainer.save), so it evicts them
                if is_global_zero() and os.path.exists(drop):
                    os.remove(drop)
        if self.save_last:
            trainer.save(os.path.join(self.dirpath, "last.ckpt"))

    # the Trainer writes these into a checkpoint's extras, so a resumed
    # run evicts where the interrupted one left off
    def state_dict(self) -> Dict:
        return {"kept": [[v, p] for v, p in self._kept]}

    def load_state_dict(self, state: Dict) -> None:
        self._kept = [(float(v), str(p)) for v, p in state.get("kept", [])]


class EarlyStopping:
    """Stop once ``monitor`` has not improved for ``patience``
    validations."""

    def __init__(self, monitor: str = "val_loss", mode: str = "min",
                 patience: int = 5):
        self.monitor = monitor
        self.sign = 1.0 if mode == "min" else -1.0
        self.patience = patience
        self.best = float("inf")
        self.bad_epochs = 0
        self.should_stop = False

    def on_validation_end(self, trainer, metrics: Dict[str, float]):
        if self.monitor not in metrics:
            return
        value = self.sign * float(metrics[self.monitor])
        if value < self.best:
            self.best = value
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.should_stop = True

    def state_dict(self) -> Dict:
        return {"best": self.best, "bad_epochs": self.bad_epochs,
                "should_stop": self.should_stop}

    def load_state_dict(self, state: Dict) -> None:
        self.best = float(state.get("best", float("inf")))
        self.bad_epochs = int(state.get("bad_epochs", 0))
        self.should_stop = bool(state.get("should_stop", False))
