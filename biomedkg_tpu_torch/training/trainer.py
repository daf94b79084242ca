"""The training loop (counterpart of biomedkg_tpu/training/trainer.py):
the part of Lightning's Trainer the reference's entry points use.

``fit`` trains ``max_epochs`` epochs, validating every
``check_val_every_n_epoch`` and calling the callbacks
(``ModelCheckpoint``, ``EarlyStopping``) after each validation; ``validate``
and ``test(ckpt_path="best")`` run held-out epochs; ``fast_dev_run`` takes
one train and one val batch; ``save`` writes a resumable checkpoint with
the callbacks' states, and ``fit(resume_from=...)`` continues from one at
its epoch and offset; ``init_params`` warm-starts from a params tree.
``history`` holds each epoch's train loss, batches and real edges per
second (edges counted on the host batches) and validation metrics.

Every loop runs on ``sampling/loaders.py::prefetch_to_device``: a thread
samples the next items (``steps_per_execution`` batches each) and copies
them to the device while the steps run. A group's K steps run in a Python
loop (a capture into one launch is ROADMAP.md queue 1, item 3).

Draws: each stream has its own ``torch.Generator`` on the module's device,
seeded from ``np.random.SeedSequence`` of a key, as the JAX Trainer keys
its streams: the weights' init by (seed, 0), each training step by (seed,
1, global step), each validation epoch by (seed, 2, epoch), ``validate``
by (seed + 1,) and ``test`` by (seed + 2,). The loaders are epoch-keyed
(``set_epoch``), so a resumed run draws what the uninterrupted one drew.
The JAX Trainer keys a group of K steps by its first step; here each step
is keyed by its own, so the draws do not depend on K or on where a resume
starts.

Refused (``NotImplementedError``): more than one device
(``devices``; ROADMAP.md queue 1, item 12) and orbax checkpoints (item 6).
"""

from __future__ import annotations

import itertools
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..interop.jax_params import load_jax_params
from ..sampling.loaders import prefetch_to_device
from .checkpoint import (AsyncSaver, ModelCheckpoint, load_any,
                         save_checkpoint, train_state_from,
                         train_state_payload)
from .logger import MetricsLogger

INIT, TRAIN, VAL = 0, 1, 2


def seeded(generator: torch.Generator, *key: int) -> torch.Generator:
    """``generator`` reseeded from ``np.random.SeedSequence(key)``."""
    state = np.random.SeedSequence(key).generate_state(2, np.uint32)
    return generator.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)


class Trainer:
    def __init__(self, max_epochs: int = 1,
                 check_val_every_n_epoch: int = 1,
                 gradient_clip_val: float = 1.0,
                 callbacks: Optional[List] = None,
                 logger: Optional[MetricsLogger] = None,
                 fast_dev_run: bool = False,
                 log_every_n_steps: int = 10,
                 enable_checkpointing: bool = True,
                 devices=None,
                 default_root_dir: Optional[str] = None,
                 enable_progress_bar: bool = True,
                 steps_per_execution: int = 1,
                 checkpoint_every_n_steps: Optional[int] = None,
                 checkpoint_backend: str = "pickle"):
        if checkpoint_backend == "orbax":
            raise NotImplementedError(
                "checkpoint_backend='orbax' is not ported: orbax imports JAX "
                "(ROADMAP.md queue 1, item 6)")
        if checkpoint_backend != "pickle":
            raise ValueError(f"unknown checkpoint_backend "
                             f"{checkpoint_backend!r}")
        self.max_epochs = max_epochs
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.gradient_clip_val = gradient_clip_val
        self.callbacks = callbacks or []
        self.logger = logger
        self.fast_dev_run = fast_dev_run
        self.log_every_n_steps = log_every_n_steps
        self.enable_checkpointing = enable_checkpointing and not fast_dev_run
        self.enable_progress_bar = enable_progress_bar
        self.steps_per_execution = max(1, steps_per_execution)
        self.checkpoint_every_n_steps = checkpoint_every_n_steps
        if checkpoint_every_n_steps and not default_root_dir:
            warnings.warn(
                "checkpoint_every_n_steps is set but default_root_dir is "
                "not: no periodic checkpoint will be written", stacklevel=2)
        self.default_root_dir = default_root_dir
        self.devices = devices
        self._saver = AsyncSaver()
        self._in_fit = False
        self.current_epoch = 0
        self.global_step = 0
        self.module = None
        self.state = None
        self.tested_ckpt_path: Optional[str] = None
        self.history: List[Dict[str, float]] = []

    # -- checkpoints -----------------------------------------------------

    def save(self, path: str):
        """Write a resumable checkpoint: the weights, Adam's state, the
        step and the callbacks' states. The copy to host memory happens
        here, before the next step changes the parameters in place; during
        ``fit`` the file is written on the saver's thread, and a direct
        call is durable when it returns."""
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is a directory: orbax checkpoints are not ported "
                "(ROADMAP.md queue 1, item 6)")
        extras = {"model_name": getattr(self.module, "model_name", None),
                  "callback_states": [
                      cb.state_dict() if hasattr(cb, "state_dict")
                      else None for cb in self.callbacks]}
        payload = train_state_payload(self.module, self.state)

        def write():
            save_checkpoint(path, **payload, extras=extras)

        if self._in_fit:
            self._saver.submit(write)
        else:
            self._saver.wait()  # the latest write wins
            write()

    def flush_checkpoints(self):
        """Wait for the write in flight; re-raises its failure."""
        self._saver.wait()

    @property
    def best_model_path(self) -> Optional[str]:
        for cb in self.callbacks:
            if isinstance(cb, ModelCheckpoint) and cb.best_model_path:
                return cb.best_model_path
        return None

    # -- devices -----------------------------------------------------------

    def _check_devices(self, device: torch.device):
        """The Lightning ``devices`` argument: ids (a list or "0,1") are
        clamped to the devices present, as the JAX Trainer does, so the
        configs' ``0,1`` runs on one card; a count, -1 or "auto" asks for
        that many (all). More than one is data parallelism, not ported."""
        present = torch.cuda.device_count() if device.type == "cuda" else 1
        d = self.devices
        if d is None:
            return
        if isinstance(d, str) and "," in d:
            d = [int(x) for x in d.split(",") if x.strip()]
        if isinstance(d, (list, tuple)):
            ids = [int(i) for i in d if 0 <= int(i) < present]
            if len(ids) < len(d):
                warnings.warn(f"devices={self.devices!r}: only {present} "
                              f"present, using {ids or [0]}", stacklevel=3)
            want = max(len(ids), 1)
        else:
            want = present if d in ("auto", -1, "-1") else int(d)
        if want > 1:
            raise NotImplementedError(
                f"devices={self.devices!r} asks for {want} devices; data "
                "parallel training is not ported (ROADMAP.md queue 1, "
                "item 12)")

    # -- loops -------------------------------------------------------------

    def fit(self, model, train_dataloaders, val_dataloaders=None,
            init_params=None, resume_from: Optional[str] = None):
        try:
            self._in_fit = True
            return self._fit(model, train_dataloaders, val_dataloaders,
                             init_params, resume_from)
        finally:
            self._in_fit = False

    def _fit(self, model, train_dataloaders, val_dataloaders, init_params,
             resume_from):
        self.module = model
        device = model.device
        if not self.fast_dev_run:
            self._check_devices(device)
        epochs = 1 if self.fast_dev_run else self.max_epochs
        steps_per_epoch = 1 if self.fast_dev_run else len(train_dataloaders)
        model.configure_optimizers(steps_per_epoch * epochs,
                                   grad_clip=self.gradient_clip_val)
        seed = getattr(model, "seed", 42)
        start_epoch, skip_steps = 0, 0
        if resume_from is not None:
            ckpt = load_any(resume_from)
            self.state = train_state_from(ckpt, model)
            start_epoch = self.state.step // max(steps_per_epoch, 1)
            skip_steps = self.state.step - start_epoch * steps_per_epoch
            self.global_step = self.state.step
            states = (ckpt.get("extras") or {}).get("callback_states") or []
            for cb, st in zip(self.callbacks, states):
                if st is not None and hasattr(cb, "load_state_dict"):
                    cb.load_state_dict(st)
        elif init_params is not None:
            load_jax_params(model.model, init_params, model.fusion)
            self.state = model.init_state()
        else:
            self.state = model.init_state(seeded(torch.Generator(), seed,
                                                 INIT))
        generator = torch.Generator(device=device)

        for epoch in range(start_epoch, epochs):
            self.current_epoch = epoch
            if hasattr(train_dataloaders, "set_epoch"):
                train_dataloaders.set_epoch(epoch)
            t0 = time.perf_counter()
            n_batches = n_edges = 0
            last_loss = torch.zeros(())
            k = 1 if self.fast_dev_run else self.steps_per_execution
            skip = skip_steps if epoch == start_epoch else 0
            for batches, edges in prefetch_to_device(
                    self._stream(train_dataloaders, k, skip), device):
                for batch in batches:
                    self.state, logs = model.train_step(
                        self.state, batch,
                        seeded(generator, seed, TRAIN, self.global_step))
                    self.global_step += 1
                last_loss = logs["train_loss"]
                steps = len(batches)
                n_batches += steps
                n_edges += edges
                if self.enable_checkpointing and \
                        self.checkpoint_every_n_steps and \
                        self.default_root_dir and \
                        self.global_step % self.checkpoint_every_n_steps \
                        < steps:
                    self.save(os.path.join(self.default_root_dir,
                                           "step_last.ckpt"))
                if self.logger and \
                        self.global_step % self.log_every_n_steps < steps:
                    self.logger.log({"train_loss": float(last_loss)},
                                    self.global_step)
                if self.fast_dev_run:
                    break
            last_loss = float(last_loss)  # the epoch's one wait for the card
            dt = max(time.perf_counter() - t0, 1e-9)
            epoch_logs = {
                "epoch": epoch,
                "train_loss_epoch": last_loss,
                "batches_per_sec": n_batches / dt,
                "edges_per_sec": n_edges / dt,
            }
            if self.enable_progress_bar:
                print(f"[epoch {epoch}] train_loss={last_loss:.4f} "
                      f"({n_batches / dt:.2f} batch/s, "
                      f"{n_edges / dt:,.0f} edges/s)", flush=True)

            if val_dataloaders is not None and (
                    self.fast_dev_run
                    or (epoch + 1) % self.check_val_every_n_epoch == 0):
                if hasattr(val_dataloaders, "set_epoch"):
                    val_dataloaders.set_epoch(epoch)
                val_metrics = self._eval_loop(model, val_dataloaders, "val",
                                              (seed, VAL, epoch))
                epoch_logs.update(val_metrics)
                if self.enable_progress_bar:
                    print(f"[epoch {epoch}] val_loss="
                          f"{val_metrics.get('val_loss', float('nan')):.4f}",
                          flush=True)
                for cb in self.callbacks:
                    # only checkpoint callbacks follow enable_checkpointing
                    if isinstance(cb, ModelCheckpoint) \
                            and not self.enable_checkpointing:
                        continue
                    if hasattr(cb, "on_validation_end"):
                        cb.on_validation_end(self, val_metrics)
            if self.logger:
                self.logger.log(epoch_logs, self.global_step)
            self.history.append(epoch_logs)

            if any(getattr(cb, "should_stop", False)
                   for cb in self.callbacks):
                if self.enable_progress_bar:
                    print(f"[early stop] epoch {epoch}", flush=True)
                break
        self.flush_checkpoints()
        return self.state

    @staticmethod
    def _stream(loader, k: int, skip: int = 0):
        """(K host batches, their real edges) items of ``loader``, the
        last one shorter, after skipping ``skip`` batches (a resume's
        offset: sampled, never copied). Runs on the prefetch thread."""
        it = iter(loader)
        if skip:
            next(itertools.islice(it, skip - 1, skip), None)
        while True:
            batches = list(itertools.islice(it, k))
            if not batches:
                return
            yield batches, sum(int(np.sum(b.edge_mask)) for b in batches)

    def _eval_loop(self, model, dataloader, split: str, key) -> Dict:
        k = 1 if self.fast_dev_run else self.steps_per_execution
        generator = seeded(torch.Generator(device=model.device), *key)
        outputs = []
        for batches, _ in prefetch_to_device(self._stream(dataloader, k),
                                             model.device):
            outputs.extend(model.eval_steps(batches, generator))
            if self.fast_dev_run:
                break
        return model.eval_epoch(outputs, split)

    def validate(self, model, dataloaders, params=None) -> Dict:
        """A validation epoch with the module's weights, or ``params`` (a
        params tree) loaded into it first."""
        if params is not None:
            load_jax_params(model.model, params, model.fusion)
        return self._eval_loop(model, dataloaders, "val",
                               (getattr(model, "seed", 42) + 1,))

    def test(self, model, dataloaders, ckpt_path: Optional[str] = None,
             params=None) -> Dict:
        """A test epoch. ``ckpt_path="best"`` loads the best kept
        checkpoint into the module (waiting for its write first), another
        path that file; None keeps the module's weights (or loads
        ``params``). ``tested_ckpt_path`` names the file used."""
        self.module = model
        if ckpt_path == "best":
            self.flush_checkpoints()
            ckpt_path = self.best_model_path
        if ckpt_path:
            load_jax_params(model.model, load_any(ckpt_path)["params"],
                            model.fusion)
        elif params is not None:
            load_jax_params(model.model, params, model.fusion)
        self.tested_ckpt_path = ckpt_path
        metrics = self._eval_loop(model, dataloaders, "test",
                                  (getattr(model, "seed", 42) + 2,))
        if self.enable_progress_bar:
            print("test metrics:")
            for k, v in sorted(metrics.items()):
                print(f"  {k}: {v:.6f}")
        if self.logger:
            self.logger.log(metrics, self.global_step)
        return metrics
