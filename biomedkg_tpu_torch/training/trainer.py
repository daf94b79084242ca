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

``devices`` is Lightning's argument with the JAX Trainer's rules: ids (a
list or "0,1") are clamped to the devices present, a count above them
warns and clamps, -1 or "auto" takes them all. The devices present are the
ranks of an initialised ``torch.distributed`` group (one process a card:
parallel/launch.py, or torchrun), else the cards (1 on the CPU). More than
one runs data parallelism in that group (the module's ``train_step`` over
the dp group, as parallel/dp.py's ``make_dp_train_step``): one optimizer
step takes dp batches, rank r the batch at position j·dp + r of each
group of dp·K (the tail dropped), the gradients averaged by one
all-reduce; each rank draws from its own key (seed, 1, step, rank). A
resume skips dp batches a recorded step. Only rank 0 writes checkpoints,
logs and the progress lines; every rank keeps ``history`` (the losses are
the dp means) and evaluates alike. The Trainer starts no process: asked
for more devices than the group has ranks, it raises and says how to
start them.

Refused (``NotImplementedError``): orbax checkpoints (ROADMAP.md queue 1,
item 6).
"""

from __future__ import annotations

import itertools
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..interop.jax_params import load_jax_params
from ..parallel.mesh import (LAUNCH_HINT, is_global_zero, make_mesh,
                             resolve_devices, world_size)
from ..sampling.loaders import prefetch_to_device
from ..utils import profiling
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

        if not is_global_zero():
            return              # rank 0 writes the run's files
        if self._in_fit:
            self._saver.submit(write)
        else:
            self._saver.wait()  # the latest write wins
            write()

    def flush_checkpoints(self):
        """Wait for the write in flight; re-raises its failure. In a group,
        every rank waits until rank 0's file is down."""
        self._saver.wait()
        if world_size() > 1:
            dist.barrier()

    @property
    def best_model_path(self) -> Optional[str]:
        for cb in self.callbacks:
            if isinstance(cb, ModelCheckpoint) and cb.best_model_path:
                return cb.best_model_path
        return None

    # -- devices -----------------------------------------------------------

    def _resolve_dp(self, device: torch.device) -> int:
        """The data-parallel width ``devices`` asks for, clamped to the
        devices present: the initialised group's ranks, else the cards
        (1 on the CPU)."""
        present = (world_size() if dist.is_initialized()
                   else torch.cuda.device_count() if device.type == "cuda"
                   else 1)
        return resolve_devices(self.devices, present)

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
        dp = self._resolve_dp(device)
        if world_size() != dp and (dp > 1 or world_size() > 1):
            raise RuntimeError(
                f"devices={self.devices!r} trains on {dp} devices in a "
                f"group of {world_size()} ranks: {LAUNCH_HINT}")
        epochs = 1 if self.fast_dev_run else self.max_epochs
        k = 1 if self.fast_dev_run else self.steps_per_execution
        if self.fast_dev_run:
            steps_per_epoch = 1
        elif dp > 1:
            n = len(train_dataloaders)
            if n < dp * k:
                raise ValueError(
                    f"devices={dp} x steps_per_execution={k} needs at least "
                    f"{dp * k} batches an epoch, the loader has {n}: every "
                    "epoch would train no step")
            steps_per_epoch = (n // (dp * k)) * k
        else:
            steps_per_epoch = len(train_dataloaders)
        model.configure_optimizers(steps_per_epoch * epochs,
                                   grad_clip=self.gradient_clip_val)
        group = make_mesh(dp=dp, tp=1).dp_group if dp > 1 else None
        rank = dist.get_rank() if dp > 1 else None
        zero = is_global_zero()
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
            skip = skip_steps if epoch == start_epoch else 0
            for batches, edges in prefetch_to_device(
                    self._stream(train_dataloaders, k, skip * dp, dp,
                                 first_step=self.global_step),
                    device):
                for batch in batches:
                    key = (seed, TRAIN, self.global_step) + (
                        () if rank is None else (rank,))
                    with profiling.span("trainer.step",
                                        step=self.global_step,
                                        counters=(profiling.LAUNCHES,)):
                        self.state, logs = model.train_step(
                            self.state, batch, seeded(generator, *key),
                            group=group)
                    last_loss = logs["train_loss"]
                    self.global_step += 1
                steps = len(batches)
                n_batches += steps * dp
                n_edges += edges
                if self.enable_checkpointing and \
                        self.checkpoint_every_n_steps and \
                        self.default_root_dir and \
                        self.global_step % self.checkpoint_every_n_steps \
                        < steps:
                    self.save(os.path.join(self.default_root_dir,
                                           "step_last.ckpt"))
                if self.logger and zero and \
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
            if self.enable_progress_bar and zero:
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
                if self.enable_progress_bar and zero:
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
            if self.logger and zero:
                self.logger.log(epoch_logs, self.global_step)
            self.history.append(epoch_logs)

            if any(getattr(cb, "should_stop", False)
                   for cb in self.callbacks):
                if self.enable_progress_bar and zero:
                    print(f"[early stop] epoch {epoch}", flush=True)
                break
        self.flush_checkpoints()
        return self.state

    @staticmethod
    def _stream(loader, k: int, skip: int = 0, dp: int = 1,
                first_step: Optional[int] = None):
        """(K host batches, the real edges of their group) items of
        ``loader``, after skipping ``skip`` batches (a resume's offset:
        sampled, never copied). With ``dp`` > 1 each group is dp·K
        batches, of which this rank takes positions j·dp + rank, and a
        shorter tail is dropped; otherwise the last item is shorter. Runs
        on the prefetch thread, each batch in a ``prefetch.sample`` span
        whose step id is the step it trains (from ``first_step``, the
        step of the first batch after the skip)."""
        it = iter(loader)
        if skip:
            next(itertools.islice(it, skip - 1, skip), None)
        rank = dist.get_rank() if dp > 1 else 0
        taken, ended = 0, False
        while not ended:
            group = []
            while len(group) < k * dp:
                step = None if first_step is None else \
                    first_step + taken // dp
                with profiling.span("prefetch.sample", step=step,
                                    counters=("rows", "edges")) as sp:
                    b = next(it, None)
                    if b is None:     # the loader's end trains no step
                        if sp is not profiling.NO_SPAN:
                            sp.step = None
                    elif profiling.ON:
                        profiling.count("rows",
                                        int(np.count_nonzero(b.node_mask)))
                        profiling.count("edges",
                                        int(np.count_nonzero(b.edge_mask)))
                if b is None:
                    ended = True
                    break
                group.append(b)
                taken += 1
            if not group or (dp > 1 and len(group) < k * dp):
                return
            yield (group[rank::dp],
                   sum(int(np.sum(b.edge_mask)) for b in group))

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
        zero = is_global_zero()
        if self.enable_progress_bar and zero:
            print("test metrics:")
            for k, v in sorted(metrics.items()):
                print(f"  {k}: {v:.6f}")
        if self.logger and zero:
            self.logger.log(metrics, self.global_step)
        return metrics
