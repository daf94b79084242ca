"""Profiling and tracing hooks (counterpart of
biomedkg_tpu/utils/profiling.py).

* ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
  where present, CUDA activity) that writes a Chrome trace
  (``trace.json``, for chrome://tracing or Perfetto) under ``logdir``.
* ``StepTimer``: wall-clock and throughput accounting; ``stop(result)``
  synchronises the device that holds ``result`` first, so a step's time
  covers its device work.
* ``debug_nans(enable)``: autograd anomaly detection, the nearest torch
  counterpart of ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; its Chrome trace goes to
    ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def debug_nans(enable: bool = True):
    """Turn autograd's anomaly detection on or off.

    Unlike ``jax_debug_nans``, which re-runs a jitted function op by op
    and raises at the first primitive whose output holds a NaN (forward
    or backward), this raises only when a backward function returns a NaN
    (naming the forward op that made it, with its traceback); a NaN that
    forward code computes and no gradient touches passes unseen. It slows
    every autograd op while on."""
    torch.autograd.set_detect_anomaly(enable)


def _synchronize(result) -> None:
    """Wait for the CUDA device of every tensor in ``result`` (a tensor,
    or a dict / list / tuple of them)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for value in result.values():
            _synchronize(value)
    elif isinstance(result, (list, tuple)):
        for value in result:
            _synchronize(value)


class StepTimer:
    """Accumulates step wall time and item counts; reports rates."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0: Optional[float] = None
        self.steps = 0
        self.items = 0
        self.elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None, items: int = 0):
        """End a step begun by ``start``, once ``result``'s device work is
        done."""
        if result is not None:
            _synchronize(result)
        self.elapsed += time.perf_counter() - self._t0
        self.steps += 1
        self.items += items

    def rates(self) -> Dict[str, float]:
        dt = max(self.elapsed, 1e-9)
        return {"steps_per_sec": self.steps / dt,
                "items_per_sec": self.items / dt,
                "avg_step_ms": 1e3 * dt / max(self.steps, 1)}
