"""The measured window around the program's own training loop.

``TimedLoader`` wraps the program's loader: it runs on the Trainer's
prefetch thread, times each batch the sampler makes, counts the batch's
real rows and edges, keeps the first few host batches for the check, and
stops yielding once the window has closed. ``TimedModule`` wraps the
program's module: the Trainer calls its ``train_step``, which hands the
checked steps the benchmark's own draws, keeps what the check reads
(the loss, Adam's first moments after step 1, the parameters after the
last checked step), opens the window after the warm-up steps at a
synchronised point, records a CUDA event after every step and the host
times around every call, and closes the window at a synchronised point
once ``seconds`` have passed. In a traced run a few more steps follow
under ``torch.profiler``, each inside a ``portbench.step`` range.

Nothing here synchronises inside the window.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import torch

STEP_SPAN = "portbench.step"


class TimedLoader:
    """The program's loader, epoch after epoch, until ``stop`` is set."""

    def __init__(self, inner, length: int, keep: int,
                 counts: Callable[[object], Dict[str, int]]):
        self.inner = inner
        self.length = length
        self.keep = keep
        self.counts = counts
        self.stop = threading.Event()
        self.batches: List[Dict[str, float]] = []
        self.kept: List[object] = []
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return self.length

    def __iter__(self):
        epoch = self.epoch
        while not self.stop.is_set():
            self.inner.set_epoch(epoch)
            it = iter(self.inner)
            while not self.stop.is_set():
                t = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    break
                sample_s = time.perf_counter() - t
                record = dict(self.counts(batch), sample_s=sample_s)
                self.batches.append(record)
                if len(self.kept) < self.keep:
                    self.kept.append(batch)
                yield batch
            epoch += 1


class TimedModule:
    """The program's module as the Trainer sees it, with the window's
    clock around ``train_step``. ``draws(i, batch)`` gives step i's
    injected draws for the first ``check`` steps; ``weights`` (by
    parameter name) are the benchmark's initial weights."""

    def __init__(self, inner, loader: TimedLoader, draws, check: int,
                 warmup: int, seconds: float, trace_steps: int,
                 setup_clock: float, weights: Dict[str, torch.Tensor]):
        if warmup < check:
            raise ValueError("the window opens after the checked steps")
        self.inner = inner
        self.loader = loader
        self.draws = draws
        self.check = check
        self.warmup = warmup
        self.seconds = seconds
        self.trace_steps = trace_steps
        self.setup_clock = setup_clock
        self.weights = weights
        self.calls = 0
        self.losses: List[torch.Tensor] = []
        self.first_mu: Optional[List[torch.Tensor]] = None
        self.checked_params: Optional[Dict[str, torch.Tensor]] = None
        self.t0 = self.t1 = None
        self.setup_s = None
        self.setup_peak = 0
        self.window_peak = 0
        self.calls_in_window: List[tuple] = []
        self.events: List[torch.cuda.Event] = []
        self.start_event = None
        self.profiler = None
        self.traced: List[tuple] = []
        self.trace_window_s = None
        self.done = False
        self._last = None

    def __getattr__(self, name):
        return getattr(self.inner, name)

    @property
    def device(self):
        return self.inner.device

    @torch.no_grad()
    def init_state(self, generator=None):
        """The Trainer's fresh state: the benchmark's weights in the
        module, then the module's own optimizer state over them."""
        for name, p in self.inner.named_parameters():
            p.copy_(self.weights[name])
        return self.inner.init_state(None)

    def _cuda(self) -> bool:
        return self.inner.device.type == "cuda"

    def _sync(self):
        if self._cuda():
            torch.cuda.synchronize(self.inner.device)

    def _open_window(self):
        self._sync()
        if self._cuda():
            self.setup_peak = torch.cuda.max_memory_allocated(
                self.inner.device)
            torch.cuda.reset_peak_memory_stats(self.inner.device)
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record()
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.setup_clock

    def _close_window(self):
        self._sync()
        self.t1 = time.perf_counter()
        if self._cuda():
            self.window_peak = torch.cuda.max_memory_allocated(
                self.inner.device)

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self._cuda():
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities, record_shapes=True)
        self.profiler.__enter__()
        self._trace_t0 = time.perf_counter()

    def _stop_trace(self):
        self._sync()
        self.trace_window_s = time.perf_counter() - self._trace_t0
        self.profiler.__exit__(None, None, None)

    def train_step(self, state, batch, generator=None, group=None):
        i = self.calls
        self.calls += 1
        if self.done:
            # batches the prefetch thread made before the window closed
            return state, self._last
        if i == self.warmup:
            self._open_window()
        draws = self.draws(i, batch) if i < self.check else {}
        traced = self.profiler is not None
        t_call = time.perf_counter()
        if traced:
            with torch.profiler.record_function(STEP_SPAN):
                state, logs = self.inner.train_step(state, batch, generator,
                                                    group=group, **draws)
        else:
            state, logs = self.inner.train_step(state, batch, generator,
                                                group=group, **draws)
        t_ret = time.perf_counter()
        self._last = logs
        if i < self.check:
            self._keep_checked(i, state, logs)
        if traced:
            self.traced.append((i, t_call, t_ret))
            if len(self.traced) == self.trace_steps:
                self._stop_trace()
                self._finish()
            return state, logs
        if self.t0 is not None and self.t1 is None:
            if self._cuda():
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.events.append(event)
            self.calls_in_window.append((i, t_call, t_ret))
            if t_ret - self.t0 >= self.seconds:
                self._close_window()
                if self.trace_steps:
                    self._start_trace()
                else:
                    self._finish()
        return state, logs

    def _finish(self):
        self.done = True
        self.loader.stop.set()

    @torch.no_grad()
    def _keep_checked(self, i, state, logs):
        self.losses.append(logs["train_loss"].detach().clone())
        if i == 0:
            self.first_mu = [m.clone() for m in state.opt_state.mu]
            self.param_names = list(state.params)
        if i == self.check - 1:
            self.checked_params = {k: v.detach().clone()
                                   for k, v in state.params.items()}

    def intervals_s(self) -> List[float]:
        """Each window step's interval on the device's clock: from the
        event after the step before (the window's start for the first)
        to the event after it."""
        if not self.events:
            return [t_ret - t_call for _, t_call, t_ret
                    in self.calls_in_window]
        marks = [self.start_event] + self.events
        return [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
