"""Profiling and tracing hooks (counterpart of
biomedkg_tpu/utils/profiling.py).

* The span recorder: named host intervals inside the training loop, the
  prefetch thread and the step, off by default. ``start()`` turns it on
  (and clears it), ``stop()`` turns it off and returns the ``Span``s
  recorded. A span site is ``with span(name, step=..., counters=...)``;
  while the recorder is off it returns the shared no-op ``NO_SPAN`` after
  one test of the module flag ``ON``, with no clock read and no
  allocation. While it is on, each span records its name, thread, start
  and end (``time.perf_counter_ns``), parent span and step id (its own, or
  its parent's), and the change over its interval of the counters it
  names: ``LAUNCHES`` (the hand-written kernels' ``launches`` counters
  summed, on every thread: a backward's kernels launch on autograd's
  thread while the main thread waits in the backward span) or counts
  added with ``count``. Spans are kept in memory up to ``capacity``; later
  ones are counted in ``dropped()`` only. ``counters()`` gives the
  counters' totals since ``start``; ``stop()`` adds to them the flash
  backward's device tally (``ops/flashnce.py`` ``TALLY``:
  ``flash_bwd_items``, ``flash_bwd_cut``, ``flash_bwd_slices``), which
  ``start()`` clears: read once, after the window, never inside a
  step.
* Clock: while a ``torch.profiler`` session is active, each main-thread
  span is also emitted as a ``record_function`` range of the same name
  (its twin; ranges opened on other threads do not reach the profiler's
  events). ``clock_offset_ns`` is the median gap between the spans and
  their twins, which places every span, any thread's, on the trace's
  clock.
* ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
  where present, CUDA activity) with the recorder on, that writes a Chrome
  trace (``trace.json``, for chrome://tracing or Perfetto) under
  ``logdir``: the profiler's events and the recorder's spans on the
  trace's clock, one track a thread (process "spans"), each span's step,
  parent and counts in its args.
* ``debug_nans(enable)``: autograd anomaly detection, the nearest torch
  counterpart of ``jax_debug_nans``.

The spans, by site: ``trainer.wait`` (the consumer's blocking queue get
in ``sampling/loaders.py::prefetch``), ``trainer.step`` (each
``train_step`` call of ``Trainer._fit``; the global step),
``step.forward`` / ``step.backward`` / ``step.update`` / ``step.draw``
(``training/stepping.py``, ``optim.py``, ``typed_train.py``),
``prefetch.sample`` (each loader ``next()`` of ``Trainer._stream``; the
step the batch trains; rows and edges), ``sample.hops`` / ``sample.walk``
/ ``sample.induce`` / ``sample.pad`` (the samplers' phases),
``prefetch.copy`` (each item's host-to-device copy; bytes) and, in each
RGAT conv's forward (``models/encoders.py::RGAT._conv``),
``rgat.messages`` (launches; ``edge_slots``, the batch's edge slots from
the shape), ``rgat.attend`` (launches; ``pair_logit_convs``, one a conv
whose logits come from the per-(node, relation) projection table) and
``rgat.aggregate`` (launches).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence

import torch

# tested at every span site; set by start() and stop() only
ON = False
LAUNCHES = "launches"
_clock = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    thread: int             # native thread id
    thread_name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    step: Optional[int]
    counts: Dict[str, int]  # each named counter's change over the span
    twin: bool              # also emitted as a record_function range


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()

_spans: List[Span] = []
_capacity = 0
_dropped = 0
_counts: Dict[str, int] = defaultdict(int)
_count_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()


def kernel_launches() -> int:
    """The hand-written kernels' launches so far: the sum of the
    wrappers' own ``launches`` counters."""
    from ..ops import flashnce, negscore, relmm, segsum
    return (segsum.KERNEL.launches + negscore.BUCKETS.launches
            + sum(k.launches for m in (negscore, flashnce, relmm)
                  for k in m.KERNELS.values()))


def _read(names: Sequence[str]) -> List[int]:
    return [kernel_launches() if n == LAUNCHES else _counts[n]
            for n in names]


def count(name: str, n: int) -> None:
    """Add ``n`` to the process-wide counter ``name`` (while on)."""
    if ON:
        with _count_lock:
            _counts[name] += n


class _Active:
    __slots__ = ("name", "step", "counters", "id", "parent", "before",
                 "twin", "start_ns")

    def __init__(self, name: str, step: Optional[int],
                 counters: Sequence[str]):
        self.name, self.step, self.counters = name, step, counters

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.step is None and parent is not None:
            self.step = parent.step
        self.id = next(_ids)
        stack.append(self)
        self.before = _read(self.counters)
        self.twin = None
        if threading.current_thread() is threading.main_thread() \
                and torch.autograd._profiler_enabled():
            # record_function's own op, without its Python wrapper; the
            # clock is read as each of the twin's calls returns, so the
            # twin's two ends lead the span's by about the same time
            self.twin = torch.ops.profiler._record_function_enter_new(
                self.name, None)
        self.start_ns = _clock()
        return self

    def __exit__(self, *exc):
        if self.twin is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(
                self.twin)
        end_ns = _clock()
        _local.stack.pop()
        counts = {n: after - before for n, before, after in
                  zip(self.counters, self.before, _read(self.counters))}
        _keep(Span(self.name, threading.get_native_id(),
                   threading.current_thread().name, self.start_ns, end_ns,
                   self.id, self.parent, self.step, counts,
                   self.twin is not None))
        return False


def _keep(s: Span) -> None:
    global _dropped
    if not ON:
        return
    if len(_spans) < _capacity:
        _spans.append(s)
    else:
        _dropped += 1


def span(name: str, step: Optional[int] = None,
         counters: Sequence[str] = ()):
    """A context manager timing its block as the span ``name`` while the
    recorder is on; ``NO_SPAN`` while it is off."""
    if not ON:
        return NO_SPAN
    return _Active(name, step, counters)


def start(capacity: int = 1 << 18) -> None:
    """Clear the recorder, the counters and the flash backward's tally
    and turn the recorder on; it keeps the first ``capacity`` spans."""
    global ON, _capacity, _dropped
    from ..ops import flashnce
    _spans.clear()
    _counts.clear()
    flashnce.BACKWARD.clear_tally()
    _capacity, _dropped = capacity, 0
    ON = True


def stop() -> List[Span]:
    """Turn the recorder off (if on) and, if it was on, add the flash
    backward's tally since ``start`` to the counters; the spans recorded
    since ``start``, in the order they ended. A span that ends while the
    recorder is off is not kept."""
    global ON
    was, ON = ON, False
    if was:
        from ..ops import flashnce
        with _count_lock:
            _counts.update(flashnce.BACKWARD.tally())
    return list(_spans)


def counters() -> Dict[str, int]:
    """The counters' totals since ``start`` (``count`` and, after
    ``stop``, the flash backward's tally)."""
    with _count_lock:
        return dict(_counts)


def dropped() -> int:
    """Spans past ``capacity`` since ``start``, not kept."""
    return _dropped


def clock_offset_ns(spans: Iterable[Span],
                    twins: Iterable[tuple]) -> Optional[float]:
    """The offset that places a span on a trace's clock: trace µs =
    (ns + offset) / 1e3. ``twins`` are the trace's ``record_function``
    ranges as (name, start µs, end µs); the k-th twin-emitting span of a
    name is matched to the k-th range of that name in start order, and
    the offset is the median gap of their starts and ends. None without a
    match."""
    ranges = defaultdict(list)
    for name, a, b in sorted(twins, key=lambda t: t[1]):
        ranges[name].append((a, b))
    taken: Dict[str, int] = defaultdict(int)
    gaps = []
    for s in sorted((s for s in spans if s.twin), key=lambda s: s.start_ns):
        k = taken[s.name]
        taken[s.name] += 1
        if k < len(ranges[s.name]):
            a, b = ranges[s.name][k]
            gaps += [a * 1e3 - s.start_ns, b * 1e3 - s.end_ns]
    return statistics.median(gaps) if gaps else None


def _add_spans(path: str, spans: List[Span]) -> None:
    """Append ``spans`` to the Chrome trace at ``path``, on its clock (by
    the main-thread spans' twins among its user annotations); nothing
    when no twin is found."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    offset = clock_offset_ns(spans, [
        (e["name"], e["ts"], e["ts"] + e.get("dur", 0)) for e in events
        if e.get("ph") == "X" and e.get("cat") == "user_annotation"])
    if offset is None:
        return
    pid = "spans"
    threads = {}
    for s in spans:
        threads.setdefault(s.thread, s.thread_name)
        events.append({
            "ph": "X", "cat": "span", "name": s.name, "pid": pid,
            "tid": s.thread, "ts": (s.start_ns + offset) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": dict(s.counts, id=s.id, parent=s.parent, step=s.step)})
    for tid, name in threads.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block with the span recorder on; its Chrome
    trace, the recorder's spans included, goes to
    ``<logdir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    start()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
    finally:
        spans = stop()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, spans)


def debug_nans(enable: bool = True):
    """Turn autograd's anomaly detection on or off.

    Unlike ``jax_debug_nans``, which re-runs a jitted function op by op
    and raises at the first primitive whose output holds a NaN (forward
    or backward), this raises only when a backward function returns a NaN
    (naming the forward op that made it, with its traceback); a NaN that
    forward code computes and no gradient touches passes unseen. It slows
    every autograd op while on."""
    torch.autograd.set_detect_anomaly(enable)
