"""The program's own spans (``biomedkg_tpu_torch/utils/profiling.py``) in
a traced run: the host metrics they give over the window, the split of
the device's idle time by what the host was doing, and the longest idle
gaps with the span each thread was in.

The benchmark's runner does not turn the recorder on yet (runner.py
would start it before ``cell.fit`` in a traced run and hand the
profiler's events, the window and its steps to the readers), so ``run``
drives a traced run through ``runner.run_cell``'s ``fault`` hook, which
sees the run's ``TimedModule``:

    python3 -m portbench.spans --workload <cell> --seed <n> \
        --seconds <s> [--recorder 0]

prints one JSON line: the run's result, the span metrics and the idle
split and gaps (``--recorder 0``: the same traced run with the recorder
off, which reports no span metric).

Span metrics (``None`` where the run has nothing for one to read):

* ``trainer_wait_ms``: ``trainer.wait`` (main thread) starting in the
  window over the window's steps;
* ``prefetch_sample_ms``: the mean ``prefetch.sample`` of the batches the
  window's steps train (by step id);
* ``prefetch_copy_ms``: the copies of the window's batches over those
  batches (a copy holds the batches its thread sampled since the copy
  before it);
* ``kernel_launches``: the mean hand-written launches a window step:
  its ``trainer.step``'s count, else the sum over the main thread's
  outermost ``step.*`` spans inside its call;
* ``idle_wait_share`` / ``idle_launch_share`` / ``idle_outside_share``
  (%): the device's idle time in the traced steps while the main
  thread's innermost span is ``trainer.wait``, ``trainer.step`` or a
  ``step.*``, or none, over the traced window; they sum to
  ``readers.idle_share``.
"""

from __future__ import annotations

import json
import sys
import threading
from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Tuple

STEP_PREFIX = "step."


def _profiling():
    """The program's span recorder, or None where the program has none."""
    try:
        from biomedkg_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "start") else None


def _ms(spans) -> float:
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6


def host_metrics(spans, calls: List[tuple], t0: float, t1: float,
                 main: int) -> Dict[str, Optional[float]]:
    """The span metrics read on the host's clock over the window
    [t0, t1] (perf_counter seconds) of ``calls`` ((step, t_call, t_ret)
    each)."""
    lo, hi = t0 * 1e9, t1 * 1e9
    n = len(calls)
    steps = {i for i, _, _ in calls}

    def named(name, **kw):
        return [s for s in spans if s.name == name
                and all(getattr(s, k) == v for k, v in kw.items())]

    def in_window(s):
        return lo <= s.start_ns <= hi

    out: Dict[str, Optional[float]] = dict.fromkeys(
        ("trainer_wait_ms", "prefetch_sample_ms", "prefetch_copy_ms",
         "kernel_launches"))
    if not spans or not n:
        return out
    waits = [s for s in named("trainer.wait", thread=main) if in_window(s)]
    samples = [s for s in named("prefetch.sample") if s.step in steps]
    if named("prefetch.sample") or waits:
        out["trainer_wait_ms"] = _ms(waits) / n
    if samples:
        out["prefetch_sample_ms"] = _ms(samples) / len(samples)
    copied, batches = [], 0
    for c, held in copy_batches(spans):
        if any(b.step in steps for b in held):
            copied.append(c)
            batches += len(held)
    if batches:
        out["prefetch_copy_ms"] = _ms(copied) / batches
    by_step = {s.step: s for s in named("trainer.step", thread=main)}
    outer = [s for s in spans if s.thread == main and s.parent is None
             and s.name.startswith(STEP_PREFIX)]
    counts = []
    for i, t_call, t_ret in calls:
        if i in by_step:
            counts.append(by_step[i].counts.get("launches", 0))
            continue
        inside = [s for s in outer
                  if t_call * 1e9 <= s.start_ns <= t_ret * 1e9]
        if inside:
            counts.append(sum(s.counts.get("launches", 0) for s in inside))
    if counts:
        out["kernel_launches"] = sum(counts) / len(counts)
    return out


def copy_batches(spans) -> List[tuple]:
    """Each ``prefetch.copy`` span with the ``prefetch.sample`` spans (of a
    batch) its thread ended since its previous copy."""
    out, since = [], defaultdict(list)
    for s in sorted(spans, key=lambda s: s.end_ns):
        if s.name == "prefetch.sample" and s.step is not None:
            since[s.thread].append(s)
        elif s.name == "prefetch.copy":
            out.append((s, since.pop(s.thread, [])))
    return out


def innermost(intervals: Iterable[Tuple[float, float, str]]
              ) -> List[Tuple[float, float, str]]:
    """Properly nested (start, end, name) intervals of one thread as
    non-overlapping (start, end, name) pieces, each under the innermost
    interval holding it."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []
    cursor = None

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for a, b, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= a:
            end, held = stack.pop()
            emit(cursor, end, held)
            cursor = end
        if stack:
            emit(cursor, a, stack[-1][1])
        stack.append((b, name))
        cursor = a
    while stack:
        end, held = stack.pop()
        emit(cursor, end, held)
        cursor = end
    return out


def union(intervals: Iterable[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_intervals(busy: List[Tuple[float, float]], lo: float, hi: float
                   ) -> List[Tuple[float, float]]:
    out, at = [], lo
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def split(idle: List[Tuple[float, float]],
          pieces: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Each idle interval's length, cut by ``pieces`` (non-overlapping,
    sorted) and summed by their names; the rest under ``None``."""
    out: Dict[Optional[str], float] = defaultdict(float)
    total = sum(b - a for a, b in idle)
    for a, b in idle:
        for pa, pb, name in pieces:
            if pb <= a:
                continue
            if pa >= b:
                break
            out[name] += min(b, pb) - max(a, pa)
    out[None] = total - sum(v for k, v in out.items() if k is not None)
    return dict(out)


def mapped(spans, thread: int, offset_ns: float
           ) -> List[Tuple[float, float, str]]:
    """A thread's spans on the trace's clock (µs), innermost pieces."""
    return innermost(((s.start_ns + offset_ns) / 1e3,
                      (s.end_ns + offset_ns) / 1e3, s.name)
                     for s in spans if s.thread == thread)


def category(name: Optional[str]) -> str:
    if name == "trainer.wait":
        return "wait"
    if name == "trainer.step" or (name or "").startswith(STEP_PREFIX):
        return "launch"
    return "outside"


def idle_split(device: List[Tuple[float, float]], spans, offset_ns: float,
               t0: float, length_s: float, main: int
               ) -> Optional[Dict[str, float]]:
    """The traced window's idle shares (%) by the main thread's innermost
    span: ``device`` the device operations' (start, end) µs on the
    trace's clock, the window from ``t0`` (perf_counter seconds) for
    ``length_s``."""
    if not device or offset_ns is None or length_s <= 0:
        return None
    lo = (t0 * 1e9 + offset_ns) / 1e3
    hi = lo + length_s * 1e6
    idle = idle_intervals(union(device, lo, hi), lo, hi)
    shares = dict.fromkeys(("wait", "launch", "outside"), 0.0)
    for name, us in split(idle, mapped(spans, main, offset_ns)).items():
        shares[category(name)] += 100.0 * us / (length_s * 1e6)
    return shares


def longest_gaps(device, spans, offset_ns: float, lo: float, hi: float,
                 main: int, n: int = 8) -> List[dict]:
    """The ``n`` longest idle gaps in [lo, hi] µs, each with the
    innermost span of the main thread and of every other thread at the
    gap's middle."""
    idle = idle_intervals(union(device, lo, hi), lo, hi)
    threads = {s.thread for s in spans}
    pieces = {t: mapped(spans, t, offset_ns) for t in threads}
    out = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        held = {t: next((name for pa, pb, name in p if pa <= mid < pb),
                        None) for t, p in pieces.items()}
        out.append({"us": b - a, "at_us": a - lo,
                    "main": held.get(main),
                    "others": sorted(v for t, v in held.items()
                                     if t != main and v)})
    return out


def run(workload: str, seed: int, seconds: float, device: str,
        clock: float, recorder: bool = True, bench=None,
        overrides=None) -> dict:
    """A traced run of ``workload`` with the program's recorder on from
    before the Trainer starts (or off), and what its spans give."""
    from . import runner
    from .readers import idle_share
    profiling = _profiling() if recorder else None
    seen: dict = {}

    def hook(cell, timed):
        seen["timed"] = timed
        if profiling is None:
            return
        marks = seen["launches"] = []
        for name in ("_open_window", "_close_window"):
            inner = getattr(timed, name)

            def wrapped(inner=inner):
                inner()
                marks.append(profiling.kernel_launches())
            setattr(timed, name, wrapped)
        profiling.start()

    try:
        result = runner.run_cell(workload, seed, seconds, True, device,
                                 clock, bench=bench, overrides=overrides,
                                 fault=hook)
    finally:
        spans = profiling.stop() if profiling is not None else []
    timed = seen["timed"]
    main = threading.main_thread().native_id
    out = {"result": result, "recorder": profiling is not None,
           "spans": host_metrics(spans, timed.calls_in_window, timed.t0,
                                 timed.t1, main)}
    if profiling is None:
        return out
    marks = seen["launches"]
    if len(marks) >= 2 and timed.calls_in_window:
        out["launches_by_wrappers"] = (marks[1] - marks[0]) / len(
            timed.calls_in_window)
    from .trace import Trace, _kind
    events = timed.profiler.events()
    # the host's ranges only: an annotation's device copy bears its name
    twins = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if getattr(e, "is_user_annotation", False)
             and _kind(e) == "CPU"]
    offset = profiling.clock_offset_ns(spans, twins)
    tr = Trace(events, timed.trace_window_s, [])
    device_us = [(k.time_range.start, k.time_range.end) for k in tr.device]
    shares = idle_split(device_us, spans, offset, timed._trace_t0,
                        timed.trace_window_s, main)
    if shares is not None:
        out["spans"].update({f"idle_{k}_share": v
                             for k, v in shares.items()})
        out["idle_share"] = idle_share(SimpleNamespace(trace=tr))
        lo = (timed._trace_t0 * 1e9 + offset) / 1e3
        out["gaps"] = longest_gaps(device_us, spans, offset, lo,
                                   lo + timed.trace_window_s * 1e6, main)
    window = [s for s in spans
              if timed.t0 * 1e9 <= s.start_ns <= timed.t1 * 1e9]
    by_name = defaultdict(list)
    for s in window:
        by_name[s.name].append((s.end_ns - s.start_ns) / 1e6)
    out["span_ms"] = {k: [len(v), sum(v) / len(v), max(v)]
                      for k, v in sorted(by_name.items())}
    out["offset_ns"] = offset
    out["dropped"] = profiling.dropped()
    return out


def main(argv: List[str], clock: float) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, "cuda", clock,
              recorder=bool(args.recorder))
    out["seed"], out["workload"] = args.seed, args.workload
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    from portbench import run as entry  # the benchmark's environment
    sys.exit(main(sys.argv[1:], entry.CLOCK))
