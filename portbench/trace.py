"""What a traced run reads from ``torch.profiler``: the device's busy
time, each device operation's time attributed to the program's op entry
points, the steps they belong to, and the idle gaps.

A device operation is linked to the CUDA API call that launched it by
their common correlation id, and that call to the program's op entry
point (an autograd Function such as ``_SortedSegmentSum``, its backward
node, or an aten op) whose CPU range holds the call's time: the
innermost such op of the names a reader asks for owns it. The step is
the ``portbench.step`` range whose time holds the owning op's start (the
backward runs on the autograd engine's thread inside the calling
thread's range). Kernel symbol names are not read, so a redesign under a
new kernel name keeps its entry point's metric.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import numpy as np

from .harness import STEP_SPAN


def _kind(evt) -> str:
    return str(getattr(evt, "device_type", "")).split(".")[-1]


def _is_annotation(evt) -> bool:
    return bool(getattr(evt, "is_user_annotation", False)) \
        or evt.name == STEP_SPAN


class Trace:
    def __init__(self, events, window_s: float, step_counts: List[dict]):
        self.window_s = window_s
        self.step_counts = step_counts
        cpu = [e for e in events if _kind(e) == "CPU"
               and not getattr(e, "is_async", False)]
        self.device = [e for e in events if _kind(e) == "CUDA"
                       and not _is_annotation(e)]
        device_ids = {e.id for e in self.device}
        # the CUDA API calls (runtime or driver) that launched them
        self.launch_time = {}
        for e in cpu:
            if e.id in device_ids and e.name.startswith("cu"):
                self.launch_time[e.id] = e.time_range.start
        self.ops = [e for e in cpu if not e.name.startswith("cu")
                    and not _is_annotation(e)]
        spans = sorted((e for e in cpu if e.name == STEP_SPAN),
                       key=lambda e: e.time_range.start)
        self.span_starts = [e.time_range.start for e in spans]
        self.span_ends = [e.time_range.end for e in spans]
        self.busy_s = _union_us([(e.time_range.start, e.time_range.end)
                                 for e in self.device]) / 1e6

    def step_of(self, op) -> Optional[int]:
        t = op.time_range.start
        j = bisect.bisect_right(self.span_starts, t) - 1
        if j >= 0 and t <= self.span_ends[j]:
            return j
        return None

    def _owners(self, ops: List, kernels: List) -> List[Optional[object]]:
        """For each kernel, the innermost of ``ops`` whose range holds its
        launch call, or None."""
        if not ops:
            return [None] * len(kernels)
        starts = np.array([o.time_range.start for o in ops], np.float64)
        ends = np.array([o.time_range.end for o in ops], np.float64)
        out = []
        for k in kernels:
            t = self.launch_time.get(k.id)
            if t is None:
                out.append(None)
                continue
            inside = np.flatnonzero((starts <= t) & (ends >= t))
            out.append(ops[inside[np.argmax(starts[inside])]]
                       if len(inside) else None)
        return out

    def entries(self, names: Iterable[str]) -> List[Dict]:
        """One record per owning op instance of ``names``: its name, input
        shapes and types, concrete inputs, step (index into
        ``step_counts``) and summed device seconds."""
        names = set(names)
        ops = [o for o in self.ops if o.name in names]
        owned: Dict[int, Dict] = {}
        for k, op in zip(self.device, self._owners(ops, self.device)):
            if op is None:
                continue
            rec = owned.get(id(op))
            if rec is None:
                rec = owned[id(op)] = {
                    "name": op.name, "shapes": op.input_shapes,
                    "dtypes": list(getattr(op, "input_dtypes", []) or []),
                    "concrete": list(getattr(op, "concrete_inputs", [])
                                     or []),
                    "step": self.step_of(op), "device_s": 0.0}
            rec["device_s"] += (k.time_range.end - k.time_range.start) / 1e6
        return list(owned.values())

    def top_device_ops(self, n: int = 10) -> List[list]:
        total = defaultdict(float)
        for k in self.device:
            total[k.name[:120]] += (k.time_range.end
                                    - k.time_range.start) / 1e6
        return [[name, s] for name, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, longest: int = 200) -> List[list]:
        """The idle gaps between device operations inside the step
        ranges, the ``longest`` of them summed by the innermost CPU op
        that launched the operation after the gap (what the device
        waited for)."""
        if not self.span_starts:
            return []
        lo, hi = self.span_starts[0], self.span_ends[-1]
        ks = sorted((k for k in self.device if k.time_range.end > lo
                     and k.time_range.start < hi),
                    key=lambda k: k.time_range.start)
        gaps, end = [], lo
        for k in ks:
            if k.time_range.start > end:
                gaps.append((k.time_range.start - end, k))
            end = max(end, k.time_range.end)
        gaps = sorted(gaps, key=lambda g: -g[0])[:longest]
        owners = self._owners(self.ops, [k for _, k in gaps])
        by = defaultdict(float)
        for (gap, k), op in zip(gaps, owners):
            by[(op.name if op is not None else "(no CPU op)")[:120]] += \
                gap / 1e6
        return [[name, s] for name, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _union_us(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total
