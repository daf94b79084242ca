"""Readers of the RGAT + ComplEx cell (cells/rgat.py), beside readers.py:
the grouped GEMM's roofline share, the attention's share of the device
time and the hand-written launches a step. Each returns None where its
run has nothing for it to read: an untraced run, or a program without the
RGAT spans or the span recorder."""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

from . import bounds, rgat_bounds
from .cells.kge import layer_dims
from .trace import _kind

RELMM = ("_RelationMatmulSorted", "_RelationMatmulSortedBackward")


def relmm_roofline(rec) -> Optional[float]:
    """The grouped GEMMs (the program's ``_RelationMatmulSorted`` Function:
    its forwards, and its backwards with d_msg and dW) against
    ``rgat_bounds.relmm_step_s`` on each traced step's real edges: Σ least
    time over Σ device time, over the traced steps they ran in."""
    if rec.trace is None:
        return None
    cell, cfg = rec.cell, rec.cell.cfg
    device = defaultdict(float)
    for e in rec.trace.entries(RELMM):
        if e["step"] is not None:
            device[e["step"]] += e["device_s"]
    least = sum(rgat_bounds.relmm_step_s(
        rec.trace.step_counts[step]["edges"], layer_dims(cfg),
        cfg["num_heads"], cell.graph.num_relations) for step in device)
    return bounds.share(least, sum(device.values()))


def attend_share(rec) -> Optional[float]:
    """The % of the traced steps' device time launched from inside the
    ``rgat.attend`` spans' profiler twins (the forward's logits and
    segment softmax; the twins and their launches on the main thread)."""
    events = getattr(rec.cell, "events", None)
    if rec.trace is None or not events:
        return None
    twins = [e for e in events if e.name == "rgat.attend"
             and getattr(e, "is_user_annotation", False)
             and _kind(e) == "CPU"]
    if not twins:
        return None
    main = twins[0].thread
    ranges = sorted((e.time_range.start, e.time_range.end) for e in twins)
    launches = {e.id: e.time_range.start for e in events
                if _kind(e) == "CPU" and e.thread == main
                and e.name.startswith("cu")}
    total = inside = 0.0
    for k in rec.trace.device:
        us = k.time_range.end - k.time_range.start
        total += us
        t = launches.get(k.id)
        if t is not None and any(a <= t <= b for a, b in ranges):
            inside += us
    return bounds.share(inside, total)


def kernel_launches(rec) -> Optional[float]:
    """The hand-written kernels' launches a traced step: the mean of the
    traced steps' ``trainer.step`` span counts."""
    spans, traced = getattr(rec.cell, "spans", None), \
        getattr(rec.cell, "traced", None)
    if not spans or not traced:
        return None
    steps = {i for i, _, _ in traced}
    counts = [s.counts.get("launches", 0) for s in spans
              if s.name == "trainer.step" and s.step in steps]
    return sum(counts) / len(counts) if counts else None
