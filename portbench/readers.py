"""Helpers the per-layer metric readers share (``metrics/<name>.py``).

A reader is ``read(rec) -> float | None``: None when its run has nothing
for it to read, and the harness then leaves the metric out. ``rec`` holds
the cell (``rec.cell``: its configuration, traffic and counting
functions), the window's steps (``rec.steps``: each one's host counts,
``sample_s``, ``wait_s``, ``dispatch_s`` and ``interval_s``), the
window's length (``rec.window_s``) and, in a traced run, ``rec.trace``
(trace.py)."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from . import bounds

ITEMSIZE = {"float": 4, "float32": 4, "c10::BFloat16": 2, "bfloat16": 2,
            "c10::Half": 2}


def host_mean_ms(rec, key: str) -> Optional[float]:
    values = [s[key] for s in rec.steps if s.get(key) is not None]
    if not values:
        return None
    return 1e3 * sum(values) / len(values)


def window_mfu(rec) -> Optional[float]:
    """The least operations of every window step over the float32 peak
    for the window's length, as a percentage."""
    flops = sum(rec.cell.step_flops(s) for s in rec.steps)
    if not rec.steps or rec.window_s <= 0:
        return None
    return 100.0 * flops / (bounds.FP32_FLOP_PER_S * rec.window_s)


def idle_share(rec) -> Optional[float]:
    t = rec.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t.busy_s / t.window_s)


def itemsize(entry, index: int, default: int) -> int:
    dtypes = entry.get("dtypes") or []
    if index < len(dtypes):
        return ITEMSIZE.get(dtypes[index], default)
    return default


def roofline(rec, names: Iterable[str],
             least_s: Callable[[dict, dict], Optional[float]]
             ) -> Optional[float]:
    """Σ least time over Σ device time of the ops ``names`` owns in the
    traced steps, as a percentage; None when none ran."""
    if rec.trace is None:
        return None
    least = device = 0.0
    for e in rec.trace.entries(names):
        if e["step"] is None:
            continue
        t = least_s(e, rec.trace.step_counts[e["step"]])
        if t is None:
            continue
        least += t
        device += e["device_s"]
    return bounds.share(least, device)


def real_rows(m: int, slots: int, real: int) -> int:
    """``real`` where a call's row count is the batch's slots, else m."""
    return real if m == slots else m


def default_itemsize(rec) -> int:
    return 2 if rec.cell.cfg.get("compute_dtype") == "bfloat16" else 4


def segsum_roofline(rec) -> Optional[float]:
    """The segment sums (the program's ``_SortedSegmentSum`` Function,
    forward and inside the gathers' backwards) against
    ``bounds.segsum_bound_s`` on their real rows: a call over the batch's
    edge slots counts its real edges, into its node slots its real
    rows."""
    size = default_itemsize(rec)

    def least(e, counts):
        shapes = e["shapes"]
        if not shapes or len(shapes[0]) != 2 or len(e["concrete"]) < 3:
            return None
        m, d = shapes[0]
        segments = e["concrete"][2]
        if not isinstance(segments, int):
            return None
        return bounds.segsum_bound_s(
            real_rows(m, counts["edge_slots"], counts["edges"]), d,
            itemsize(e, 0, size),
            real_rows(segments, counts["node_slots"], counts["nodes"]))

    return roofline(rec, ["_SortedSegmentSum"], least)


def negscore_roofline(rec) -> Optional[float]:
    """The negative-score kernels (the program's ``_NegScores`` Function
    and its backward) against ``bounds.negscore_bound_s`` over the real
    negative slots (K x the real edges) and the batch's real rows."""
    cfg, k = rec.cell.cfg, rec.cell.k
    mode = {"dismult": "distmult"}.get(cfg["decoder_name"],
                                       cfg["decoder_name"])
    size = default_itemsize(rec)
    d = cfg["out_dim"]
    r = rec.cell.graph.num_relations

    def least(e, counts):
        backward = e["name"] != "_NegScores"
        item = size if backward else itemsize(e, 0, size)
        return bounds.negscore_bound_s(mode, counts["nodes"], d, item,
                                       k * counts["edges"], r, backward)

    return roofline(rec, ["_NegScores", "_NegScoresBackward"], least)


def flash_roofline(rec) -> Optional[float]:
    """The InfoNCE denominators (the program's ``_FlashDenom`` Function
    and its backward) against ``bounds.flash_bound_s`` over the batch's
    real rows."""
    size = default_itemsize(rec)
    d = rec.cell.cfg["out_dim"]

    def least(e, counts):
        backward = e["name"] != "_FlashDenom"
        item = size if backward else itemsize(e, 0, size)
        return bounds.flash_bound_s(counts["nodes"], d, item, backward)

    return roofline(rec, ["_FlashDenom", "_FlashDenomBackward"], least)
