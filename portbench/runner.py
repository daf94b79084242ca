"""One benchmark run of one cell: set-up, the warm-up and checked steps,
the measured window through the program's ``Trainer.fit``, the check
against the plain reference, and the result line.

The cell is found by name in ``BENCHMARK.json``; its configuration in
``portbench/configs/<config>.json``, its traffic in
``portbench/traffic/<traffic>.json``, the stage driver by the
configuration's ``stage`` (``portbench/cells/<stage>.py``), each limit of
the check in the configuration's ``limits``, and each metric's reader in
``portbench/metrics/<metric>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "biomedkg_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``biomedkg_tpu_torch`` is not ``biomedkg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def read_metric(name: str, rec) -> Optional[float]:
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    value = module.read(rec)
    return None if value is None else float(value)


class Record:
    """What the metric readers read (readers.py)."""

    def __init__(self, cell, steps, window_s, trace):
        self.cell, self.steps, self.window_s, self.trace = \
            cell, steps, window_s, trace


def cell_metrics(bench: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics this cell reports in a run of this kind."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def window_steps(timed, loader) -> List[dict]:
    """Every window step: its batch's host counts and sample time, the
    host's wait before the call and time inside it, and its interval."""
    steps, prev_ret = [], None
    intervals = timed.intervals_s()
    for (i, t_call, t_ret), interval in zip(timed.calls_in_window,
                                            intervals):
        s = dict(loader.batches[i])
        s["wait_s"] = None if prev_ret is None else t_call - prev_ret
        s["dispatch_s"] = t_ret - t_call
        s["interval_s"] = interval
        steps.append(s)
        prev_ret = t_ret
    return steps


def end_to_end(cell, timed, steps: List[dict]) -> Dict[str, float]:
    from . import bounds
    window_s = timed.t1 - timed.t0
    out = {"setup_s": timed.setup_s,
           "step_ms_p90": 1e3 * bounds.percentile(
               [s["interval_s"] for s in steps], 90),
           "peak_mem_gib": timed.window_peak / 2**30}
    work = sum(cell.work(s) for s in steps)
    out[cell.rate_name] = bounds.rate(work, window_s)
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str, clock: float, bench: Optional[dict] = None,
             overrides: Optional[dict] = None, fault=None) -> dict:
    """Run one cell and return the result (with ``checks``). ``overrides``
    (configuration and traffic keys) and ``fault`` (a function that
    breaks the program under the window) serve the tests."""
    import torch

    from .harness import TimedLoader, TimedModule
    from .trace import Trace

    bench = bench or load_json(ROOT, "BENCHMARK.json")
    spec = find_cell(bench, workload)
    cfg = load_json(HERE, "configs", spec["config"] + ".json")
    traffic = load_json(HERE, "traffic", spec["traffic"] + ".json")
    for k, v in (overrides or {}).get("config", {}).items():
        cfg[k] = v
    for k, v in (overrides or {}).get("traffic", {}).items():
        traffic[k] = v
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = traffic.get("driver", cfg["stage"])
    stage = importlib.import_module(f"portbench.cells.{driver}")
    cell = stage.Cell(cfg, traffic, seed, device)
    cell.rate_name = traffic["rate"]
    check = int(traffic["check_steps"])
    loader = TimedLoader(cell.loader, cell.total_steps, check, cell.counts)
    timed = TimedModule(
        cell.module, loader,
        lambda i, b: cell.draws(i, b, loader.batches[i]["nodes"]),
        check=check, warmup=int(traffic["warmup_steps"]), seconds=seconds,
        trace_steps=int(traffic["trace_steps"]) if trace else 0,
        setup_clock=clock, weights=cell.weights)
    if fault is not None:
        fault(cell, timed)
    state = cell.fit(timed, loader)
    if timed.t1 is None:
        raise RuntimeError("the loader ended before the window closed")
    last_loss = float(timed._last["train_loss"])
    steps = window_steps(timed, loader)
    metrics = end_to_end(cell, timed, steps)
    tr = None
    if trace:
        step_counts = [loader.batches[i] for i, _, _ in timed.traced]
        tr = Trace(timed.profiler.events(), timed.trace_window_s,
                   step_counts)
    rec = Record(cell, steps, timed.t1 - timed.t0, tr)
    peak = max(timed.setup_peak, timed.window_peak)
    # the program's state goes before the reference runs
    del state
    cell.module = timed.inner = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check(timed, loader)
    limits = cfg["limits"]
    correct = math.isfinite(last_loss) and all(
        checks[k] <= limits[k] for k in limits)
    reported = {}
    for m in cell_metrics(bench, workload, trace):
        value = (read_metric(m["name"], rec) if trace
                 else metrics.get(m["name"]))
        if value is not None:
            reported[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": bool(correct),
        "attempted": len(steps),
        "failed": 0 if math.isfinite(last_loss) else len(steps),
        "metrics": reported,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(peak)}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    return result


def main(argv: List[str], clock: float) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    chips = find_cell(bench, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", clock, bench)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}: the benchmark runs the "
              "port alone", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
