"""A run's result line, its import check, the reference against the
port's CPU path, the control and the planted faults, at tiny sizes on
the CPU; and one short run on the card (skipped without one)."""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import faults, runner
from portbench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


bench = tiny.bench
CELLS = [tiny.KGE, tiny.GCL, tiny.TYPED]


@pytest.fixture(scope="module", params=CELLS)
def traced(request):
    return request.param, tiny.run(request.param, trace=True)


@pytest.mark.parametrize("workload", CELLS)
def test_result_line_shape_and_reference_agrees(workload):
    result = tiny.run(workload)
    assert set(result) >= {"correct", "attempted", "failed", "metrics",
                           "device"}
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = {m["name"]: m["unit"]
            for m in runner.cell_metrics(bench(), workload, False)}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    checks = result["checks"]
    assert checks["graph_mismatch"]["value"] == 0
    assert checks["batch_faults"]["value"] == 0
    for name in ("loss_gap", "grad_gap", "update_gap"):
        assert checks[name]["value"] < 1e-4
    json.dumps(result)


def test_traced_run_reads_host_metrics(traced):
    workload, result = traced
    assert result["correct"] is True
    names = {m["name"] for m in runner.cell_metrics(bench(), workload, True)}
    got = set(result["metrics"])
    assert got <= names
    # the CPU runs no device operation: no device metric is read
    assert not any("roofline" in n or "idle" in n for n in got)
    assert {n for n in got if n.startswith(("sample_ms", "dispatch_ms",
                                            "batch_wait_ms", "mfu"))}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["busy_s"] == 0.0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_each_fault_comes_out_not_correct(workload, fault):
    result = tiny.run(workload, fault=faults.FAULTS[fault])
    assert result["correct"] is False


@pytest.mark.parametrize("workload", CELLS)
def test_bf16_control_comes_out_not_correct(workload):
    """The reference computed in bfloat16 in the program's place fails a
    limit of the cell's check."""
    from portbench.cells import common
    kept = {}

    def keep(cell, timed):
        kept["cell"], kept["loader"] = cell, timed.loader

    result = tiny.run(workload, fault=keep)
    cell, batches = kept["cell"], kept["loader"].kept
    ref = cell.reference_readings(batches, torch.float32)
    low = cell.reference_readings(batches, torch.bfloat16)
    readings = common.compare(low, ref)
    limits = {k: v["limit"] for k, v in result["checks"].items()}
    assert any(readings[k] > limits[k] for k in readings)


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert "biomedkg_tpu_torch" in sys.modules
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "biomedkg_tpu.models", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert runner.forbidden_modules() == ["biomedkg_tpu", "jaxlib"]


def test_refuses_without_the_cells_devices(tmp_path):
    """Without CUDA the run exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           tiny.GCL, "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and portbench/ the run exits
    non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           tiny.GCL, "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    result = tiny.run(workload, trace=True, device="cuda", seconds=1.0)
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
