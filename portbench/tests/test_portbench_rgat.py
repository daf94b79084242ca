"""The RGAT + ComplEx cell at a tiny size on the CPU: a run through
``runner.run_cell`` is correct, with the recorder off, and reports the
cell's metrics; a planted fault comes out not correct and the bf16
control fails a limit; the cell's readers give None untraced and numbers
traced (the device readers on a made-up trace: the CPU runs no device
operation); and the padded envelope does not follow the run's seed."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import faults, rgat_bounds, rgat_readers, runner
from portbench.trace import Trace
from portbench.tests import tiny

CELL = "kge-rgat-complex.saint-rel-r1024-k10"
OVERRIDES = {"config": {"in_dim": 32, "hidden_dim": 16, "out_dim": 16,
                        "steps_per_epoch": 50, "graph": tiny.GRAPH},
             "traffic": {"roots": 16, "warmup_steps": 4, "trace_steps": 2}}
DEVICE_READERS = ("relmm_roofline.rgat", "negscore_roofline.rgat",
                  "attend_share.rgat", "idle_share.rgat")


def run(trace=False, fault=None, seed=4242424242):
    return runner.run_cell(CELL, seed, 0.3, trace, "cpu",
                           time.perf_counter(), overrides=OVERRIDES,
                           fault=fault)


@pytest.fixture(scope="module")
def traced():
    kept = {}

    def keep(cell, timed):
        kept["cell"] = cell

    return run(trace=True, fault=keep), kept["cell"]


def test_run_is_correct_and_reports_the_cells_metrics(monkeypatch):
    from biomedkg_tpu_torch.utils import profiling

    def refuse(*args, **kwargs):
        raise AssertionError("an untraced run turned the recorder on")

    monkeypatch.setattr(profiling, "start", refuse)
    kept = {}
    result = run(fault=lambda cell, timed: kept.update(cell=cell))
    assert kept["cell"].spans is None and not profiling.ON
    assert result["correct"] is True
    bench = runner.load_json(runner.ROOT, "BENCHMARK.json")
    want = {m["name"] for m in runner.cell_metrics(bench, CELL, False)}
    assert set(result["metrics"]) == want
    assert want >= {"setup_s", "triplets_per_s", "step_ms_p90",
                    "peak_mem_gib"}
    checks = result["checks"]
    assert checks["graph_mismatch"]["value"] == 0
    assert checks["batch_faults"]["value"] == 0
    for name in ("loss_gap", "grad_gap", "update_gap"):
        assert checks[name]["value"] < checks[name]["limit"]


def test_planted_fault_comes_out_not_correct():
    assert run(fault=faults.FAULTS["half_batch"])["correct"] is False


def test_bf16_control_fails_a_limit():
    from portbench.cells import common
    kept = {}

    def keep(cell, timed):
        kept["cell"], kept["loader"] = cell, timed.loader

    result = run(fault=keep)
    cell, batches = kept["cell"], kept["loader"].kept
    readings = common.compare(
        cell.reference_readings(batches, torch.bfloat16),
        cell.reference_readings(batches, torch.float32))
    assert any(readings[k] > result["checks"][k]["limit"] for k in readings)


def test_readers_give_none_untraced():
    cell = SimpleNamespace(spans=None, traced=None, events=None)
    rec = runner.Record(cell, [], 1.0, None)
    for read in (rgat_readers.relmm_roofline, rgat_readers.attend_share,
                 rgat_readers.kernel_launches):
        assert read(rec) is None


def test_traced_run_reads_the_host_and_span_metrics(traced):
    result, cell = traced
    assert result["correct"] is True
    got = result["metrics"]
    for name in ("kernel_launches.rgat", "mfu.rgat", "dispatch_ms.rgat",
                 "sample_ms.rgat", "batch_wait_ms.rgat"):
        assert isinstance(got[name]["value"], float), name
    # the plain versions launch no hand-written kernel
    assert got["kernel_launches.rgat"]["value"] == 0.0
    assert not set(got) & set(DEVICE_READERS)
    names = {s.name for s in cell.spans}
    assert {"rgat.messages", "rgat.attend", "rgat.aggregate",
            "trainer.step"} <= names
    assert cell.counters["edge_slots"] > 0


def _event(name, kind, start, end, eid=0, thread=1, annotation=False):
    return SimpleNamespace(
        name=name, device_type=kind, id=eid, thread=thread,
        time_range=SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation, is_async=False, input_shapes=[],
        input_dtypes=[], concrete_inputs=[])


def test_device_readers_on_a_made_up_trace():
    """One traced step: the forward product's kernel (10 µs) launched
    inside ``_RelationMatmulSorted``, another kernel (30 µs) launched from
    inside the ``rgat.attend`` twin, one (60 µs) outside both."""
    events = [
        _event("portbench.step", "CPU", 0, 1000),
        _event("_RelationMatmulSorted", "CPU", 10, 50),
        _event("cudaLaunchKernel", "CPU", 20, 21, eid=1),
        _event("relmm_kernel", "CUDA", 100, 110, eid=1),
        _event("rgat.attend", "CPU", 200, 300, annotation=True),
        _event("cudaLaunchKernel", "CPU", 210, 211, eid=2),
        _event("softmax_kernel", "CUDA", 400, 430, eid=2),
        _event("cudaLaunchKernel", "CPU", 500, 501, eid=3),
        _event("other_kernel", "CUDA", 600, 660, eid=3),
    ]
    counts = {"edges": 1000, "nodes": 100}
    cfg = {"in_dim": 32, "hidden_dim": 16, "out_dim": 16,
           "num_hidden_layers": 2, "num_heads": 2}
    cell = SimpleNamespace(cfg=cfg, events=events,
                           graph=SimpleNamespace(num_relations=8))
    rec = runner.Record(cell, [], 1.0, Trace(events, 1e-3, [counts]))
    least = rgat_bounds.relmm_step_s(1000, [(32, 16), (16, 16), (16, 16),
                                            (16, 16)], 2, 8)
    assert rgat_readers.relmm_roofline(rec) == pytest.approx(
        100.0 * least / 10e-6)
    assert rgat_readers.attend_share(rec) == pytest.approx(30.0)


def test_envelope_is_the_configurations_and_the_walks_the_runs():
    """Two seeds whose own probes give two envelopes (cells/kge.py probes
    under the run's seed): one padded envelope here (probed under
    split_seed), two walk streams."""
    from portbench.cells import kge, rgat
    cfg = runner.load_json(runner.HERE, "configs", "kge-rgat-complex.json")
    traffic = runner.load_json(runner.HERE, "traffic",
                               "saint-rel-r1024-k10.json")
    cfg.update(OVERRIDES["config"])
    traffic.update(OVERRIDES["traffic"], roots=32)
    seeds = (1, 2**40 + 3)
    own = {kge.Cell(cfg, traffic, s, "cpu").loader.edge_budget
           for s in seeds}
    assert len(own) == 2
    a, b = (rgat.Cell(cfg, traffic, s, "cpu") for s in seeds)
    assert (a.loader.node_budget, a.loader.edge_budget) == \
        (b.loader.node_budget, b.loader.edge_budget)
    assert a.loader.seed != b.loader.seed
