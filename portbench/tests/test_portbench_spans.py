"""The span readers (portbench/spans.py): the idle split on a synthetic
device timeline and span list, a tiny traced CPU run with the program's
recorder on, and runs that record no span."""

import pytest

from biomedkg_tpu_torch.utils.profiling import Span
from portbench import readers, spans
from portbench.tests import tiny

MAIN, WORKER = 1, 2


def _span(name, a_us, b_us, thread=MAIN, i=0, parent=None, step=None):
    return Span(name, thread, "t", int(a_us * 1e3), int(b_us * 1e3), i,
                parent, step, {}, thread == MAIN)


def test_idle_split_sums_to_the_idle_share():
    # a 1000 µs window; the device busy 350 µs of it
    device = [(100, 200), (300, 450), (420, 500), (900, 950)]
    recorded = [_span("trainer.wait", 0, 150, i=0),
                _span("trainer.step", 150, 600, i=1),
                _span("step.forward", 160, 400, i=2, parent=1),
                _span("prefetch.sample", 50, 700, thread=WORKER, i=3)]
    shares = spans.idle_split(device, recorded, 0.0, 0.0, 1e-3, MAIN)
    # idle: [0, 100) waiting; [200, 300) in step.forward; [500, 600) in
    # trainer.step; [600, 900) and [950, 1000) outside any span
    assert shares == pytest.approx({"wait": 10.0, "launch": 20.0,
                                    "outside": 35.0})

    class Rec:
        class trace:
            window_s = 1e-3
            busy_s = 350e-6
    assert sum(shares.values()) == pytest.approx(readers.idle_share(Rec))
    gaps = spans.longest_gaps(device, recorded, 0.0, 0.0, 1000.0, MAIN, 2)
    assert [(g["us"], g["main"], g["others"]) for g in gaps] == [
        (400, None, []), (100, "trainer.wait", ["prefetch.sample"])]


def test_innermost_cuts_nested_spans():
    pieces = spans.innermost([(0, 10, "a"), (2, 5, "b"), (3, 4, "c"),
                              (6, 8, "d")])
    assert pieces == [(0, 2, "a"), (2, 3, "b"), (3, 4, "c"), (4, 5, "b"),
                      (5, 6, "a"), (6, 8, "d"), (8, 10, "a")]


@pytest.fixture(scope="module")
def traced_gcl():
    return spans.run(tiny.GCL, 7, 2.0, "cpu", 0.0, bench=tiny.bench(),
                     overrides=tiny.OVERRIDES[tiny.GCL])


def test_traced_run_reads_the_host_span_metrics(traced_gcl):
    out = traced_gcl
    assert out["result"]["correct"] is True
    got, result = out["spans"], out["result"]["metrics"]
    assert got["kernel_launches"] == 0.0 == out["launches_by_wrappers"]
    for name in ("trainer_wait_ms", "prefetch_sample_ms",
                 "prefetch_copy_ms"):
        assert got[name] is not None and got[name] >= 0
    # each batch's span holds the benchmark's own timing of its next()
    assert got["prefetch_sample_ms"] >= result["sample_ms.gcl"]["value"]
    # the waits lie in the gaps between calls (a window of one step, on a
    # loaded host, has no gap)
    if "batch_wait_ms.gcl" in result:
        assert got["trainer_wait_ms"] <= result["batch_wait_ms.gcl"]["value"]
    # the CPU runs no device operation: no idle split
    assert not any(k.startswith("idle_") for k in got)
    assert out["dropped"] == 0 and out["offset_ns"] is not None


def test_typed_run_counts_launches_without_a_trainer():
    out = spans.run(tiny.TYPED, 7, 0.3, "cpu", 0.0, bench=tiny.bench(),
                    overrides=tiny.OVERRIDES[tiny.TYPED])
    got = out["spans"]
    assert got["kernel_launches"] == 0.0
    assert got["prefetch_sample_ms"] is None
    assert {"step.draw", "step.forward", "step.backward",
            "step.update"} <= set(out["span_ms"])


def test_recorder_off_records_no_span():
    from biomedkg_tpu_torch.utils import profiling
    profiling.start()
    profiling.stop()
    result = tiny.run(tiny.GCL)
    assert result["correct"] is True
    assert not profiling.ON and profiling.stop() == []
    off = spans.run(tiny.GCL, 7, 0.3, "cpu", 0.0, recorder=False,
                    bench=tiny.bench(), overrides=tiny.OVERRIDES[tiny.GCL])
    assert set(off["spans"].values()) == {None}
    assert profiling.stop() == []
