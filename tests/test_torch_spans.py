"""The span recorder of ``utils/profiling.py`` on the CPU: off it is the
shared no-op and reads no clock; nesting gives parent and step ids; the
buffer is bounded; in a tiny ``Trainer.fit`` each batch's
``prefetch.sample`` (on the prefetch thread) carries the id of the
``trainer.step`` that trains it, with the step's, the wait's and the
copy's spans around; the samplers' phases; the spans' twins under
``torch.profiler`` place every span on the trace's clock (within 50 µs of
its twin); counter deltas land on the enclosing spans; and ``trace()``
writes the worker thread's spans into its ``trace.json``."""

import json
import queue
import threading
import time

import numpy as np
import pytest
import torch

from biomedkg_tpu_torch.ops import flashnce, negscore, segsum
from biomedkg_tpu_torch.sampling.batch import pad_graph_batch
from biomedkg_tpu_torch.sampling.csr import CSRGraph
from biomedkg_tpu_torch.sampling.neighbor import NeighborBatchLoader
from biomedkg_tpu_torch.sampling.saint import SaintRandomWalkSampler
from biomedkg_tpu_torch.training.kge_module import KGEModule
from biomedkg_tpu_torch.training.trainer import Trainer
from biomedkg_tpu_torch.utils import profiling

N_REAL, R, D = 40, 4, 16
MAPPING = {i: f"rel{i}" for i in range(R)}


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.start()      # cleared
    profiling.stop()
    yield
    profiling.stop()


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_span_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    def clock():
        raise AssertionError("the clock was read")

    monkeypatch.setattr(profiling, "_clock", clock)
    assert not profiling.ON
    sp = profiling.span("trainer.step", step=3,
                        counters=(profiling.LAUNCHES,))
    assert sp is profiling.NO_SPAN
    with sp as inside:
        assert inside is profiling.NO_SPAN
    profiling.count("rows", 5)
    assert profiling.stop() == []


def test_nesting_gives_parent_and_step_ids():
    profiling.start()
    with profiling.span("outer", step=3) as a:
        with profiling.span("middle") as b:
            with profiling.span("inner", step=9) as c:
                pass
        with profiling.span("sibling"):
            pass
    with profiling.span("top"):
        pass
    spans = {s.name: s for s in profiling.stop()}
    assert spans["outer"].parent is None and spans["top"].parent is None
    assert spans["middle"].parent == a.id == spans["outer"].id
    assert spans["inner"].parent == b.id
    assert spans["sibling"].parent == a.id
    assert c.id == spans["inner"].id
    assert [spans[n].step for n in ("outer", "middle", "inner", "sibling",
                                    "top")] == [3, 3, 9, 3, None]
    for s in spans.values():
        assert s.thread == threading.get_native_id()
        assert s.start_ns <= s.end_ns
    assert spans["outer"].start_ns <= spans["middle"].start_ns \
        <= spans["inner"].start_ns <= spans["inner"].end_ns \
        <= spans["middle"].end_ns <= spans["outer"].end_ns


def test_the_buffer_keeps_the_first_spans_and_counts_the_rest():
    profiling.start(capacity=2)
    for name in ("a", "b", "c"):
        with profiling.span(name):
            pass
    assert [s.name for s in profiling.stop()] == ["a", "b"]
    assert profiling.dropped() == 1
    with profiling.span("after"):
        pass
    assert [s.name for s in profiling.stop()] == ["a", "b"]


def test_flash_tally_is_read_at_stop_only(monkeypatch):
    """The flash backward's device tally: start() clears it, nothing reads
    it while the recorder runs, stop() adds it to the counters once (a
    tensor on the CPU stands in for the card's), and a stop() with the
    recorder off adds nothing."""
    tally = torch.tensor([9, 9, 9])
    monkeypatch.setattr(flashnce.BACKWARD, "tallies",
                        {torch.device("cpu"): tally})
    profiling.start()
    assert tally.tolist() == [0, 0, 0]
    profiling.count("rows", 5)
    tally += torch.tensor([546, 18, 132])    # one launch's adds
    tally += torch.tensor([546, 18, 132])
    assert profiling.counters() == {"rows": 5}
    profiling.stop()
    assert profiling.counters() == {
        "rows": 5, "flash_bwd_items": 1092, "flash_bwd_cut": 36,
        "flash_bwd_slices": 264}
    tally += 1
    profiling.stop()
    assert profiling.counters()["flash_bwd_items"] == 1092
    monkeypatch.setattr(flashnce.BACKWARD, "tallies", {})
    profiling.start()
    profiling.stop()
    assert profiling.counters() == {}


def _batch(epoch, i):
    rng = np.random.default_rng((epoch, i))
    x = np.random.default_rng(0).standard_normal((N_REAL, D)).astype(
        np.float32)
    n = int(rng.integers(150, 200))
    return pad_graph_batch(x, rng.integers(0, N_REAL, (2, n)),
                           rng.integers(0, R, n), num_relations=R,
                           node_budget=64, edge_budget=256, block_size=32,
                           num_seed=N_REAL, layout="dst")


class _Loader:
    def __init__(self, steps):
        self.steps, self.epoch = steps, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        for i in range(self.steps):
            yield _batch(self.epoch, i)

    def __len__(self):
        return self.steps


def test_fit_links_each_batch_to_the_step_that_trains_it():
    module = KGEModule(
        encoder_name="rgcn", decoder_name="dismult", in_dim=D,
        hidden_dim=D, out_dim=D, num_hidden_layers=1, num_relation=R,
        num_heads=2, scheduler_type="cosine", learning_rate=1e-3,
        warm_up_ratio=0.2, fuse_method="none", neg_ratio=3,
        node_init_method="random")
    module.edge_layout = "dst"
    module.edge_mapping = MAPPING
    trainer = Trainer(max_epochs=2, enable_progress_bar=False,
                      enable_checkpointing=False, steps_per_execution=2)
    profiling.start()
    trainer.fit(module, _Loader(3))
    spans = profiling.stop()
    main = threading.get_native_id()
    steps = _by_name(spans, "trainer.step")
    assert [s.step for s in steps] == list(range(6))
    assert {s.thread for s in steps} == {main}
    samples = {s.step: s for s in _by_name(spans, "prefetch.sample")
               if s.step is not None}
    assert sorted(samples) == list(range(6))
    for s in steps:
        sample = samples[s.step]
        assert sample.thread != main
        assert sample.end_ns <= s.start_ns
        assert sample.counts["rows"] == N_REAL
        assert 150 <= sample.counts["edges"] <= 200
        assert s.counts == {profiling.LAUNCHES: 0}   # none on the CPU
        kids = [k for k in spans if k.parent == s.id]
        assert [k.name for k in kids] == ["step.forward", "step.backward",
                                          "step.update"]
        assert all(k.step == s.step for k in kids)
    # each epoch's loader end is sampled in a span of no step
    assert len(_by_name(spans, "prefetch.sample")) == 6 + 2
    copies = _by_name(spans, "prefetch.copy")
    assert len(copies) == 4 and all(c.thread != main for c in copies)
    assert all(c.counts["bytes"] > 0 for c in copies)
    waits = _by_name(spans, "trainer.wait")
    assert waits and all(w.thread == main for w in waits)


def _graph(n=300, e=3000, seed=0):
    rng = np.random.default_rng(seed)
    return CSRGraph(num_nodes=n, edge_index=rng.integers(0, n, (2, e)),
                    edge_type=rng.integers(0, R, e).astype(np.int32),
                    num_relations=R)


@pytest.mark.parametrize("loader,phases", [
    (lambda g: NeighborBatchLoader(g, 16, [5, 5], with_features=False,
                                   edge_layout="dst"),
     ["sample.hops", "sample.pad"]),
    (lambda g: SaintRandomWalkSampler(g, 16, 3, 2, with_features=False,
                                      edge_layout="dst"),
     ["sample.walk", "sample.induce", "sample.pad"])])
def test_samplers_record_their_phases(loader, phases):
    batches = loader(_graph())
    profiling.start()
    with profiling.span("prefetch.sample", step=7) as outer:
        next(iter(batches))
    spans = profiling.stop()
    kids = [s for s in spans if s.parent == outer.id]
    assert [s.name for s in kids] == phases
    assert all(s.step == 7 for s in kids)


def _annotations(events, names):
    return [(e.name, e.time_range.start, e.time_range.end) for e in events
            if e.name in names and getattr(e, "is_user_annotation", False)]


def test_twins_place_every_span_on_the_trace_clock():
    # a worker thread started before the session and fed by a queue, as
    # the Trainer's prefetch thread is
    todo, done = queue.Queue(), queue.Queue()

    def worker():
        while todo.get():
            with profiling.span("prefetch.sample"):
                time.sleep(0.002)
            done.put(True)

    profiling.start()
    thread = threading.Thread(target=worker)
    thread.start()
    with profiling.span("before"):      # no twin: no profiler yet
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # the profiler's first range of a session opens slowly (~0.1 ms
        # on the CPU): it is not a span's
        with torch.profiler.record_function("session start"):
            pass
        for i in range(5):
            with profiling.span("trainer.step", step=i):
                with profiling.span("step.forward"):
                    torch.ones(64, 64).sum()
                    time.sleep(0.001)
            todo.put(True)
            done.get()
    todo.put(False)
    thread.join()
    spans = profiling.stop()
    events = prof.events()
    twins = _annotations(events, {"trainer.step", "step.forward"})
    assert len(twins) == 10
    assert not _by_name(spans, "before")[0].twin
    offset = profiling.clock_offset_ns(spans, twins)
    assert offset is not None
    for name in ("trainer.step", "step.forward"):
        mine = sorted(_by_name(spans, name), key=lambda s: s.start_ns)
        theirs = sorted(t for t in twins if t[0] == name)
        theirs.sort(key=lambda t: t[1])
        assert len(mine) == len(theirs) == 5
        for s, (_, a, b) in zip(mine, theirs):
            assert s.twin
            assert abs((s.start_ns + offset) / 1e3 - a) <= 50
            assert abs((s.end_ns + offset) / 1e3 - b) <= 50
    # each worker span runs between two steps: it lands between their
    # twins
    steps = sorted(t for t in twins if t[0] == "trainer.step")
    steps.sort(key=lambda t: t[1])
    work = sorted(_by_name(spans, "prefetch.sample"),
                  key=lambda s: s.start_ns)
    assert len(work) == 5
    for i, s in enumerate(work):
        assert not s.twin and s.thread != threading.get_native_id()
        a, b = (s.start_ns + offset) / 1e3, (s.end_ns + offset) / 1e3
        assert steps[i][2] <= a <= b
        if i + 1 < len(steps):
            assert b <= steps[i + 1][1]


def test_counter_deltas_land_on_the_enclosing_spans(monkeypatch):
    monkeypatch.setattr(segsum.KERNEL, "launches", 0)
    monkeypatch.setattr(negscore.BUCKETS, "launches", 0)
    bwd = flashnce.KERNELS["flash_denom_bwd"]
    monkeypatch.setattr(bwd, "launches", 0)

    def backward_thread():   # as autograd's thread launches a backward
        bwd.launches += 2
        negscore.BUCKETS.launches += 1

    counted = (profiling.LAUNCHES,)
    profiling.start()
    with profiling.span("trainer.step", counters=counted):
        with profiling.span("step.forward", counters=counted):
            segsum.KERNEL.launches += 8
        with profiling.span("step.backward", counters=counted):
            thread = threading.Thread(target=backward_thread)
            thread.start()
            thread.join()
        with profiling.span("step.update", counters=counted):
            pass
        with profiling.span("prefetch.copy", counters=("bytes",)):
            profiling.count("bytes", 100)
            profiling.count("bytes", 28)
    got = {s.name: s.counts for s in profiling.stop()}
    assert got == {"step.forward": {profiling.LAUNCHES: 8},
                   "step.backward": {profiling.LAUNCHES: 3},
                   "step.update": {profiling.LAUNCHES: 0},
                   "prefetch.copy": {"bytes": 128},
                   "trainer.step": {profiling.LAUNCHES: 11}}
    assert profiling.kernel_launches() == 11


def test_trace_json_holds_the_worker_threads_spans(tmp_path):
    ids = {}

    def worker():
        ids["worker"] = threading.get_native_id()
        with profiling.span("prefetch.copy", step=0):
            time.sleep(0.001)

    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("trainer.step", step=0):
            thread = threading.Thread(target=worker)
            thread.start()
            thread.join()
            torch.ones(8).sum()
    assert not profiling.ON
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert {(e["name"], e["tid"]) for e in spans} == {
        ("trainer.step", threading.get_native_id()),
        ("prefetch.copy", ids["worker"])}
    assert all(e["args"]["step"] == 0 for e in spans)
    twin = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == "trainer.step"]
    mine = [e for e in spans if e["name"] == "trainer.step"]
    assert len(twin) == len(mine) == 1
    assert abs(twin[0]["ts"] - mine[0]["ts"]) <= 50
    copy = [e for e in spans if e["name"] == "prefetch.copy"][0]
    assert mine[0]["ts"] <= copy["ts"] <= copy["ts"] + copy["dur"] \
        <= mine[0]["ts"] + mine[0]["dur"] + 50
    names = {e["tid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("pid") == "spans"}
    assert set(names) == {threading.get_native_id(), ids["worker"]}
