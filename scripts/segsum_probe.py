#!/usr/bin/env python3
"""On-card probes of the sorted segment-sum (biomedkg_tpu_torch/csrc/segsum.cu,
ops/segsum.py), beside the checks and times chip_smoke.py makes. Run from
the repo root on a CUDA machine:

    python scripts/segsum_probe.py checks    # every instance vs plain
    python scripts/segsum_probe.py times     # every path shape, in turns
    python scripts/segsum_probe.py variants  # named edits, in turns
    python scripts/segsum_probe.py plans     # chunk geometries, in turns

``checks``: every instance that takes a call (``first``, ``packed``,
``general``) against ``segsum_plain`` off the path: d of 7, 8, 100, 256 and
257, float32 and bf16, ids ascending, ascending with -1 pads in front,
with -1 pads anywhere, in any order, above N, one hub segment over many
chunks, a run of empty ids between chunks, few rows; a base that is not
16-byte aligned; calls in turn on two streams (the barrier workspace).
``times``: the path's shapes, built as chip_smoke.py builds them (the
served full-graph "dst" batch of the PrimeKG++-scale synthetic graph, a
Stage C SAINT batch, a GRACE neighbour batch of its gene/protein graph):
the conv's (edge slots, 256) messages and the count table's (edge slots,
8) float32 one-hots into the node slots by dst. At each, which path the
kernel took (its workspace's order flag), then ``chip_smoke.segsum_times``
(against ``segsum_plain``; device times of the owner design against the
first design in turns, the fill included; the plain version, one float32
``index_add_``, the bound), and a read sweep (``data.sum()``: every data
byte read once).
``variants``: copies of segsum.cu with named edits (``VARIANTS``), built
under csrc/build/variants, each timed against the source as it stands in
turns (as built, variant, variant, as built) at the path's shapes, beside
a read yardstick (``data.sum(1)``: every byte read once); the edits match
the source text, and an edit that no longer matches stops the run.
``plans``: the owner kernel as built under other chunk counts than
``owner_plan``'s (``PLANS``), each timed against the planned one in turns.

Every timing line carries the card's name and power limit (nvidia-smi).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import re
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402
from biomedkg_tpu_torch.data.modules import PrimeKGModule  # noqa: E402
from biomedkg_tpu_torch.ops import _build, segsum  # noqa: E402
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader  # noqa: E402
from biomedkg_tpu_torch.serve import PRIMEKG_DATA  # noqa: E402

D = 256
R = 8
_PHASE_A_GAPS = """  grid_zero_rows<V>(out, 0, max(min(lo_id, n), 0), d);
  grid_zero_rows<V>(out, min(max(hi_id + 1, 0), n), n, d);
"""
# other geometries: {name: chunks against the planned count}
PLANS = {"twice the chunks": 2.0, "half the chunks": 0.5}
# named edits of segsum.cu: {variant: {old text: new text}}
VARIANTS = {
    "no prefetch": {
        "const bool loaded = ch == g0 && pass == 0;":
            "const bool loaded = false;"},
    "crossing runs stored (wrong sums)": {
        "put<V>(out + (int64_t)cur * d + c.col(j), acc[j], add);":
            "put<V>(out + (int64_t)cur * d + c.col(j), acc[j], "
            "add && !kOrdered);"},
    "no stores (wrong sums)": {
        "if (c.ok(j)) put<V>(out + (int64_t)cur * d + c.col(j), acc[j], add);":
            "if (c.ok(j) && acc[j][0] == 12345.f) "
            "put<V>(out + (int64_t)cur * d + c.col(j), acc[j], add);"},
    "bf16 sixteen rows in flight": {
        "owner_kernel<__nv_bfloat16, true, 1, 8>":
            "owner_kernel<__nv_bfloat16, true, 1, 16>"},
}


def path_shapes(dev, tmp, scale="primekg"):
    """[(name, data, ids, num_segments)] at the path's shapes (the graph
    at ``scale``, BIOMEDKG_SYNTHETIC_SCALE)."""
    os.environ["BIOMEDKG_SYNTHETIC_SCALE"] = scale
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    dm = PrimeKGModule(**dict(PRIMEKG_DATA, data_dir=os.path.join(
        tmp, "primekg")), seed=chip_smoke.SEED)
    dm.setup(stage="split")
    out = []

    def add(what, batch, dtypes):
        ids = torch.as_tensor(batch.edge_index[1]).to(dev, torch.int32)
        n = int(batch.node_mask.shape[0])
        etype = torch.as_tensor(batch.edge_type).to(dev)
        emask = torch.as_tensor(batch.edge_mask).to(dev).bool()
        for dtype in dtypes:
            data = torch.randn(ids.shape[0], D, device=dev,
                               generator=gen).to(dtype)
            out.append((f"{what} conv {str(dtype)[6:]}", data, ids, n))
        if what != "GRACE":
            out.append((f"{what} count table float32",
                        chip_smoke.count_table(etype, emask, R), ids, n))

    add("serving", FullGraphLoader(dm.graph, edge_layout="dst").batch(),
        (torch.float32,))
    dm.edge_layout = "dst"
    dm.saint_fill_target = chip_smoke.SAINT_FILL
    saint = dm.train_dataloader(loader_type="saint")
    add("Stage C", saint.sample()[0], (torch.bfloat16,))
    _, batches, _ = chip_smoke.gcl_batches(dev, tmp)
    add("GRACE", batches[0], (torch.float32, torch.bfloat16))
    return out


def held(got, data, ids, n, exact=False):
    """The largest error over SUM_RTOL (0 when ``exact``) of Σ|x| per
    element; <= 1 passes."""
    want = segsum.segsum_plain(data, ids, n)
    scale = segsum.segsum_plain(data.abs(), ids, n)
    err = (got - want).abs()
    if exact:
        return float(err.max()) / 1e-30 if float(err.max()) else 0.0
    return float((err / (chip_smoke.SUM_RTOL * scale).clamp(min=1e-30))
                 .max())


def odd_ids(kind, m, n, gen, dev, chunk=64):
    """int32 ids of one kind (see ``checks``)."""
    ids = torch.sort(torch.randint(0, n, (m,), generator=gen,
                                   device=dev)).values
    if kind == "front pads":
        ids[: m // 10] = -1
    elif kind == "pads anywhere":
        ids[torch.randperm(m, generator=gen, device=dev)[: m // 20]] = -1
    elif kind == "any order":
        ids = ids[torch.randperm(m, generator=gen, device=dev)]
    elif kind == "above N":
        ids[-m // 8:] = n + 5
        ids[m // 3] = n
    elif kind == "hub":
        ids[m // 4: m // 4 + 40 * chunk] = ids[m // 4]
        ids = torch.sort(ids).values
    elif kind == "empty run":
        ids = torch.where(ids >= n // 3, ids + n // 3, ids).clamp(max=n - 1)
        ids = torch.sort(ids).values
    return ids.int().contiguous()


ODD_KINDS = ("ascending", "front pads", "pads anywhere", "any order",
             "above N", "hub", "empty run")


def checks(dev, tmp):
    card = chip_smoke.card_line()
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    worst = 0.0
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for d in (7, 8, 100, 256, 257):
            for m, n in ((50_000, 3_000), (100, 7), (5, 3)):
                for kind in ODD_KINDS:
                    ids = odd_ids(kind, m, n, gen, dev)
                    data = torch.randn(m, d, device=dev,
                                       generator=gen).to(dtype)
                    path = segsum.segsum_instance(
                        dtype, d, data.data_ptr(), ids.data_ptr(), 0)
                    for inst in sorted({"first", "general", path}):
                        with chip_smoke.segsum_instance_as(inst):
                            got = segsum.KERNEL(data, ids, n)
                        torch.cuda.synchronize()
                        r = held(got, data, ids, n)
                        cases += 1
                        worst = max(worst, r)
                        chip_smoke.check(r <= 1.0, f"segsum {inst} {dtype} "
                                         f"d={d} m={m} n={n} {kind}: {r}")
    # count tables are exact; a base that is not 16-byte aligned
    ids = odd_ids("ascending", 50_000, 3_000, gen, dev)
    ones = (torch.rand(50_000, 8, device=dev, generator=gen) < 0.3).float()
    chip_smoke.check(held(segsum.KERNEL(ones, ids, 3_000), ones, ids, 3_000,
                          exact=True) == 0.0, "count table not exact")
    raw = torch.randn(50_000 * 256 + 1, device=dev, generator=gen)
    off = raw[1:].view(50_000, 256)
    before = segsum.KERNEL.by_instance["general"]
    chip_smoke.check(held(segsum.KERNEL(off, ids, 3_000), off, ids, 3_000)
                     <= 1.0, "misaligned base")
    chip_smoke.check(segsum.KERNEL.by_instance["general"] == before + 1,
                     "a misaligned base did not take the general instance")
    # the barrier workspace over calls, in turn on two streams
    data = torch.randn(50_000, 256, device=dev, generator=gen)
    other = torch.cuda.Stream()
    for k in range(6):
        kind = ("ascending", "any order")[k % 2]
        ids = odd_ids(kind, 50_000, 3_000, gen, dev)
        ctx = torch.cuda.stream(other) if k % 3 == 2 else \
            chip_smoke.contextlib.nullcontext()
        with ctx:
            got = segsum.KERNEL(data, ids, 3_000)
        torch.cuda.synchronize()
        chip_smoke.check(held(got, data, ids, 3_000) <= 1.0,
                         f"call {k} ({kind}) after others")
    print(f"[{card}] segsum checks: {cases} instance calls at odd shapes, "
          f"worst error {worst:.3g} of SUM_RTOL·Σ|x|; count table exact; "
          f"misaligned base on general; six calls in turn on two streams; "
          f"by instance {segsum.KERNEL.by_instance}", flush=True)


def times(dev, tmp):
    card = chip_smoke.card_line()
    for name, data, ids, n in path_shapes(dev, tmp):
        sync = segsum.KERNEL.sync(dev, torch.cuda.current_stream(
            dev).cuda_stream)
        gen = int(sync[1])
        segsum.KERNEL(data, ids, n)
        torch.cuda.synchronize()
        took = "other" if int(sync[2]) == gen + 1 else "ascending"
        print(f"[{card}] {name}: the {took} path", flush=True)
        chip_smoke.segsum_times(data, ids, n, name.rsplit(" ", 1)[0],
                                exact="count" in name)
        sweep = chip_smoke.device_ms(lambda: data.sum())
        print(f"[{card}] read sweep (data.sum()) {sweep:.4f} ms", flush=True)


def variant_library(name, edits):
    """A CudaLibrary of segsum.cu with ``edits`` applied."""
    with open(segsum.LIBRARY.source) as f:
        text = f.read()
    for old, new in edits.items():
        if old not in text:
            raise SystemExit(f"segsum_probe: variant {name!r}: no match for "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    slug = re.sub(r"[^a-z0-9]+", "_", name.lower())
    path = os.path.join(_build.BUILD_DIR, "variants", f"segsum_{slug}.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return _build.CudaLibrary(path, segsum.LIBRARY.signatures)


@contextlib.contextmanager
def on_library(lib):
    saved = segsum.LIBRARY
    segsum.LIBRARY = lib
    segsum.KERNEL._resident.clear()
    try:
        yield
    finally:
        segsum.LIBRARY = saved
        segsum.KERNEL._resident.clear()


def variants(dev, tmp):
    card = chip_smoke.card_line()
    libs = {name: variant_library(name, edits)
            for name, edits in VARIANTS.items()}
    with ThreadPoolExecutor(len(libs)) as pool:
        for future in [pool.submit(lib.lib) for lib in libs.values()]:
            future.result()
    for name, lib in libs.items():
        regs = re.findall(r"Used (\d+) registers", lib.build_log)
        spills = re.findall(r"(\d+) bytes spill stores", lib.build_log)
        print(f"variant {name!r}: registers {regs}, spill stores {spills}")
    for shape, data, ids, n in path_shapes(dev, tmp):
        yard = chip_smoke.device_ms(lambda: data.sum(1))
        nbytes = data.numel() * data.element_size()
        line = [f"read yardstick {yard:.4f} ms "
                f"({nbytes / yard / 1e9:.3f} TB/s)"]
        for name, lib in libs.items():
            def run(other):
                with on_library(lib) if other else contextlib.nullcontext():
                    return chip_smoke.device_ms(
                        lambda: segsum.KERNEL(data, ids, n))
            t = [run(other) for other in (False, True, True, False)]
            line.append(f"{name}: {t[1]:.4f} / {t[2]:.4f} against "
                        f"{t[0]:.4f} / {t[3]:.4f}")
        print(f"[{card}] segsum {shape} ({tuple(data.shape)} into {n}): "
              + "; ".join(line), flush=True)


def plan_as(factor):
    """owner_plan with ``factor`` times its chunks (rounded to whole rounds
    of rows in flight)."""
    planned = segsum.owner_plan

    def plan(instance, dtype, m, d, sms, blocks_per_sm):
        p = planned(instance, dtype, m, d, sms, blocks_per_sm)
        in_flight = segsum.OWNER_KERNELS[(instance, dtype)][3]
        rows = -(-m // max(1, round(p.chunks * factor)))
        rows = -(-rows // in_flight) * in_flight
        chunks = -(-m // rows)
        per_block = segsum.THREADS // p.group
        return segsum.Plan(p.group, rows, chunks,
                           min(sms * blocks_per_sm, -(-chunks // per_block)))
    return plan


def plans(dev, tmp):
    card = chip_smoke.card_line()
    planned = segsum.owner_plan
    for shape, data, ids, n in path_shapes(dev, tmp):
        line = []
        for name, factor in PLANS.items():
            def run(other):
                segsum.owner_plan = plan_as(factor) if other else planned
                try:
                    return chip_smoke.device_ms(
                        lambda: segsum.KERNEL(data, ids, n))
                finally:
                    segsum.owner_plan = planned
            segsum.owner_plan = plan_as(factor)
            try:
                r = held(segsum.KERNEL(data, ids, n), data, ids, n,
                         "count" in shape)
            finally:
                segsum.owner_plan = planned
            t = [run(other) for other in (False, True, True, False)]
            line.append(f"{name}: {t[1]:.4f} / {t[2]:.4f} against "
                        f"{t[0]:.4f} / {t[3]:.4f} (err {r:.3g})")
        print(f"[{card}] segsum {shape} ({tuple(data.shape)} into {n}): "
              + "; ".join(line), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("what", nargs="+",
                        choices=["checks", "times", "variants", "plans"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("segsum_probe: no CUDA device")
    dev = torch.device("cuda")
    segsum.LIBRARY.lib()
    print(segsum.LIBRARY.build_log.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for what in args.what:
            {"checks": checks, "times": times,
             "variants": variants, "plans": plans}[what](dev, tmp)


if __name__ == "__main__":
    main()
