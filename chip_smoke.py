#!/usr/bin/env python3
"""On-card check of the PyTorch port (biomedkg_tpu_torch): the KGE serving
path at full width on one CUDA card (Hopper, sm_90a).

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit:

 1. the card's name and power limit (nvidia-smi); every kernel built from
    the sources in the checkout (timed, with nvcc's ptxas report);
 2. the main path: ``KGEScorer`` over the PrimeKG++-scale synthetic graph
    (BIOMEDKG_SYNTHETIC_SCALE=primekg) with the full-width model
    (RGCN 768→256→256→256→256, 8 relations, DistMult; weights from a
    seeded torch.Generator, saved with the port's save_checkpoint), then
    requests through ``score``, ``score_many``, ``topk_tails`` and the
    ``serve`` loop, checked against a float64 host recomputation. Every
    kernel's launch count is set to 0 just before and read just after;
 3. every kernel against its plain torch version at the path's shapes,
    with CUDA-event times (median of ITERS after warm-up) of the kernel,
    the plain version and the one-call library yardstick, and the bound;
 4. the encode timed, its launch count per encode, z with the kernels
    against z with the plain versions on the card, and a small graph on
    the card against the CPU path (the path the CPU tests hold against the
    JAX package).

The second-to-last line is the ``{"kernels": [...]}`` JSON record, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.data.node_encoders import RandomEncode
from biomedkg_tpu_torch.data.synthetic import (PRIMEKG_RELATIONS,
                                               synthetic_triplets)
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.device import check_full_fp32
from biomedkg_tpu_torch.interop.jax_params import to_jax_params
from biomedkg_tpu_torch.models import encoders
from biomedkg_tpu_torch.ops import segsum
from biomedkg_tpu_torch.sampling.batch import batch_to_device
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader
from biomedkg_tpu_torch.serve import PRIMEKG_DATA, serve_loop
from biomedkg_tpu_torch.serving import KGEScorer
from biomedkg_tpu_torch.training.checkpoint import save_checkpoint
from biomedkg_tpu_torch.training.kge_module import KGEModule

SEED = 42
WARMUP, ITERS = 3, 20
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM float32, outside tensor cores
# full width: the model bench.py trains (bench.py:64)
HPARAMS = dict(
    encoder_name="rgcn", decoder_name="dismult", in_dim=768, hidden_dim=256,
    out_dim=256, num_hidden_layers=2, num_relation=len(PRIMEKG_RELATIONS),
    num_heads=2, scheduler_type="cosine", learning_rate=1e-3,
    warm_up_ratio=0.03, fuse_method="none", neg_ratio=10,
    node_init_method="random", seed=SEED)
CONVS = HPARAMS["num_hidden_layers"] + 2
SEGSUM_PER_ENCODE = 1 + CONVS    # count table + one per conv
# kernel vs plain: float32 sums differ only in order; the bound scales with
# the segment's Σ|x| (count tables sum ones: exact)
SUM_RTOL = 1e-5
Z_RTOL = 1e-4                    # through 4 convs, relative to max|z|


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg: str):
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Median CUDA-event time of ``fn`` in ms, after warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def segsum_bound_ms(data: torch.Tensor, num_segments: int):
    """Least time for one segment-sum: each input read once, the output
    written once, over HBM bandwidth; the adds over float32 peak."""
    m, d = data.shape
    nbytes = m * d * data.element_size() + 4 * m + num_segments * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = m * d / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serve_requests(scorer: KGEScorer, rng) -> dict:
    """Requests through every serving entry point, checked against a
    float64 recomputation on the host; returns their latencies."""
    g = scorer.dm.graph
    z = scorer.z.double().cpu().numpy()
    rel_emb = scorer.decoder.rel_emb.detach().double().cpu().numpy()
    pick = rng.choice(g.num_edges, 1000, replace=False)
    heads, tails = g.edge_index[0, pick], g.edge_index[1, pick]
    rels = g.edge_type[pick]
    triples = [(scorer.id_to_name[int(h)], scorer.dm.edge_map_index[int(r)],
                scorer.id_to_name[int(t)])
               for h, r, t in zip(heads, rels, tails)]
    want = 1.0 / (1.0 + np.exp(-np.sum(z[heads] * rel_emb[rels] * z[tails],
                                       axis=1)))
    lat = {}

    t0 = time.perf_counter()
    singles = [scorer.score(*t) for t in triples[:8]]
    lat["score_ms"] = (time.perf_counter() - t0) * 1e3 / 8
    t0 = time.perf_counter()
    many = np.asarray(scorer.score_many(triples))
    lat["score_many_1000_ms"] = (time.perf_counter() - t0) * 1e3
    check(many.shape == (1000,) and np.all(np.isfinite(many)),
          "score_many: shape / finiteness")
    err = float(np.max(np.abs(many - want)))
    print(f"score_many vs float64 host: max_abs_err={err:.3g} (tol 1e-5)")
    check(err <= 1e-5, "score_many disagrees with the host recomputation")
    check(np.allclose(singles, many[:8], rtol=0, atol=1e-6),
          "score disagrees with score_many")

    ntype = np.asarray(scorer.dm.data.node_type_of)
    for h, r, name_h, rel in zip(heads[:4], rels[:4],
                                 [t[0] for t in triples[:4]],
                                 [t[1] for t in triples[:4]]):
        t0 = time.perf_counter()
        top = scorer.topk_tails(name_h, rel, k=10)
        lat.setdefault("topk10_ms", []).append(
            (time.perf_counter() - t0) * 1e3)
        probs = np.array([p for _, p in top])
        check(len(top) == 10, f"topk_tails({name_h}, {rel}): {len(top)}")
        check(np.all(np.isfinite(probs)) and np.all(np.diff(probs) <= 0),
              "topk_tails: not finite / not sorted")
        allowed = np.unique(ntype[g.edge_index[1][g.edge_type == r]])
        ids = [scorer.name_to_id[n] for n, _ in top]
        check(int(h) not in ids, "topk_tails returned the head")
        check(np.all(np.isin(ntype[ids], allowed)),
              "topk_tails returned a node of a tail type never observed")
        host = 1.0 / (1.0 + np.exp(-(z[h] * rel_emb[r]) @ z.T))
        host[~np.isin(ntype, allowed)] = -np.inf
        host[h] = -np.inf
        check(np.allclose(np.sort(host)[::-1][:10], probs, rtol=0,
                          atol=1e-5),
              "topk_tails values disagree with the host top-10")

    rel_cli = next(n for n in scorer.rel_to_id if " " not in n)
    rid = scorer.rel_to_id[rel_cli]
    e = int(np.flatnonzero(g.edge_type == rid)[0])
    h_cli = scorer.id_to_name[int(g.edge_index[0, e])]
    t_cli = scorer.id_to_name[int(g.edge_index[1, e])]
    out = io.StringIO()
    serve_loop(scorer, [f"score {h_cli} {rel_cli} {t_cli}",
                        f"topk {h_cli} {rel_cli} 3", "score nobody x y",
                        f"topk {h_cli} {rel_cli} zero", "hello", "quit",
                        f"score {h_cli} {rel_cli} {t_cli}"], out)
    lines = out.getvalue().splitlines()
    print("serve loop:", " | ".join(lines))
    check(len(lines) == 1 + 1 + 3 + 3, "serve loop: wrong number of lines")
    check(lines[1] == f"{scorer.score(h_cli, rel_cli, t_cli):.6f}",
          "serve loop: score line")
    check(lines[5].startswith("error:") and lines[6].startswith("error:")
          and lines[7] == "unrecognized command", "serve loop: error lines")
    return lat


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    check_full_fp32()
    dev = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build every kernel from the checkout --------------------------
    t0 = time.perf_counter()
    segsum.KERNEL.lib()
    print(f"build: {segsum.SOURCE} → {segsum.KERNEL.library_path} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(segsum.NVCC_FLAGS)})")
    print(segsum.KERNEL.build_log.strip())

    with tempfile.TemporaryDirectory() as tmp:
        # -- 2. the main path ---------------------------------------------
        os.environ["BIOMEDKG_SYNTHETIC_SCALE"] = "primekg"
        gen = torch.Generator().manual_seed(SEED)
        module = KGEModule(**HPARAMS)
        module.init(gen)
        ckpt = os.path.join(tmp, "kge.ckpt")
        save_checkpoint(ckpt, "kge", module.hparams,
                        to_jax_params(module.model))
        data = dict(PRIMEKG_DATA, data_dir=os.path.join(tmp, "primekg"))
        dm = PrimeKGModule(**data, seed=SEED)

        torch.cuda.reset_peak_memory_stats()
        segsum.KERNEL.launches = 0
        t0 = time.perf_counter()
        scorer = KGEScorer(ckpt, dm, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        lat = serve_requests(scorer, np.random.default_rng(SEED))
        torch.cuda.synchronize()
        launches = {"sorted_segment_sum": segsum.KERNEL.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        g = dm.graph
        print(f"main path: graph {g.num_nodes} nodes, {g.num_edges} edges, "
              f"{g.num_relations} relations; KGEScorer init {t_init:.2f} s "
              f"(data build + encode); requests {json.dumps(lat)}; "
              f"peak device memory {peak_gb:.2f} GB; launches {launches}")
        check(g.num_nodes > 50_000 and g.num_edges > 1_000_000,
              "not the PrimeKG++-scale graph")
        check(launches["sorted_segment_sum"] == SEGSUM_PER_ENCODE,
              f"segsum launches on the main path: {launches}")

    # -- 3. kernel vs plain version at the path's shapes ------------------
    batch = FullGraphLoader(g, edge_layout="dst").batch()
    num_nodes = batch.num_nodes
    dst = torch.as_tensor(batch.edge_index[1]).to(dev, torch.int32)
    etype = torch.as_tensor(batch.edge_type).to(dev, torch.int64)
    emask = torch.as_tensor(batch.edge_mask).to(dev)
    m = dst.shape[0]
    cuda_gen = torch.Generator(device=dev).manual_seed(SEED)
    conv = torch.randn(m, HPARAMS["hidden_dim"], device=dev,
                       generator=cuda_gen)
    counts = ((etype[:, None] == torch.arange(HPARAMS["num_relation"],
                                              device=dev)[None, :])
              & emask[:, None]).float()
    perm = torch.randperm(m, device=dev, generator=cuda_gen)
    pads = dst.clone()
    pads[torch.randperm(m, device=dev, generator=cuda_gen)[: m // 100]] = -1
    pads[~emask] = -1
    cases = [
        ("conv f32", conv, dst),
        ("count table f32", counts, dst),
        ("conv bf16", conv.bfloat16(), dst),
        ("conv f32 unsorted", conv[perm].contiguous(), dst[perm].contiguous()),
        ("conv f32 -1 pads", conv, pads),
    ]
    results = {}
    for name, data_t, ids in cases:
        got = segsum.KERNEL(data_t, ids, num_nodes)
        want = segsum.segsum_plain(data_t, ids, num_nodes)
        torch.cuda.synchronize()
        err = (got - want).abs()
        scale = segsum.segsum_plain(data_t.abs(), ids, num_nodes)
        tol = 0.0 if name.startswith("count") else SUM_RTOL
        ok = bool(torch.all(err <= tol * scale))
        max_err = float(err.max())
        print(f"segsum {name}: data {tuple(data_t.shape)} "
              f"{str(data_t.dtype)[6:]}, {num_nodes} segments: "
              f"max_abs_err={max_err:.3g}, tol {tol:g}·Σ|x| per segment, "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"segsum kernel disagrees with its plain version ({name})")
        results[name] = max_err

    ids64 = dst.long()
    timed = {}
    for name, data_t in (("conv f32", conv), ("count table f32", counts)):
        yard = torch.zeros(num_nodes, data_t.shape[1], device=dev)
        ms = time_ms(lambda: segsum.KERNEL(data_t, dst, num_nodes))
        plain_ms = time_ms(lambda: segsum.segsum_plain(data_t, dst,
                                                       num_nodes))
        lib_ms = time_ms(lambda: yard.index_add_(0, ids64, data_t))
        bound_ms, bound_by = segsum_bound_ms(data_t, num_nodes)
        timed[name] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
        print(f"segsum {name} time: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}), kernel at "
              f"{bound_ms / ms:.1%} of bound")

    # -- 4. the encode: time, launches, kernels vs plain versions ---------
    dev_batch = batch_to_device(batch, dev)
    segsum.KERNEL.launches = 0
    enc_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = scorer.module.encode(dev_batch)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    check(segsum.KERNEL.launches == 3 * SEGSUM_PER_ENCODE,
          f"segsum launches per encode: {segsum.KERNEL.launches / 3}")
    encoders.sorted_segment_sum = segsum.segsum_plain
    try:
        plain_enc_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            z_plain = scorer.module.encode(dev_batch)
            torch.cuda.synchronize()
            plain_enc_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        encoders.sorted_segment_sum = segsum.sorted_segment_sum
    print(f"encode with the plain segment-sum: {plain_enc_ms} ms")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        scorer.module.encode(dev_batch)
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"encode device kernels (torch.profiler): {busy:.3f} ms busy; "
          + "; ".join(f"{e.key[:70]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms"
                      for e in kernels[:10]))
    scale = float(z_plain.abs().max())
    z_err = float((z - z_plain).abs().max())
    print(f"encode: {enc_ms} ms (host clock, synchronised); "
          f"{SEGSUM_PER_ENCODE} segsum launches per encode; z "
          f"{tuple(z.shape)} finite={bool(torch.isfinite(z).all())}; "
          f"kernel vs plain max_abs_err={z_err:.3g} "
          f"(tol {Z_RTOL:g}·max|z| = {Z_RTOL * scale:.3g})")
    check(bool(torch.isfinite(z).all()), "z not finite")
    check(z_err <= Z_RTOL * scale, "z with kernels disagrees with plain")
    n = g.num_nodes
    check(float((z[:n] - scorer.z).abs().max()) <= Z_RTOL * scale,
          "re-encode disagrees with the scorer's z")

    small_tg = TripletGraph(synthetic_triplets(seed=SEED),
                            encoder=RandomEncode(32))
    small = KGEModule(**dict(HPARAMS, in_dim=32, hidden_dim=32, out_dim=32,
                             num_relation=small_tg.num_edge_types))
    small.init(torch.Generator().manual_seed(SEED))
    small.edge_layout = "dst"
    small_batch = FullGraphLoader(small_tg.graph, edge_layout="dst").batch()
    z_cpu = small.encode(batch_to_device(small_batch, "cpu"))
    z_gpu = small.to(dev).encode(batch_to_device(small_batch, dev)).cpu()
    small_err = float((z_gpu - z_cpu).abs().max())
    small_scale = float(z_cpu.abs().max())
    print(f"small graph card vs cpu: max_abs_err={small_err:.3g} "
          f"(tol {Z_RTOL:g}·max|z| = {Z_RTOL * small_scale:.3g})")
    check(small_err <= Z_RTOL * small_scale,
          "small graph: card disagrees with the CPU path")

    ms, plain_ms, lib_ms, bound_ms, bound_by = timed["conv f32"]
    print(json.dumps({"kernels": [{
        "name": "sorted_segment_sum", "route": "cuda",
        "source": "biomedkg_tpu_torch/csrc/segsum.cu",
        "replaces": "biomedkg_tpu/ops/pallas/segsum.py:74",
        "launches": launches["sorted_segment_sum"],
        "max_abs_err": max(results.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
