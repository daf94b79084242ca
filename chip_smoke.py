#!/usr/bin/env python3
"""On-card check of the PyTorch port (biomedkg_tpu_torch): the KGE serving
path and the KGE training step at full width on one CUDA card (Hopper,
sm_90a).

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit:

 1. the card's name and power limit (nvidia-smi); every kernel built from
    the sources in the checkout, one nvcc per source, all started together
    (timed, with nvcc's ptxas report), and the host sampler's g++ build;
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
    JAX package);
 5. the training main path: the KGE training step on GraphSAINT batches of
    the same graph (128 roots, walk 10, fill 0.92, dst layout, block 256,
    device-resident features), RGCN 768→256×4 + DistMult, K = 10 sorted
    negatives, bf16 compute with float32 masters, Adam + cosine warm-up +
    clip 1.0. Warm-up steps, then TRAIN_STEPS timed steps (host clock after
    a synchronise, and CUDA events) with every kernel's launch count set to
    0 just before and read just after; ms per step, triplets per second,
    the envelope, peak memory and a torch.profiler breakdown of PROFILED
    steps with its idle share;
    one batch's loss and every gradient with the kernels against the same
    step with the plain versions (bf16 and float32); the negscore kernels
    and the segsum kernel against their plain versions at the path's
    shapes, timed beside their bounds; the loss falling on a fixed batch;
    ``python -m biomedkg_tpu_torch.train_kge`` for a few steps on the card
    on the same PrimeKG++-scale graph and its checkpoint served by
    ``KGEScorer``.

The second-to-last line is the ``{"kernels": [...]}`` JSON record, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.data.node_encoders import RandomEncode
from biomedkg_tpu_torch.data.synthetic import (PRIMEKG_RELATIONS,
                                               synthetic_triplets)
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.device import check_full_fp32
from biomedkg_tpu_torch.interop.jax_params import to_jax_params
from biomedkg_tpu_torch.models import decoders, encoders
from biomedkg_tpu_torch.nn import dropout_mask
from biomedkg_tpu_torch.ops import _build, negscore, segment, segsum
from biomedkg_tpu_torch.sampling import native
from biomedkg_tpu_torch.sampling.batch import batch_to_device
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader
from biomedkg_tpu_torch.serve import PRIMEKG_DATA, serve_loop
from biomedkg_tpu_torch.serving import KGEScorer
from biomedkg_tpu_torch.training.checkpoint import save_checkpoint
from biomedkg_tpu_torch.training.kge_module import (KGEModule, _mix_factor,
                                                    rolled_index,
                                                    sample_negatives_sorted)

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

# -- the training main path (bench.py:64-68,108-121; train_kge.py:50-67) --
TRAIN = dict(HPARAMS, warm_up_ratio=0.2, compute_dtype="bfloat16")
SAINT_FILL = 0.92
TRAIN_WARMUP, TRAIN_STEPS, PROFILED = 3, 10, 3
SEGSUM_PER_STEP = SEGSUM_PER_ENCODE + 1   # + the positive tail gather's bwd
# one training step, kernels against plain versions, in the working type:
# bf16 as tests/test_ops.py holds the JAX kernel (loss 1e-3 relative,
# gradients 3e-2 of their max); float32 loss 1e-5, gradients 5e-4 of max
STEP_TOL = {torch.bfloat16: (1e-3, 3e-2), torch.float32: (1e-5, 5e-4)}
# negscore kernels against the plain version at the path's shapes (scores,
# dz, d(rel_emb)): bf16 relative to the plain result's max, as the CPU
# tests (values 2e-2, gradients 3e-2); float32 sums differ only in order,
# so each element within SUM_RTOL of the sum of its terms' magnitudes
# (d(rel_emb) sums ~51k signed terms per relation: relative to its max the
# cancellation alone reaches 1e-5)
NEG_TOL_BF16 = (2e-2, 3e-2)


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


def negscore_bound_ms(z, m, r, backward: bool):
    """Least time for one negscore call: the z table, three int32 index
    arrays, the relation table and the scores (plus ds in, dz and dre out
    backward) moved once over HBM bandwidth; 3 (forward) or 8 (backward)
    float32 operations per slot and feature over the float32 peak."""
    n, d = z.shape
    nbytes = n * d * z.element_size() + 3 * 4 * m + r * d * 4 + 4 * m
    if backward:
        nbytes += n * d * 4 + r * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (8 if backward else 3) * m * d / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def launch_counts() -> dict:
    return {"sorted_segment_sum": segsum.KERNEL.launches,
            "distmult_neg_scores": negscore.FORWARD.launches,
            "distmult_neg_scores_bwd": negscore.BACKWARD.launches}


def reset_launch_counts():
    segsum.KERNEL.launches = 0
    negscore.FORWARD.launches = 0
    negscore.BACKWARD.launches = 0


@contextlib.contextmanager
def plain_versions():
    """The model with every kernel swapped for its plain torch version
    (the segment-sums of the encoder and of the tail gather's backward,
    and the negative scoring)."""
    saved = (encoders.sorted_segment_sum, segment.sorted_segment_sum,
             decoders.distmult_neg_scores)
    encoders.sorted_segment_sum = segsum.segsum_plain
    segment.sorted_segment_sum = segsum.segsum_plain
    decoders.distmult_neg_scores = negscore.distmult_neg_scores_plain
    try:
        yield
    finally:
        (encoders.sorted_segment_sum, segment.sorted_segment_sum,
         decoders.distmult_neg_scores) = saved


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


def fixed_draws(module, batch, gen):
    """One set of sorted negatives and dropout keep masks for ``batch``."""
    num_edges = batch.edge_type.shape[0]
    nreal = batch.node_mask.sum().clamp(min=1)
    negatives = sample_negatives_sorted(gen, module.neg_ratio, num_edges,
                                        nreal)
    n = batch.node_mask.shape[0]
    masks = [dropout_mask((n, dout), encoders.RGCN.DROPOUT, gen, gen.device)
             for _, dout in module.model.encoder.dims[:-1]]
    return negatives, masks


def step_grads(module, batch, negatives, masks):
    """The loss and every gradient of one training step."""
    loss, _ = module._forward_loss(batch, True, negatives=negatives,
                                   dropout_masks=masks)
    grads = torch.autograd.grad(loss, list(module.parameters()))
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def train_module(sd, feature_table, dev, **over) -> KGEModule:
    module = KGEModule(**dict(TRAIN, **over))
    module.load_state_dict(sd)
    module.to(dev)
    module.edge_layout = "dst"
    module.feature_table = feature_table
    return module


def train_phase(dm, dev):
    """Phase 5; returns the negscore kernels' records and the segsum
    kernel's launches on this path."""
    k = TRAIN["neg_ratio"]
    dm.edge_layout = "dst"
    dm.device_features = True
    dm.saint_fill_target = SAINT_FILL
    loader = dm.train_dataloader(loader_type="saint")
    t0 = time.perf_counter()
    host = [loader.sample()[0] for _ in range(TRAIN_WARMUP + TRAIN_STEPS)]
    sample_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    batches = [batch_to_device(b, dev) for b in host]
    real_edges = [int(b.edge_mask.sum()) for b in host[TRAIN_WARMUP:]]
    m = k * loader.edge_budget
    occupancy = sum(real_edges) / (TRAIN_STEPS * loader.edge_budget)
    print(f"train envelope: {loader.node_budget} node slots, "
          f"{loader.edge_budget} edge slots, K·E = {m} negative slots; "
          f"edge occupancy {occupancy:.4f}; host SAINT sampling "
          f"{sample_ms:.1f} ms per batch")

    module = KGEModule(**TRAIN).to(dev)
    module.edge_layout = "dst"
    module.set_feature_table(dm.graph.x)
    module.configure_optimizers(num_training_steps=100)
    state = module.init_state(torch.Generator().manual_seed(SEED))
    sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state, logs = module.train_steps(state, batches[:TRAIN_WARMUP], gen)
    torch.cuda.synchronize()

    # -- the main path: TRAIN_STEPS steps, launches counted ---------------
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    state, logs = module.train_steps(state, batches[TRAIN_WARMUP:], gen)
    end.record()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    event_ms = start.elapsed_time(end) / TRAIN_STEPS
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(logs["train_loss"])
    rate = sum(real_edges) * (1 + k) / (step_ms * TRAIN_STEPS / 1e3)
    print(f"train step: {step_ms:.3f} ms per step (host clock), "
          f"{event_ms:.3f} ms (CUDA events), {rate:.4g} triplets/s "
          f"(real edges x (1 + K) per step, bench.py:167); peak device "
          f"memory {peak_gb:.3f} GB, of which {resident_gb:.3f} GB was "
          f"allocated before the steps (the serving phases' tensors, the "
          f"batches, weights and optimizer state); last loss {loss:.6f}; "
          f"launches over "
          f"{TRAIN_STEPS} steps {launches}")
    check(np.isfinite(loss), "training loss not finite")
    check(launches == {"sorted_segment_sum": SEGSUM_PER_STEP * TRAIN_STEPS,
                       "distmult_neg_scores": TRAIN_STEPS,
                       "distmult_neg_scores_bwd": TRAIN_STEPS},
          f"launches per step on the training path: {launches}")

    # busy and wall time from the same profiled window of PROFILED steps
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        start.record()
        module.train_steps(state, batches[-PROFILED:], gen)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / PROFILED
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / PROFILED
    print(f"train step device kernels (torch.profiler, {PROFILED} steps, "
          f"per step): {busy:.3f} ms busy of {wall:.3f} ms wall (CUDA "
          f"events in the same profiled window; idle share "
          f"{1 - busy / wall:.3f}), "
          f"{sum(e.count for e in kernels) / PROFILED:g} kernels; "
          + "; ".join(f"{e.key[:60]} x{e.count / PROFILED:g} "
                      f"{e.self_device_time_total / 1e3 / PROFILED:.3f} ms"
                      for e in kernels[:15]))
    host_ops = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
    print("train step host ops (torch.profiler, self CPU ms per step, "
          "profiled): "
          + "; ".join(f"{e.key[:40]} x{e.count / PROFILED:g} "
                      f"{e.self_cpu_time_total / 1e3 / PROFILED:.3f}"
                      for e in host_ops[:12]))

    # -- one step: kernels against the plain versions ---------------------
    batch = batches[0]
    for dtype in (torch.bfloat16, torch.float32):
        step = train_module(sd, module.feature_table, dev,
                            compute_dtype=str(dtype)[6:])
        draws = fixed_draws(step, batch,
                            torch.Generator(device=dev).manual_seed(SEED + 1))
        reset_launch_counts()
        loss_k, grads_k = step_grads(step, batch, *draws)
        used = launch_counts()
        reset_launch_counts()
        with plain_versions():
            loss_p, grads_p = step_grads(step, batch, *draws)
        check(not any(launch_counts().values()),
              "the plain versions launched a kernel")
        check(used == {"sorted_segment_sum": SEGSUM_PER_STEP,
                       "distmult_neg_scores": 1,
                       "distmult_neg_scores_bwd": 1},
              f"launches in one step: {used}")
        loss_tol, grad_tol = STEP_TOL[dtype]
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        errs = {n: rel_err(a, b) for (n, _), a, b in
                zip(step.named_parameters(), grads_k, grads_p)}
        worst = max(errs, key=errs.get)
        print(f"train step {str(dtype)[6:]}, kernels vs plain: loss "
              f"{loss_k:.7f} vs {loss_p:.7f} (rel {loss_err:.3g}, tol "
              f"{loss_tol:g}); gradients max rel-to-max {errs[worst]:.3g} "
              f"({worst}; tol {grad_tol:g})")
        check(loss_err <= loss_tol, f"{dtype} step: loss disagrees")
        check(errs[worst] <= grad_tol, f"{dtype} step: {worst} disagrees")

    # -- the negscore kernels against the plain version -------------------
    with torch.no_grad():
        z = module.model.encoder(
            module._batch_features(batch), batch.edge_index,
            batch.edge_type, batch.edge_mask,
            compute_dtype=torch.bfloat16).float()
    num_edges = batch.edge_type.shape[0]
    ns, nd, off = sample_negatives_sorted(
        gen, k, num_edges, batch.node_mask.sum().clamp(min=1))
    rel = batch.edge_type[rolled_index(off, num_edges,
                                       _mix_factor(num_edges))].int()
    rel_emb = module.model.decoder.rel_emb.detach()
    ds = torch.randn(m, generator=gen, device=dev)
    err = {}
    for dtype in (torch.bfloat16, torch.float32):
        zt = z.to(dtype).contiguous()
        re = negscore.relation_table(rel_emb, dtype)
        s_k = negscore.FORWARD(zt, ns, nd, rel, re)
        dz_k, dre_k = negscore.BACKWARD(zt, ns, nd, rel, re, ds)
        zp = zt.clone().requires_grad_(True)
        rp = rel_emb.clone().requires_grad_(True)
        s_p = negscore.distmult_neg_scores_plain(zp, ns, nd, rel, rp)
        dz_p, dre_p = torch.autograd.grad(s_p, (zp, rp), ds)
        torch.cuda.synchronize()
        pairs = ((s_k, s_p.detach()), (dz_k, dz_p), (dre_k, dre_p))
        rel_errs = tuple(rel_err(a, b) for a, b in pairs)
        err[dtype] = (float((s_k - s_p).abs().max()),
                      max(float((dz_k - dz_p.float()).abs().max()),
                          float((dre_k - dre_p).abs().max())))
        if dtype == torch.bfloat16:
            val_tol, grad_tol = NEG_TOL_BF16
            ok = rel_errs[0] <= val_tol and max(rel_errs[1:]) <= grad_tol
            how = f"tol {val_tol:g} / {grad_tol:g}"
        else:
            za = zt.abs().requires_grad_(True)
            ra = rel_emb.abs().requires_grad_(True)
            s_a = negscore.distmult_neg_scores_plain(za, ns, nd, rel, ra)
            mags = (s_a.detach(),) + torch.autograd.grad(s_a, (za, ra),
                                                         ds.abs())
            ratios = [float(((a.float() - b.float()).abs()
                             / c.clamp(min=1e-30)).max())
                      for (a, b), c in zip(pairs, mags)]
            ok = max(ratios) <= SUM_RTOL
            how = (f"of Σ|terms| per element "
                   f"{', '.join(f'{x:.3g}' for x in ratios)}, tol "
                   f"{SUM_RTOL:g}")
        print(f"negscore {str(dtype)[6:]} z {tuple(zt.shape)}, {m} slots, "
              f"R = {rel_emb.shape[0]}: kernel vs plain rel-to-max scores "
              f"{rel_errs[0]:.3g}, dz {rel_errs[1]:.3g}, d(rel_emb) "
              f"{rel_errs[2]:.3g} ({how}); max abs {err[dtype]}")
        check(ok, f"negscore {dtype}: kernels disagree with the plain version")

    zt = z.to(torch.bfloat16).contiguous()
    re = negscore.relation_table(rel_emb, torch.bfloat16)
    fwd_ms = time_ms(lambda: negscore.FORWARD(zt, ns, nd, rel, re))
    bwd_ms = time_ms(lambda: negscore.BACKWARD(zt, ns, nd, rel, re, ds))
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: negscore.distmult_neg_scores_plain(
            zt, ns, nd, rel, rel_emb))
    zp = zt.clone().requires_grad_(True)
    rp = rel_emb.clone().requires_grad_(True)
    s_p = negscore.distmult_neg_scores_plain(zp, ns, nd, rel, rp)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
        s_p, (zp, rp), ds, retain_graph=True))
    bounds = [negscore_bound_ms(zt, m, rel_emb.shape[0], bw)
              for bw in (False, True)]
    for name, ms, plain_ms, (bound, by) in (
            ("forward", fwd_ms, plain_fwd_ms, bounds[0]),
            ("backward", bwd_ms, plain_bwd_ms, bounds[1])):
        print(f"negscore {name} time (bf16, training shape): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({by}), kernel at {bound / ms:.1%} of bound; no single "
              f"PyTorch call computes this function")

    data = torch.randn(num_edges, TRAIN["hidden_dim"], device=dev,
                       generator=gen).bfloat16()
    dst = batch.edge_index[1].int()
    n_pad = batch.node_mask.shape[0]
    got = segsum.KERNEL(data, dst, n_pad)
    want = segsum.segsum_plain(data, dst, n_pad)
    scale = segsum.segsum_plain(data.abs(), dst, n_pad)
    check(bool(torch.all((got - want).abs() <= SUM_RTOL * scale)),
          "segsum kernel disagrees at the training shape")
    yard = torch.zeros(n_pad, data.shape[1], device=dev)
    seg = (time_ms(lambda: segsum.KERNEL(data, dst, n_pad)),
           time_ms(lambda: segsum.segsum_plain(data, dst, n_pad)),
           time_ms(lambda: yard.index_add_(0, dst.long(), data.float())),
           *segsum_bound_ms(data, n_pad))
    print(f"segsum conv bf16 time (training shape {tuple(data.shape)} into "
          f"{n_pad}): kernel {seg[0]:.4f} ms, plain {seg[1]:.4f} ms, "
          f"index_add_ {seg[2]:.4f} ms, bound {seg[3]:.4f} ms ({seg[4]})")

    # -- training makes progress on a fixed batch -------------------------
    probe = train_module(sd, module.feature_table, dev)
    probe.configure_optimizers(num_training_steps=20)
    st = probe.init_state()
    negatives, masks = fixed_draws(
        probe, batch, torch.Generator(device=dev).manual_seed(SEED + 2))
    keep_all = [torch.ones_like(mk) for mk in masks]
    losses = []
    for _ in range(8):
        st, out = probe.train_step(st, batch, negatives=negatives,
                                   dropout_masks=keep_all)
        losses.append(float(out["train_loss"]))
    print(f"fixed-batch losses (lr 0 at step 0, warm-up 4 steps): "
          f"{[round(x, 6) for x in losses]}")
    check(abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0]),
          "the first update (schedule(0) = 0) changed the loss")
    check(losses[-1] < losses[1], "the loss did not fall on a fixed batch")

    # -- the train_kge entry point on the card, on the same graph, served --
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "biomedkg_tpu_torch.train_kge", "steps=3",
             "epochs=1", "saint_fill=0.92", "model.compute_dtype=bfloat16",
             f"seed={SEED}", f"ckpt_dir={tmp}/ckpt"],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        print(f"train_kge ({time.perf_counter() - t0:.1f} s, rc "
              f"{proc.returncode}):", proc.stdout.strip().replace("\n", " | "))
        check(proc.returncode == 0,
              f"train_kge failed: {proc.stderr[-2000:]}")
        check(proc.stdout.startswith(f"train_kge: {dm.graph.num_nodes} "
                                     f"nodes, {dm.graph.num_edges} edges"),
              "train_kge did not train on the PrimeKG++-scale graph")
        ckpt = proc.stdout.split("checkpoint: ")[-1].strip()
        full = PrimeKGModule(**dict(PRIMEKG_DATA,
                                    data_dir=os.path.join(tmp, "d")),
                             seed=SEED)
        t0 = time.perf_counter()
        served = KGEScorer(ckpt, full, device="cuda")
        init_s = time.perf_counter() - t0
        check(bool(torch.isfinite(served.z).all())
              and served.z.shape[0] == dm.graph.num_nodes,
              "train_kge checkpoint: served z not finite / not full-graph")
        p = served.score("gene_000000", "protein_protein", "gene_000001")
        print(f"train_kge checkpoint served over {served.z.shape[0]} "
              f"nodes (init {init_s:.1f} s): score {p:.6f}")
        check(0.0 < p < 1.0, "served score out of (0, 1)")

    return [
        {"name": "distmult_neg_scores", "route": "cuda",
         "source": "biomedkg_tpu_torch/csrc/negscore.cu",
         "replaces": "biomedkg_tpu/ops/pallas/negscore.py:494",
         "launches": launches["distmult_neg_scores"],
         "max_abs_err": err[torch.bfloat16][0], "ms": fwd_ms,
         "plain_ms": plain_fwd_ms, "bound_ms": bounds[0][0],
         "bound_by": bounds[0][1], "library_ms": None},
        {"name": "distmult_neg_scores_bwd", "route": "cuda",
         "source": "biomedkg_tpu_torch/csrc/negscore.cu",
         "replaces": "biomedkg_tpu/ops/pallas/negscore.py:526",
         "launches": launches["distmult_neg_scores_bwd"],
         "max_abs_err": err[torch.bfloat16][1], "ms": bwd_ms,
         "plain_ms": plain_bwd_ms, "bound_ms": bounds[1][0],
         "bound_by": bounds[1][1], "library_ms": None},
    ], launches["sorted_segment_sum"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    check_full_fp32()
    dev = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # -- 1. build every kernel from the checkout, all at once -------------
    t0 = time.perf_counter()
    libraries = (segsum.LIBRARY, negscore.LIBRARY)
    with ThreadPoolExecutor(len(libraries) + 1) as pool:
        builds = [pool.submit(lib.lib) for lib in libraries]
        sampler = pool.submit(native.get_lib)
        for future in builds:
            future.result()
        check(sampler.result() is not None, "the host sampler did not build")
    print(f"build: {len(libraries)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)})")
    for lib in libraries:
        print(f"build: {lib.source} → {lib.library_path}")
        print(lib.build_log.strip())

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

    # -- 5. the training main path ----------------------------------------
    neg_records, train_segsum = train_phase(scorer.dm, dev)

    ms, plain_ms, lib_ms, bound_ms, bound_by = timed["conv f32"]
    print(json.dumps({"kernels": [{
        "name": "sorted_segment_sum", "route": "cuda",
        "source": "biomedkg_tpu_torch/csrc/segsum.cu",
        "replaces": "biomedkg_tpu/ops/pallas/segsum.py:74",
        "launches": launches["sorted_segment_sum"] + train_segsum,
        "max_abs_err": max(results.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms}] + neg_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
