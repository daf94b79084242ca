#!/usr/bin/env python3
"""On-card check of the PyTorch port (biomedkg_tpu_torch): the KGE serving
path, the KGE training step (RGCN and RGAT) and Stage B's GCL pretraining
(GRACE, DGI, GGD) at full width on one CUDA card (Hopper, sm_90a).

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
    ``KGEScorer`` (with it, concurrently, the RotatE + "sorted2" run of
    phase 6);
 6. the other decoders and the dual-sorted sampler on the same SAINT
    batches at full width: ComplEx, TransE and RotatE (γ = 12) with
    "sorted" negatives and all four decoders with "sorted2". For each:
    warm-up steps, then P6_STEPS timed steps with every launch count set to
    0 just before and read just after (the mode's streamed or dual-sorted
    negscore pair 1 + 1 per step, segsum 6); one batch's loss and every
    gradient with the kernels against the plain versions (bf16 and
    float32); the mode's two kernels against the plain version at the
    path's shapes (the dual-sorted ones also on an input whose nd is in any
    order), timed beside their bounds; the loss falling on a fixed batch;
    for RotatE + "sorted2" a torch.profiler breakdown as in phase 5.
    Before them every negscore kernel on small shapes off the path.
    Then ``train_kge model.decoder_name=rotate model.neg_sampler=sorted2``'s
    checkpoint served, its ``score`` and ``topk_tails`` answers checked
    against a float64 host recomputation;
 7. RGAT and the relation-layout edge conv, through the grouped-GEMM
    kernel ``relation_matmul_sorted`` (forward and d_msg), whose wrapper
    picks one of four instances per call (ops/relmm.py::relmm_instance):
    every instance of each type against the plain version on small odd
    shapes (B of 64 and 96, din 100 / dout 36 and the aligned 72 / 40, a
    relation with no block, trailing pad blocks); the RGAT training step
    (RGAT 768→256×4, 2 heads, + DistMult, "sorted" negatives, bf16 with
    float32 masters) on relation-layout SAINT batches of the same envelope,
    timed as in phase 5 with its launch counts (relmm 8 + 6 per step, all
    on ``wgmma``; negscore 1 + 1, segsum 0), a torch.profiler window with
    its float32 index_add_s split by call site, the same window with the
    first-design relmm (the general instances), a few float32 steps (relmm
    on ``simt_f32``), loss and gradients with the kernels against the plain
    versions, the loss falling on a fixed batch; both directions at the
    path's shapes (RGAT's 768 → 512 and 256 → 512 in bf16, the edge conv's
    full-graph 768 → 256 in float32), where the wrapper must pick the
    redesigned instance, each against the plain version and timed on the
    device (torch.profiler) beside the general instance in turns, the plain
    version, one torch.bmm over pre-gathered weight blocks, dW and the
    bound; the RGCN edge conv's full-graph encode (4 launches on
    ``simt_f32``, and once with the first design) against the node conv's
    z; and ``train_kge model.encoder_name=rgat``'s checkpoint (run beside
    phase 5's) served: a float32 full-graph RGAT encode with 8 launches,
    timed, and with the plain versions and the first-design relmm, its z
    against the plain versions' (Z_RTOL of max|z|), its answers checked
    against float64. The ``kernels`` line has one record per relmm
    instance and direction: the redesigns with their main-path launches,
    the general instances (off the path) with none;
 8. Stage B, GCL pretraining on the gene/protein graph of the same
    synthetic PrimeKG++ (train_gcl.py:37), through the flash InfoNCE
    kernels ``flash_denom`` (forward and backward) and the segsum:
    (a) both flash kernels against the plain version off the path (N of
    1,000, 333, 200 and 130, d of 100, 36, 30 and 256, with and without a
    padded tail), float32 and bf16; (b) the GRACE training step at full
    width (GCN 768→256×4, projection 256→256→256, τ = 0.2, Adam with cosine
    warm-up 0.2, clip 1.0) on [30, 30, 30] neighbour batches of 128 seeds in
    the dst layout with device-resident features, in bf16 and in float32
    (the config's type): warm-up steps, timed steps with every launch count
    set to 0 just before and read just after (segsum 8, flash 2 + 2 per
    step), ms per step, nodes per second, the envelope, peak memory and a
    torch.profiler window; one batch's loss and every gradient with the
    kernels against the plain versions; the loss falling on a fixed batch;
    (c) both flash kernels at the path's shape (the envelope's node slots,
    d = 256, its pad tail), float32 and bf16, timed beside their bounds and
    the plain version, and the segsum at the step's shape (the batch's edge
    slots × 256 into its node slots), timed beside index_add_; (d) one DGI
    and one GGD step at the same width, kernels against plain versions
    (segsum 8, flash 0); (e) ``python -m biomedkg_tpu_torch.train_gcl
    model.model_name=grace data.node_type=gene`` (started beside phase 5's
    ``train_kge`` runs), its checkpoint loaded by ``load_gcl_module`` and
    the full gene/protein graph encoded on the card and on the CPU.

The second-to-last line is the ``{"kernels": [...]}`` JSON record, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import itertools
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
from biomedkg_tpu_torch.ops import (_build, flashnce, negscore, relmm,
                                    segment, segsum)
from biomedkg_tpu_torch.sampling import native
from biomedkg_tpu_torch.sampling.batch import batch_to_device
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader
from biomedkg_tpu_torch.serve import PRIMEKG_DATA, serve_loop
from biomedkg_tpu_torch.serving import KGEScorer
from biomedkg_tpu_torch.training.checkpoint import save_checkpoint
from biomedkg_tpu_torch.training import gcl_module
from biomedkg_tpu_torch.training.kge_module import (KGEModule, _mix_factor,
                                                    rolled_index,
                                                    sample_negatives_sorted)

SEED = 42
WARMUP, ITERS = 3, 20
PROFILE_TRIES = 3
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM float32, outside tensor cores
BF16_FLOP_PER_S = 989e12         # H100 SXM bf16 tensor cores, dense
# special-function units (sqrt, reciprocal): 16 per SM and clock against
# 128 float32 FMA lanes (256 operations)
SFU_OP_PER_S = FP32_FLOP_PER_S / 16
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

# -- phase 6: the other decoders and the dual-sorted sampler --------------
MODE = {"dismult": "distmult", "complex": "complex", "transe": "transe",
        "rotate": "rotate"}
PHASE6 = [("complex", "sorted"), ("transe", "sorted"), ("rotate", "sorted"),
          ("dismult", "sorted2"), ("complex", "sorted2"),
          ("transe", "sorted2"), ("rotate", "sorted2")]
P6_WARMUP, P6_STEPS = 2, 5
PROFILED6 = ("rotate", "sorted2")     # the configuration phase 6 profiles
# TransE's gradients reach z through the L1 sign: in bf16 they are held to
# JAX's own figure for its dz (tests/test_ops.py:619-624)
TRANSE_GRAD_TOL_BF16 = 8e-2
# per slot and feature, the float32 operations of (forward, backward); the
# paired modes' counts are per unit (features j and j + d/2) halved
NEG_FLOPS = {"distmult": (3, 8), "complex": (5, 15), "transe": (4, 10),
             "rotate": (6.5, 16.5)}
# per unit, the special-function operations of (forward, backward): RotatE's
# sqrt, and its divide by the distance backward
NEG_SFU = {"rotate": (1, 2)}
# the TPU functions each negscore kernel replaces (negscore.py lines), by
# (dual-sorted, backward)
NEG_REPLACES = {(False, False): 494, (False, True): 526,
                (True, False): 355, (True, True): 387}

# -- phase 7: RGAT and the relation-layout edge conv -----------------------
RGAT = dict(TRAIN, encoder_name="rgat")        # 2 heads (HPARAMS)
P7_WARMUP, P7_STEPS = 2, 5
# float32 RGAT steps (train_kge's default type): warm-up, timed
P7_F32_WARMUP, P7_F32_STEPS = 1, 2
# grouped GEMMs per RGAT step (two per conv: source and destination
# messages) and d_msg launches (none for the first conv: its messages come
# from the feature table, which has no gradient); per encode
RELMM_PER_STEP = (2 * CONVS, 2 * (CONVS - 1))
RELMM_PER_RGAT_ENCODE = 2 * CONVS
RELMM_PER_EDGE_ENCODE = CONVS
# relmm kernel against plain, per element, relative to (|msg| @ |W|): float32
# sums differ only in order; bf16 outputs are each rounded once (at most one
# bf16 ulp, 2^-7, apart)
RELMM_RTOL = {torch.float32: SUM_RTOL, torch.bfloat16: 1e-2}
# relmm is timed on the device (device_ms): a call's Python wrapper takes
# tens of microseconds, as long as the bf16 kernels themselves or longer on
# a busy host, so CUDA events around calls would time the host
# the TPU functions the two relmm kernels replace (relmm.py lines)
RELMM_REPLACES = {False: 36, True: 91}
# relmm off the path: (din, dout, B). din 100 / dout 36 take the general
# bf16 instance (not multiples of 8) and simt_f32; 72 / 40 take wgmma
RELMM_ODD = [(100, 36, 64), (100, 36, 96), (72, 40, 96)]

# -- phase 8: Stage B GCL pretraining (train_gcl.py, configs/model/gcl.yaml,
# configs/model/base.yaml) ---------------------------------------------------
GCL = dict(in_dim=768, hidden_dim=256, out_dim=256, num_hidden_layers=2,
           scheduler_type="cosine", learning_rate=1e-3, warm_up_ratio=0.2,
           fuse_method="none", seed=SEED)
GCL_NODE_TYPE = ["gene/protein"]   # train_gcl.py:37: the largest node type
GCL_TAU = gcl_module.TAU
SEGSUM_PER_GCL_STEP = 2 * CONVS    # two encodes per step, one per conv
FLASH_PER_STEP = 2                 # one forward, one backward per direction
# (warm-up, timed, profiled) steps of the GRACE step per compute type
P8_STEPS = {torch.bfloat16: (2, 4, 2), torch.float32: (1, 2, 1)}
P8_BATCHES = 6
P8_FALL_STEPS = {torch.bfloat16: 6, torch.float32: 4}
TRAIN_GCL_STEPS = 3
# flash kernels against the plain version: (denominators, gradients).
# float32: den within 1e-5 of |den| (sums that differ only in order),
# gradients 1e-4 of their max; bf16: den within 0.1 of the float32 plain
# version's (tests/test_gcl_losses.py:200-201), gradients 5e-2 of their max
# against the plain version in bf16 (tests/test_gcl_losses.py:114)
FLASH_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (0.1, 5e-2)}
# the step comparisons scale the features by 30 (as tests/test_torch_gcl.py
# does). The reference's random node features are xavier_normal over the
# (27,000, 768) table, std 0.0085: at initialisation every GRACE
# projection is then nearly the same vector, every cosine similarity is
# near 1, and the InfoNCE gradient is a difference of near-equal vectors,
# so float32 summation-order noise reaches 7.5e-3 of the max in the last
# layers' gradients (measured on one H100) and bf16 gradients are rounding noise
# in the plain version itself; DGI's loss sits near 0. At 30 times the
# features the similarities spread.
COMPARE_FEATURE_SCALE = 30.0
# phase 8a: (N, d, pad rows) off the path
FLASH_ODD = [(1000, 100, 0), (333, 36, 40), (1000, 36, 57), (333, 100, 0),
             (130, 256, 5), (200, 30, 9)]
# the TPU functions the flash kernels replace (flashnce.py pallas_call lines)
FLASH_REPLACES = {False: "212", True: "238/250"}


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


def device_ms(fn) -> float:
    """The device time of one call of ``fn`` in ms, after warm-up: the
    kernel times torch.profiler records over ITERS calls, summed and
    divided by ITERS. The host's time between kernels does not enter.
    CUPTI now and then hands a window back with no kernel in it: such a
    window is profiled again, and after PROFILE_TRIES empty windows the
    CUDA-event time (time_ms, host gaps included) stands in, said so."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA) \
            / 1e3 / ITERS
        if ms > 0:
            return ms
    ms = time_ms(fn)
    print(f"device_ms: torch.profiler recorded no kernel in "
          f"{PROFILE_TRIES} windows; CUDA-event time {ms:.4f} ms used")
    return ms


def segsum_batch_times(batch, d: int, dtype, gen, what: str):
    """The segsum kernel at a batch's shape, (edge slots, d) messages in
    ``dtype`` into its node slots by its dst ids: against the plain
    version (SUM_RTOL of Σ|x| per segment), timed beside the plain version,
    one float32 index_add_ and the bound."""
    dst = batch.edge_index[1].int()
    n_pad = batch.node_mask.shape[0]
    data = torch.randn(dst.shape[0], d, device=dst.device,
                       generator=gen).to(dtype)
    got = segsum.KERNEL(data, dst, n_pad)
    want = segsum.segsum_plain(data, dst, n_pad)
    scale = segsum.segsum_plain(data.abs(), dst, n_pad)
    check(bool(torch.all((got - want).abs() <= SUM_RTOL * scale)),
          f"segsum kernel disagrees at the {what}")
    yard = torch.zeros(n_pad, d, device=dst.device)
    ms = time_ms(lambda: segsum.KERNEL(data, dst, n_pad))
    plain_ms = time_ms(lambda: segsum.segsum_plain(data, dst, n_pad))
    lib_ms = time_ms(lambda: yard.index_add_(0, dst.long(), data.float()))
    bound, by = segsum_bound_ms(data, n_pad)
    print(f"segsum {what} {str(dtype)[6:]} time ({tuple(data.shape)} into "
          f"{n_pad}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_add_ {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}), kernel "
          f"at {bound / ms:.1%} of bound; max abs err "
          f"{float((got - want).abs().max()):.3g}")


def segsum_bound_ms(data: torch.Tensor, num_segments: int):
    """Least time for one segment-sum: each input read once, the output
    written once, over HBM bandwidth; the adds over float32 peak."""
    m, d = data.shape
    nbytes = m * d * data.element_size() + 4 * m + num_segments * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = m * d / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def negscore_bound_ms(mode, z, m, r, backward: bool):
    """Least time for one negscore call, as (ms, "bytes" or "operations",
    the term that sets it): the z table, three int32 index arrays, the
    relation table and the scores (plus ds in, dz and the relation gradient
    out backward) moved once over HBM bandwidth; the mode's float32
    operations over the float32 peak; its special-function operations over
    their peak."""
    n, d = z.shape
    nbytes = n * d * z.element_size() + 3 * 4 * m + r * d * 4 + 4 * m
    if backward:
        dr = d // 2 if mode == "rotate" else d
        nbytes += n * d * 4 + r * dr * 4
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        "float32 operations": NEG_FLOPS[mode][backward] * m * d
        / FP32_FLOP_PER_S * 1e3,
        "special-function operations": NEG_SFU.get(mode, (0, 0))[backward]
        * m * (d // 2) / SFU_OP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def relmm_key(kernel, instance: str) -> str:
    return f"{kernel.name}[{instance}]"


def launch_counts() -> dict:
    """Every kernel's launches; relmm's also by instance."""
    return {"sorted_segment_sum": segsum.KERNEL.launches,
            **{name: k.launches for name, k in negscore.KERNELS.items()},
            **{name: k.launches for name, k in relmm.KERNELS.items()},
            **{relmm_key(k, inst): c for k in relmm.KERNELS.values()
               for inst, c in k.by_instance.items()},
            **{name: k.launches for name, k in flashnce.KERNELS.items()}}


def reset_launch_counts():
    segsum.KERNEL.launches = 0
    for k in (*negscore.KERNELS.values(), *flashnce.KERNELS.values()):
        k.launches = 0
    for k in relmm.KERNELS.values():
        k.reset()


def expected_launches(segsum_n: int, kernel, n: int, relmm_n=(0, 0),
                      flash_n: int = 0, relmm_instance: str = None) -> dict:
    """Every count 0 but segsum's, the ``kernel`` negscore pair's (none
    when ``kernel`` is None), relmm's (forward, d_msg), all of them on
    ``relmm_instance``, and the flash pair's (forward, backward)."""
    want = dict.fromkeys(launch_counts(), 0)
    want.update({"sorted_segment_sum": segsum_n, relmm.NAME: relmm_n[0],
                 relmm.NAME + "_bwd": relmm_n[1], flashnce.NAME: flash_n,
                 flashnce.NAME + "_bwd": flash_n})
    if any(relmm_n):
        want[relmm_key(relmm.FORWARD, relmm_instance)] = relmm_n[0]
        want[relmm_key(relmm.BACKWARD, relmm_instance)] = relmm_n[1]
    if kernel is not None:
        want.update({kernel: n, kernel + "_bwd": n})
    return want


# the decoders' negscore dispatchers and their plain versions
NEG_DISPATCH = {negscore.kernel_name(mode, dual):
                getattr(negscore, f"{mode}_neg_scores_plain")
                for mode in negscore.MODES for dual in (False, True)}


@contextlib.contextmanager
def plain_versions():
    """The model with every kernel swapped for its plain torch version
    (the segment-sums of the encoder and of the tail gather's backward,
    the grouped GEMM of the relational convs, the negative scoring of
    every decoder and sampler, and GRACE's flash denominators)."""
    saved = (encoders.sorted_segment_sum, segment.sorted_segment_sum,
             encoders.relation_matmul_sorted, gcl_module.flash_denom,
             {name: getattr(decoders, name) for name in NEG_DISPATCH})
    encoders.sorted_segment_sum = segsum.segsum_plain
    segment.sorted_segment_sum = segsum.segsum_plain
    encoders.relation_matmul_sorted = relmm.relation_matmul_sorted_plain
    gcl_module.flash_denom = flashnce.flash_denom_plain
    for name, plain in NEG_DISPATCH.items():
        setattr(decoders, name, plain)
    try:
        yield
    finally:
        (encoders.sorted_segment_sum, segment.sorted_segment_sum,
         encoders.relation_matmul_sorted, gcl_module.flash_denom) = saved[:4]
        for name, fn in saved[4].items():
            setattr(decoders, name, fn)


@contextlib.contextmanager
def first_design_relmm():
    """relmm's wrapper picking the general instances (the first design)
    for every call: the A/B of the redesign on its paths."""
    saved = relmm.relmm_instance
    relmm.relmm_instance = lambda dtype, *_: relmm.GENERAL[dtype]
    try:
        yield
    finally:
        relmm.relmm_instance = saved


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
    """One set of the module's sorted negatives and dropout keep masks for
    ``batch``."""
    num_edges = batch.edge_type.shape[0]
    nreal = batch.node_mask.sum().clamp(min=1)
    negatives = sample_negatives_sorted(
        gen, module.neg_ratio, num_edges, nreal,
        dual=module.neg_sampler == "sorted2")
    n = batch.node_mask.shape[0]
    masks = [dropout_mask((n, dout), encoders.DROPOUT, gen, gen.device)
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
    module.edge_layout = module.default_layout
    module.feature_table = feature_table
    return module


def triplets(batches):
    """Stage C's work count: real edges x (1 + K) per step."""
    return (sum(int(b.edge_mask.sum()) for b in batches)
            * (1 + TRAIN["neg_ratio"]),
            "triplets/s (real edges x (1 + K) per step, bench.py:167)")


def real_nodes(batches):
    """Stage B's work count: the real nodes of each batch."""
    return (sum(int(b.node_mask.sum()) for b in batches),
            "nodes/s (real nodes per batch)")


def timed_steps(module, state, batches, gen, what: str, work=triplets):
    """Run ``batches`` with every launch count set to 0 just before and
    read just after; returns (state, launches, ms per step)."""
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    state, logs = module.train_steps(state, batches, gen)
    end.record()
    torch.cuda.synchronize()
    steps = len(batches)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    event_ms = start.elapsed_time(end) / steps
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    loss = float(logs["train_loss"])
    count, unit = work(batches)
    print(f"{what}: {step_ms:.3f} ms per step (host clock), "
          f"{event_ms:.3f} ms (CUDA events), "
          f"{count / (step_ms * steps / 1e3):.4g} {unit}; peak device "
          f"memory {peak_gb:.3f} GB, of which {resident_gb:.3f} GB was "
          f"allocated before the steps; last loss {loss:.6f}; launches over "
          f"{steps} steps {({k: v for k, v in launches.items() if v})}")
    check(np.isfinite(loss), f"{what}: training loss not finite")
    return state, launches, step_ms


def profile_steps(module, state, batches, gen, what: str,
                  split_op: str = None):
    """Device busy time by kernel and host time by op over one profiled
    window of ``batches`` (torch.profiler), and the idle share against the
    same window's CUDA-event wall time; with ``split_op``, that op's calls
    by call site (the window then records Python stacks)."""
    steps = len(batches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA],
            with_stack=split_op is not None) as prof:
        start.record()
        module.train_steps(state, batches, gen)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / steps
    events = prof.key_averages()
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    if busy == 0:
        print(f"{what}: torch.profiler recorded no device kernel in this "
              f"window ({wall:.3f} ms wall per step); no breakdown")
        return
    print(f"{what} device kernels (torch.profiler, {steps} steps, per "
          f"step): {busy:.3f} ms busy of {wall:.3f} ms wall (CUDA events in "
          f"the same profiled window; idle share {1 - busy / wall:.3f}), "
          f"{sum(e.count for e in kernels) / steps:g} kernels; "
          + "; ".join(f"{e.key[:60]} x{e.count / steps:g} "
                      f"{e.self_device_time_total / 1e3 / steps:.3f} ms"
                      for e in kernels[:15]))
    host_ops = sorted((e for e in events
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)
    print(f"{what} host ops (torch.profiler, self CPU ms per step, "
          f"profiled): "
          + "; ".join(f"{e.key[:40]} x{e.count / steps:g} "
                      f"{e.self_cpu_time_total / 1e3 / steps:.3f}"
                      for e in host_ops[:12]))
    if split_op is not None:
        split_by_call_site(prof, split_op, steps, what)


def call_site(event) -> str:
    """Where a profiled op was called from, read from its parents (the
    window ran with_stack, so Python frames are parent events): the
    autograd node whose backward ran it, if any, with the port's frames
    inside that backward; else the port's two innermost frames; else the
    op that called it."""
    frames, node = [], None
    parent = event.cpu_parent
    while parent is not None and node is None:
        name = parent.name
        if name.startswith("autograd::engine::evaluate_function: "):
            node = name.split(": ", 1)[1]
        elif "biomedkg_tpu_torch/" in name:
            frames.append(name.split("biomedkg_tpu_torch/")[-1])
        parent = parent.cpu_parent
    site = " < ".join(frames[:2])
    if node is not None:
        site = f"backward of {node}" + (f" ({site})" if site else "")
    if site:
        return site
    return (f"inside {event.cpu_parent.name}" if event.cpu_parent
            else "no recorded caller")


def split_by_call_site(prof, op: str, steps: int, what: str):
    """``op``'s calls grouped by call site, each with the device time of
    the kernels they launched, per step."""
    sites = {}
    for e in prof.events():
        if e.name == op:
            ms, count = sites.get(call_site(e), (0.0, 0))
            sites[call_site(e)] = (ms + e.device_time_total / 1e3, count + 1)
    ordered = sorted(sites.items(), key=lambda kv: -kv[1][0])
    print(f"{what} {op} by call site (torch.profiler with_stack, device ms "
          f"per step): {sum(v[0] for v in sites.values()) / steps:.3f} ms "
          f"in {sum(v[1] for v in sites.values()) / steps:g} calls; "
          + "; ".join(f"x{count / steps:g} {ms / steps:.3f} ms at {site}"
                      for site, (ms, count) in ordered))


def compare_step(sd, feature_table, dev, batch, kernel: str, what: str,
                 segsum_n=SEGSUM_PER_STEP, relmm_n=(0, 0), **over):
    """One batch's loss and every gradient with the kernels against the
    same step with the plain versions, in bf16 and float32; one step makes
    ``segsum_n`` segsum launches and ``relmm_n`` relmm ones."""
    for dtype in (torch.bfloat16, torch.float32):
        step = train_module(sd, feature_table, dev,
                            compute_dtype=str(dtype)[6:], **over)
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
        check(used == expected_launches(segsum_n, kernel, 1, relmm_n,
                                        relmm_instance=relmm.FAST[dtype]),
              f"{what}: launches in one step: {used}")
        loss_tol, grad_tol = STEP_TOL[dtype]
        if dtype == torch.bfloat16 and kernel.startswith("transe"):
            grad_tol = TRANSE_GRAD_TOL_BF16
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        errs = {n: rel_err(a, b) for (n, _), a, b in
                zip(step.named_parameters(), grads_k, grads_p)}
        worst = max(errs, key=errs.get)
        print(f"{what} step {str(dtype)[6:]}, kernels vs plain: loss "
              f"{loss_k:.7f} vs {loss_p:.7f} (rel {loss_err:.3g}, tol "
              f"{loss_tol:g}); gradients max rel-to-max {errs[worst]:.3g} "
              f"({worst}; tol {grad_tol:g})")
        check(loss_err <= loss_tol, f"{what} {dtype} step: loss disagrees")
        check(errs[worst] <= grad_tol,
              f"{what} {dtype} step: {worst} disagrees")


def neg_magnitudes(mode, zt, ns, nd, rel, rel_emb, ds):
    """For each element of the scores, dz and the relation gradient, the
    sum of its terms' magnitudes: float32 checks hold each element within
    SUM_RTOL of it (sums that differ only in order)."""
    n, d = zt.shape
    h = zt[ns.long()].float().requires_grad_(True)
    t = zt[nd.long()].float().requires_grad_(True)
    if mode == "rotate":
        leaf = rel_emb[rel.long()].float().requires_grad_(True)
        rows = negscore.relation_table(mode, leaf, zt.dtype)
    else:
        leaf = negscore.relation_table(mode, rel_emb, zt.dtype)[
            rel.long()].requires_grad_(True)
        rows = leaf
    terms = negscore.slot_terms(mode, h, t, rows)
    dh, dt, dr = torch.autograd.grad(terms.sum(1), (h, t, leaf), ds)
    mag_dz = torch.zeros(n, d, device=zt.device)
    mag_dz.index_add_(0, ns.long(), dh.abs()).index_add_(0, nd.long(),
                                                          dt.abs())
    mag_dr = torch.zeros(rel_emb.shape, device=zt.device)
    mag_dr.index_add_(0, rel.long(), dr.abs())
    return terms.detach().abs().sum(1), mag_dz, mag_dr


def negscore_records(mode, dual, z, negatives, rel_emb, ds, launches,
                     nd_wide=None):
    """The (mode, family) forward and backward kernels against the plain
    version at the path's shapes (scores, dz, the relation gradient; the
    dual-sorted ones also with ``nd_wide``, ids in any order, in float32),
    timed beside their bounds; returns their two ``kernels`` records."""
    name = negscore.kernel_name(mode, dual)
    fwd, bwd = negscore.KERNELS[name], negscore.KERNELS[name + "_bwd"]
    ns, nd, rel = negatives
    m, r = ns.shape[0], rel_emb.shape[0]

    def kernel_table(dtype):
        zt = z.to(dtype)
        if mode == "transe":      # the table pass the kernels see
            zt = negscore.l1_normalized(zt)
        return (zt.contiguous(),
                negscore.relation_table(mode, rel_emb, dtype).contiguous())

    err = {}
    for dtype in (torch.bfloat16, torch.float32):
        zt, re = kernel_table(dtype)
        inputs = [("", nd)]
        if nd_wide is not None and dtype == torch.float32:
            inputs.append((", nd in any order", nd_wide))
        for label, ndc in inputs:
            s_k = fwd(zt, ns, ndc, rel, re)
            dz_k, dre_k = bwd(zt, ns, ndc, rel, re, ds)
            zp = zt.clone().requires_grad_(True)
            rp = rel_emb.clone().requires_grad_(True)
            s_p = negscore.plain_scores(mode, zp, ns, ndc, rel, rp)
            dz_p, dre_p = torch.autograd.grad(s_p, (zp, rp), ds)
            torch.cuda.synchronize()
            pairs = ((s_k, s_p.detach()), (dz_k, dz_p), (dre_k, dre_p))
            rel_errs = [rel_err(a, b) for a, b in pairs]
            abs_errs = [float((a.float() - b.float()).abs().max())
                        for a, b in pairs]
            if dtype == torch.bfloat16:
                val_tol, grad_tol = NEG_TOL_BF16
                ok = rel_errs[0] <= val_tol and max(rel_errs[1:]) <= grad_tol
                how = f"tol {val_tol:g} / {grad_tol:g}"
            else:
                mags = neg_magnitudes(mode, zt, ns, ndc, rel, rel_emb, ds)
                ratios = [float(((a.float() - b.float()).abs()
                                 / c.clamp(min=1e-30)).max())
                          for (a, b), c in zip(pairs, mags)]
                ok = max(ratios) <= SUM_RTOL
                how = (f"of Σ|terms| per element "
                       f"{', '.join(f'{x:.3g}' for x in ratios)}, tol "
                       f"{SUM_RTOL:g}")
            print(f"{name} {str(dtype)[6:]}{label}: z {tuple(zt.shape)}, "
                  f"{m} slots, R = {r}: kernels vs plain rel-to-max scores "
                  f"{rel_errs[0]:.3g}, dz {rel_errs[1]:.3g}, d(rel_emb) "
                  f"{rel_errs[2]:.3g} ({how}); max abs {abs_errs}")
            check(ok, f"{name} {dtype}{label}: kernels disagree with the "
                      f"plain version")
            if not label:
                err[dtype] = (abs_errs[0], max(abs_errs[1:]))

    zt, re = kernel_table(torch.bfloat16)
    fwd_ms = time_ms(lambda: fwd(zt, ns, nd, rel, re))
    bwd_ms = time_ms(lambda: bwd(zt, ns, nd, rel, re, ds))
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: negscore.plain_scores(
            mode, zt, ns, nd, rel, rel_emb))
    zp = zt.clone().requires_grad_(True)
    rp = rel_emb.clone().requires_grad_(True)
    s_p = negscore.plain_scores(mode, zp, ns, nd, rel, rp)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
        s_p, (zp, rp), ds, retain_graph=True))
    records = []
    for backward, ms, plain_ms in ((False, fwd_ms, plain_fwd_ms),
                                   (True, bwd_ms, plain_bwd_ms)):
        bound, by, term = negscore_bound_ms(mode, zt, m, r, backward)
        kname = name + ("_bwd" if backward else "")
        print(f"{kname} time (bf16, training shape): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({term}), "
              f"kernel at {bound / ms:.1%} of bound; no single PyTorch "
              f"call computes this function")
        records.append({
            "name": kname, "route": "cuda",
            "source": "biomedkg_tpu_torch/csrc/negscore.cu",
            "replaces": "biomedkg_tpu/ops/pallas/negscore.py:"
                        f"{NEG_REPLACES[dual, backward]}",
            "launches": launches[kname],
            "max_abs_err": err[torch.bfloat16][backward], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None})
    return records


def loss_falls(sd, feature_table, dev, batch, what: str, **over):
    """Eight steps on one batch with fixed draws: the first (lr 0) leaves
    the loss as it was, and the loss then falls."""
    probe = train_module(sd, feature_table, dev, **over)
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
    print(f"{what} fixed-batch losses (lr 0 at step 0, warm-up 4 steps): "
          f"{[round(x, 6) for x in losses]}")
    check(abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0]),
          f"{what}: the first update (schedule(0) = 0) changed the loss")
    check(losses[-1] < losses[1], f"{what}: the loss did not fall on a "
                                  f"fixed batch")


def encoded(module, batch) -> torch.Tensor:
    """The batch's z as the bf16 training step computes it (no dropout)."""
    with torch.no_grad():
        return module.model.encoder(
            module._batch_features(batch), batch.edge_index,
            batch.edge_type, batch.edge_mask, batch.block_rel,
            compute_dtype=torch.bfloat16).float()


def path_negatives(batch, gen, dual: bool):
    """The path's (ns, nd, per-slot relation) for ``batch``."""
    num_edges = batch.edge_type.shape[0]
    ns, nd, off = sample_negatives_sorted(
        gen, TRAIN["neg_ratio"], num_edges,
        batch.node_mask.sum().clamp(min=1), dual=dual)
    rel = batch.edge_type[rolled_index(off, num_edges,
                                       _mix_factor(num_edges))].int()
    return ns, nd, rel


def start_train_kge(tmp: str, *extra) -> subprocess.Popen:
    """``python -m biomedkg_tpu_torch.train_kge`` on the card for 3 steps
    on the PrimeKG++-scale graph, in its own directory under ``tmp``."""
    root = os.path.dirname(os.path.abspath(__file__))
    cwd = tempfile.mkdtemp(dir=tmp)
    return subprocess.Popen(
        [sys.executable, "-m", "biomedkg_tpu_torch.train_kge", "steps=3",
         "epochs=1", "saint_fill=0.92", "model.compute_dtype=bfloat16",
         f"seed={SEED}", f"ckpt_dir={cwd}/ckpt", *extra],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_train_kge(proc, what: str, graph, t0: float) -> str:
    """Wait for a ``start_train_kge`` run; returns its checkpoint's path."""
    out, errs = proc.communicate(timeout=600)
    print(f"train_kge {what} ({time.perf_counter() - t0:.1f} s, rc "
          f"{proc.returncode}):", out.strip().replace("\n", " | "))
    check(proc.returncode == 0, f"train_kge {what} failed: {errs[-2000:]}")
    check(out.startswith(f"train_kge: {graph.num_nodes} nodes, "
                         f"{graph.num_edges} edges"),
          f"train_kge {what} did not train on the PrimeKG++-scale graph")
    return out.split("checkpoint: ")[-1].strip()


def serve_checkpoint(ckpt: str, tmp: str, what: str) -> KGEScorer:
    full = PrimeKGModule(**dict(PRIMEKG_DATA,
                                data_dir=tempfile.mkdtemp(dir=tmp)),
                         seed=SEED)
    t0 = time.perf_counter()
    served = KGEScorer(ckpt, full, device="cuda")
    check(bool(torch.isfinite(served.z).all())
          and served.z.shape[0] == full.graph.num_nodes,
          f"{what} checkpoint: served z not finite / not full-graph")
    print(f"{what} checkpoint served over {served.z.shape[0]} nodes (init "
          f"{time.perf_counter() - t0:.1f} s)")
    return served


def host_rotate_logits(z, theta, gamma, h, r, t=None):
    """float64 RotatE logits of (h, r, t), or of every node as the tail of
    (h, r) when ``t`` is None."""
    half = z.shape[1] // 2
    c, s = np.cos(theta[r]), np.sin(theta[r])
    rot_re = z[h, :half] * c - z[h, half:] * s
    rot_im = z[h, :half] * s + z[h, half:] * c
    tails = z if t is None else z[t]
    dist = np.sqrt(np.maximum((rot_re - tails[..., :half]) ** 2
                              + (rot_im - tails[..., half:]) ** 2, 1e-12))
    return gamma - dist.sum(-1)


def serve_rotate_requests(scorer: KGEScorer, rng):
    """``score`` and ``topk_tails`` of a RotatE checkpoint against a float64
    recomputation on the host."""
    g = scorer.dm.graph
    z = scorer.z.double().cpu().numpy()
    theta = scorer.decoder.rel_emb.detach().double().cpu().numpy()
    gamma = scorer.decoder.gamma
    pick = rng.choice(g.num_edges, 8, replace=False)
    heads, tails = g.edge_index[0, pick], g.edge_index[1, pick]
    rels = g.edge_type[pick]
    got = np.array([scorer.score(scorer.id_to_name[int(h)],
                                 scorer.dm.edge_map_index[int(r)],
                                 scorer.id_to_name[int(t)])
                    for h, r, t in zip(heads, rels, tails)])
    want = 1.0 / (1.0 + np.exp(-host_rotate_logits(z, theta, gamma, heads,
                                                   rels, tails)))
    err = float(np.abs(got - want).max())
    ntype = np.asarray(scorer.dm.data.node_type_of)
    top_err = 0.0
    for h, r in zip(heads[:3], rels[:3]):
        top = scorer.topk_tails(scorer.id_to_name[int(h)],
                                scorer.dm.edge_map_index[int(r)], k=10)
        probs = np.array([p for _, p in top])
        host = 1.0 / (1.0 + np.exp(-host_rotate_logits(z, theta, gamma, h,
                                                       r)))
        allowed = np.unique(ntype[g.edge_index[1][g.edge_type == r]])
        host[~np.isin(ntype, allowed)] = -np.inf
        host[h] = -np.inf
        check(len(top) == 10, "RotatE topk_tails: not 10 answers")
        top_err = max(top_err, float(np.abs(np.sort(host)[::-1][:10]
                                            - probs).max()))
    print(f"RotatE served: score vs float64 host max_abs_err={err:.3g}, "
          f"topk_tails top-10 probabilities max_abs_err={top_err:.3g} "
          f"(tol 1e-5)")
    check(err <= 1e-5 and top_err <= 1e-5,
          "RotatE served answers disagree with the host recomputation")


def train_phase(dm, dev, tmp):
    """Phase 5; returns the distmult negscore kernels' records, the segsum
    kernel's launches on this path, the device batches, the feature table
    and the runs it starts beside its own ``train_kge``: RotatE + sorted2
    for phase 6, RGAT for phase 7 and ``train_gcl`` for phase 8."""
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
    state, launches, _ = timed_steps(module, state, batches[TRAIN_WARMUP:],
                                     gen, "train step")
    check(launches == expected_launches(SEGSUM_PER_STEP * TRAIN_STEPS,
                                        "distmult_neg_scores", TRAIN_STEPS),
          f"launches per step on the training path: {launches}")

    profile_steps(module, state, batches[-PROFILED:], gen, "train step")

    # -- one step: kernels against the plain versions ---------------------
    batch = batches[0]
    compare_step(sd, module.feature_table, dev, batch, "distmult_neg_scores",
                 "train")

    # -- the negscore kernels against the plain version -------------------
    z = encoded(module, batch)
    ds = torch.randn(m, generator=gen, device=dev)
    records = negscore_records(
        "distmult", False, z, path_negatives(batch, gen, False),
        module.model.decoder.rel_emb.detach(), ds, launches)

    segsum_batch_times(batch, TRAIN["hidden_dim"], torch.bfloat16, gen,
                       "conv (training shape)")

    # -- training makes progress on a fixed batch -------------------------
    loss_falls(sd, module.feature_table, dev, batch, "train")

    # -- the train_kge entry point on the card, on the same graph, served;
    # phase 6's RotatE + sorted2 run and phase 7's RGAT run alongside ------
    t0 = time.perf_counter()
    runs = (start_train_kge(tmp), start_train_kge(
        tmp, "model.decoder_name=rotate", "model.neg_sampler=sorted2"),
        start_train_kge(tmp, "model.encoder_name=rgat"),
        start_train_gcl(tmp))
    ckpt = finish_train_kge(runs[0], "DistMult", dm.graph, t0)
    served = serve_checkpoint(ckpt, tmp, "train_kge DistMult")
    p = served.score("gene_000000", "protein_protein", "gene_000001")
    print(f"train_kge DistMult checkpoint: score {p:.6f}")
    check(0.0 < p < 1.0, "served score out of (0, 1)")
    return (records, launches["sorted_segment_sum"], batches,
            module.feature_table, (runs[1], t0), (runs[2], t0), (runs[3], t0))


def odd_shape_checks(dev):
    """Every negscore kernel against its plain version off the path, in
    float32: d not a multiple of the warp (nor the pair offset d/2), K·E
    not a multiple of the chunk, ids out of range (clipped)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, m, r = 37, 5000, 5
    worst = 0.0
    for mode in negscore.MODES:
        for d in (6, 100) if mode in negscore.PAIRED else (7, 100):
            def draw(lo, hi, size):
                return torch.randint(lo, hi, size, device=dev,
                                     generator=gen).int()
            z = torch.randn(n, d, device=dev, generator=gen)
            ns = torch.sort(draw(-2, n + 3, (m,)))[0]
            nd, rel = draw(-2, n + 3, (m,)), draw(-1, r + 1, (m,))
            rel_emb = torch.randn(r, d // 2 if mode == "rotate" else d,
                                  device=dev, generator=gen)
            ds = torch.randn(m, device=dev, generator=gen)
            re = negscore.relation_table(mode, rel_emb,
                                         torch.float32).contiguous()
            for dual in (False, True):
                name = negscore.kernel_name(mode, dual)
                got = (negscore.KERNELS[name](z, ns, nd, rel, re),
                       *negscore.KERNELS[name + "_bwd"](z, ns, nd, rel, re,
                                                        ds))
                zp = z.clone().requires_grad_(True)
                rp = rel_emb.clone().requires_grad_(True)
                s_p = negscore.plain_scores(mode, zp, ns, nd, rel, rp)
                want = (s_p.detach(),
                        *torch.autograd.grad(s_p, (zp, rp), ds))
                errs = [rel_err(a, b) for a, b in zip(got, want)]
                check(max(errs) <= 1e-4,
                      f"{name} at d = {d}: kernels disagree ({errs})")
                worst = max(worst, *errs)
    print(f"negscore kernels off the path (float32, N = {n}, K·E = {m}, "
          f"d of 6 or 7 and 100, ids out of range): max rel-to-max error "
          f"{worst:.3g} (tol 1e-4)")


def decoder_phase(dm, dev, tmp, batches, feature_table, rotate_run):
    """Phase 6; returns the negscore kernels' records of its paths."""
    odd_shape_checks(dev)
    batch = batches[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    m = TRAIN["neg_ratio"] * batch.edge_type.shape[0]
    ds = torch.randn(m, generator=gen, device=dev)
    records = []
    for decoder_name, sampler in PHASE6:
        mode, dual = MODE[decoder_name], sampler == "sorted2"
        kernel = negscore.kernel_name(mode, dual)
        what = f"{decoder_name} + {sampler}"
        over = dict(decoder_name=decoder_name, neg_sampler=sampler)
        module = KGEModule(**dict(TRAIN, **over)).to(dev)
        module.edge_layout = "dst"
        module.feature_table = feature_table
        module.configure_optimizers(num_training_steps=100)
        state = module.init_state(torch.Generator().manual_seed(SEED))
        sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
        step_gen = torch.Generator(device=dev).manual_seed(SEED)
        state, _ = module.train_steps(state, batches[:P6_WARMUP], step_gen)
        torch.cuda.synchronize()
        state, launches, _ = timed_steps(
            module, state, batches[P6_WARMUP:P6_WARMUP + P6_STEPS],
            step_gen, f"{what} train step")
        check(launches == expected_launches(SEGSUM_PER_STEP * P6_STEPS,
                                            kernel, P6_STEPS),
              f"{what}: launches per step: {launches}")
        if (decoder_name, sampler) == PROFILED6:
            profile_steps(module, state, batches[-PROFILED:], step_gen,
                          f"{what} train step")
        compare_step(sd, feature_table, dev, batch, kernel, what, **over)
        negatives = path_negatives(batch, gen, dual)
        nd_wide = path_negatives(batch, gen, False)[1] if dual else None
        records += negscore_records(
            mode, dual, encoded(module, batch), negatives,
            module.model.decoder.rel_emb.detach(), ds, launches, nd_wide)
        loss_falls(sd, feature_table, dev, batch, what, **over)

    proc, t0 = rotate_run
    ckpt = finish_train_kge(proc, "RotatE + sorted2", dm.graph, t0)
    served = serve_checkpoint(ckpt, tmp, "train_kge RotatE + sorted2")
    check(served.module.hparams["decoder_name"] == "rotate"
          and served.module.hparams["neg_sampler"] == "sorted2",
          "train_kge did not train RotatE with sorted2")
    serve_rotate_requests(served, np.random.default_rng(SEED))
    return records


def relmm_bound_ms(rows, din, dout, nb, r, dtype):
    """Least time for one grouped GEMM: msg, W and block_rel read once and
    the output written once over HBM bandwidth; its 2·rows·din·dout
    operations over the peak of the instance's unit (the bf16 tensor cores;
    float32 outside them, as full float32 must run)."""
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = (rows * (din + dout) + r * din * dout) * size + 4 * nb
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    t_ops = 2 * rows * din * dout / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def on_instance(instance: str):
    """A context in which relmm's wrapper takes ``instance``: the general
    ones by first_design_relmm, the redesigns where they fit."""
    if instance in relmm.GENERAL.values():
        return first_design_relmm()
    return contextlib.nullcontext()


def relmm_run(kernel, x, w, block_rel, instance):
    """``kernel`` on ``instance``, checking that the launch took it."""
    before = kernel.by_instance[instance]
    with on_instance(instance):
        out = kernel(x, w, block_rel)
    check(kernel.by_instance[instance] == before + 1,
          f"{kernel.name}: the launch did not take {instance}")
    return out


def relmm_check(what, msg, w, block_rel, gen, errs):
    """The forward and d_msg kernels, on the instance the wrapper picks and
    on the type's general one, against the plain version: each element
    within RELMM_RTOL of (|x| @ |W|); dW (the backward's float32 bmm +
    index_add_) against autograd through the plain version in float32
    within SUM_RTOL of Σ|msg||g|. Adds each (instance, direction)'s max abs
    error to ``errs``; returns the instances picked and the upstream
    gradient."""
    dtype, (r, din, dout) = msg.dtype, w.shape
    g = torch.randn(msg.shape[0], dout, device=msg.device,
                    generator=gen).to(dtype)
    plain = relmm.relation_matmul_sorted_plain
    picked, report = [], []
    for x, kernel in ((msg, relmm.FORWARD), (g, relmm.BACKWARD)):
        wp = w.transpose(1, 2) if kernel.transpose else w
        want = plain(x, wp, block_rel)
        mag = plain(x.abs().float(), wp.abs().float(), block_rel)
        picked.append(relmm.relmm_instance(
            dtype, x.shape[1], wp.shape[2], x.data_ptr(), w.data_ptr(), 0))
        for instance in dict.fromkeys((picked[-1], relmm.GENERAL[dtype])):
            got = relmm_run(kernel, x, w, block_rel, instance)
            err = (got.float() - want.float()).abs()
            ratio = float((err / mag.clamp(min=1e-30)).max())
            key = (instance, kernel.transpose)
            errs[key] = max(errs.get(key, 0.0), float(err.max()))
            report.append(f"{'d_msg' if kernel.transpose else 'forward'} "
                          f"[{instance}] {ratio:.3g} (max abs "
                          f"{float(err.max()):.3g})")
            check(bool(torch.all(err <= RELMM_RTOL[dtype] * mag)),
                  f"relmm {what} {kernel.name} [{instance}]: kernel "
                  f"disagrees with plain")
            del got, err
        del want, mag
    wf = w.float().requires_grad_(True)
    (dw_p,) = torch.autograd.grad(plain(msg.float(), wf, block_rel), wf,
                                  g.float())
    dw_k = relmm.weight_grad(msg, g, block_rel, r)
    mag = relmm.weight_grad(msg.abs(), g.abs(), block_rel, r)
    dw_ratio = float(((dw_k - dw_p).abs() / mag.clamp(min=1e-30)).max())
    torch.cuda.synchronize()
    print(f"relmm {what}: msg {tuple(msg.shape)} {str(dtype)[6:]}, W "
          f"{tuple(w.shape)}, block {relmm.block_size_of(msg, block_rel)}: "
          f"kernel vs plain max |err| / (|x|@|W|) (tol "
          f"{RELMM_RTOL[dtype]:g}): {'; '.join(report)}; dW vs plain "
          f"float32 {dw_ratio:.3g} of Σ|msg||g| (tol {SUM_RTOL:g})")
    check(dw_ratio <= SUM_RTOL, f"relmm {what}: dW disagrees with plain")
    return picked, g


def odd_relmm_checks(dev, errs):
    """The relmm kernels off the path, every instance of each type: a
    relation with no block (3 of 5), two trailing pad blocks (zero rows,
    relation 0), B of 64 and of 96 (rows then no multiple of the 64- and
    128-row tiles), at RELMM_ODD's widths: din 100 / dout 36 (the general
    bf16 instance) and the aligned 72 / 40, which wgmma takes."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for din, dout, block in RELMM_ODD:
        block_rel = torch.tensor([1, 0, 4, 2, 2, 1, 4, 0, 0], device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            msg = torch.randn(len(block_rel) * block, din, device=dev,
                              generator=gen)
            msg[-2 * block:] = 0
            w = torch.randn(5, din, dout, device=dev, generator=gen)
            picked, _ = relmm_check(f"odd shape {din}->{dout} B={block}",
                                    msg.to(dtype), w.to(dtype), block_rel,
                                    gen, errs)
            if din % 8 == 0 and dout % 8 == 0:
                check(picked == [relmm.FAST[dtype]] * 2,
                      f"relmm {din}->{dout} {dtype}: picked {picked}")


def relmm_times(msg, w, block_rel, g):
    """Device times (ms per call, device_ms), per direction: the
    redesigned instance and the general one (the first design) in turns
    (general, redesign, redesign, general), the plain version (its
    kernels' sum), one torch.bmm over the (nb, B, ·) block views against
    the (nb, din, dout) weight blocks gathered before timing (3.6 GB at the
    serving shape in float32), and dW (the backward's plain float32 bmm +
    index_add_); with the bounds. The products get block_rel as int32, so
    that the wrapper's cast launches nothing."""
    plain = relmm.relation_matmul_sorted_plain
    fast, general = relmm.FAST[msg.dtype], relmm.GENERAL[msg.dtype]
    wt = w.transpose(1, 2)
    nb = block_rel.shape[0]
    br32 = block_rel.int()
    out = {}
    for d, kernel, x in (("fwd", relmm.FORWARD, msg),
                         ("bwd", relmm.BACKWARD, g)):
        runs = {fast: [], general: []}
        for instance in (general, fast, fast, general):
            with on_instance(instance):
                runs[instance].append(device_ms(
                    lambda: kernel(x, w, br32)))
        out[d] = min(runs[fast])
        out[f"general_{d}"] = min(runs[general])
        out[f"runs_{d}"] = runs
    with torch.no_grad():
        out["plain_fwd"] = device_ms(lambda: plain(msg, w, br32))
        out["plain_bwd"] = device_ms(lambda: plain(g, wt, br32))
    out["dw"] = device_ms(lambda: relmm.weight_grad(msg, g, block_rel,
                                                    w.shape[0]))
    blocks_w = w[block_rel.long()]
    x3, g3 = msg.view(nb, -1, msg.shape[1]), g.view(nb, -1, g.shape[1])
    out["lib_fwd"] = device_ms(lambda: torch.bmm(x3, blocks_w))
    out["lib_bwd"] = device_ms(lambda: torch.bmm(g3,
                                                 blocks_w.transpose(1, 2)))
    del blocks_w
    r, din, dout = w.shape
    out["bound_fwd"] = relmm_bound_ms(msg.shape[0], din, dout, nb, r,
                                      msg.dtype)
    out["bound_bwd"] = relmm_bound_ms(msg.shape[0], dout, din, nb, r,
                                      msg.dtype)
    return out


def relmm_path_checks(dev, train_batch, full_batch, errs):
    """Phase 7a: the relmm kernels against their plain versions at the
    path's shapes (RGAT's layer-1 768 → 512 and hidden 256 → 512 products
    on its SAINT batch in bf16; the RGCN edge conv's 768 → 256 on the
    full-graph relation-layout batch in float32), where the wrapper must
    pick the redesigned instance; each timed beside the general instance,
    the plain version, one torch.bmm and dW. Returns the timings by type:
    RGAT's layer-1 shape (bf16), the edge conv's (float32)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    r, heads = HPARAMS["num_relation"], HPARAMS["num_heads"]
    cases = [("RGAT layer 1", train_batch, 768, heads * 256, torch.bfloat16),
             ("RGAT hidden", train_batch, 256, heads * 256, torch.bfloat16),
             ("edge conv (serving)", full_batch, 768, 256, torch.float32)]
    by_type = {}
    for what, batch, din, dout, dtype in cases:
        block_rel = batch.block_rel
        msg = torch.randn(batch.edge_type.shape[0], din, device=dev,
                          generator=gen) * batch.edge_mask[:, None]
        w = torch.randn(r, din, dout, device=dev, generator=gen) / din ** 0.5
        msg, w = msg.to(dtype), w.to(dtype)
        picked, g = relmm_check(what, msg, w, block_rel, gen, errs)
        check(picked == [relmm.FAST[dtype]] * 2,
              f"relmm {what}: the path shape picked {picked}")
        t = relmm_times(msg, w, block_rel, g)
        fast, general = relmm.FAST[dtype], relmm.GENERAL[dtype]
        for d in ("fwd", "bwd"):
            bound, by = t[f"bound_{d}"]
            print(f"relmm {what} {'forward' if d == 'fwd' else 'd_msg'} "
                  f"time ({str(dtype)[6:]}, {msg.shape[0]} rows, "
                  f"{din if d == 'fwd' else dout} -> "
                  f"{dout if d == 'fwd' else din}): {fast} {t[d]:.4f} ms, "
                  f"{general} (the first design) {t[f'general_{d}']:.4f} ms "
                  f"(runs in turn {general}, {fast}, {fast}, {general}: "
                  f"{t[f'runs_{d}'][general][0]:.4f}, "
                  f"{t[f'runs_{d}'][fast][0]:.4f}, "
                  f"{t[f'runs_{d}'][fast][1]:.4f}, "
                  f"{t[f'runs_{d}'][general][1]:.4f}), plain "
                  f"{t[f'plain_{d}']:.4f} ms, torch.bmm on gathered weight "
                  f"blocks {t[f'lib_{d}']:.4f} ms, bound {bound:.4f} ms "
                  f"({by}), {fast} at {bound / t[d]:.1%} of bound, "
                  f"{t[f'general_{d}'] / t[d]:.2f}x faster than {general}")
        print(f"relmm {what} dW (plain float32 bmm + index_add_): "
              f"{t['dw']:.4f} ms")
        by_type.setdefault(dtype, t)
        del msg, w, g
    torch.cuda.empty_cache()
    return by_type


def rgat_module(table, dev, **over):
    module = KGEModule(**dict(RGAT, **over)).to(dev)
    module.feature_table = table
    module.configure_optimizers(num_training_steps=100)
    return module


def rgat_train_phase(dm, dev, table):
    """Phase 7b: the RGAT step in bf16 (timed, profiled with its
    index_add_s split by call site, compared, the loss falling) and a few
    float32 steps (train_kge's default type, timed); returns the device
    batches and the relmm launches of the timed steps by type."""
    dm.edge_layout = "relation"
    loader = dm.train_dataloader(loader_type="saint")
    t0 = time.perf_counter()
    host = [loader.sample()[0] for _ in range(P7_WARMUP + P7_STEPS)]
    sample_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    batches = [batch_to_device(b, dev) for b in host]
    occupancy = (sum(int(b.edge_mask.sum()) for b in host[P7_WARMUP:])
                 / (P7_STEPS * loader.edge_budget))
    print(f"RGAT train envelope (relation layout): {loader.node_budget} node "
          f"slots, {loader.edge_budget} edge slots in "
          f"{host[0].block_rel.shape[0]} blocks of {loader.block_size}; "
          f"edge occupancy {occupancy:.4f}; host SAINT sampling "
          f"{sample_ms:.1f} ms per batch")

    module = rgat_module(table, dev)
    state = module.init_state(torch.Generator().manual_seed(SEED))
    sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state, _ = module.train_steps(state, batches[:P7_WARMUP], gen)
    torch.cuda.synchronize()
    state, launches, _ = timed_steps(module, state, batches[P7_WARMUP:], gen,
                                     "RGAT train step")
    want = expected_launches(0, "distmult_neg_scores", P7_STEPS,
                             tuple(n * P7_STEPS for n in RELMM_PER_STEP),
                             relmm_instance="wgmma")
    check(launches == want, f"RGAT launches per step: {launches}")
    profile_steps(module, state, batches[-PROFILED:], gen, "RGAT train step",
                  split_op="aten::index_add_")
    with first_design_relmm():
        profile_steps(module, state, batches[-PROFILED:], gen,
                      "RGAT train step with the first-design relmm "
                      "(wmma_general)")
    del module, state

    f32 = rgat_module(table, dev, compute_dtype="float32")
    state = f32.init_state(torch.Generator().manual_seed(SEED))
    state, _ = f32.train_steps(state, batches[:P7_F32_WARMUP], gen)
    torch.cuda.synchronize()
    state, f32_launches, _ = timed_steps(
        f32, state, batches[P7_WARMUP:P7_WARMUP + P7_F32_STEPS], gen,
        "RGAT train step float32")
    want = expected_launches(0, "distmult_neg_scores", P7_F32_STEPS,
                             tuple(n * P7_F32_STEPS for n in RELMM_PER_STEP),
                             relmm_instance="simt_f32")
    check(f32_launches == want,
          f"RGAT float32 launches per step: {f32_launches}")
    del f32, state

    compare_step(sd, table, dev, batches[0], "distmult_neg_scores", "RGAT",
                 segsum_n=0, relmm_n=RELMM_PER_STEP, encoder_name="rgat")
    loss_falls(sd, table, dev, batches[0], "RGAT", encoder_name="rgat")
    return batches, [launches, f32_launches]


def timed_encodes(module, batch, n=3):
    """``n`` encodes, host clock after a synchronise; (z, ms list)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = module.encode(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return z, times


def edge_conv_phase(module, full_batch):
    """Phase 7c: the RGCN edge conv's full-graph encode (float32, one
    relmm launch per conv, on simt_f32) against the node conv's z on the
    same relation-layout batch; returns the encodes' launches."""
    enc = module.model.encoder
    module.edge_layout = "relation"
    enc.conv_impl = "edge"
    reset_launch_counts()
    z_edge, ms = timed_encodes(module, full_batch)
    launches = launch_counts()
    with first_design_relmm():
        _, first_ms = timed_encodes(module, full_batch, 1)
    enc.conv_impl = "node"
    z_node, node_ms = timed_encodes(module, full_batch, 1)
    enc.conv_impl = "auto"
    module.edge_layout = "dst"
    check(launches == expected_launches(0, "distmult_neg_scores", 0,
                                        (3 * RELMM_PER_EDGE_ENCODE, 0),
                                        relmm_instance="simt_f32"),
          f"edge conv encode launches: {launches}")
    scale = float(z_node.abs().max())
    err = float((z_edge - z_node).abs().max())
    print(f"RGCN edge conv full-graph encode (float32, relation layout, "
          f"{full_batch.edge_type.shape[0]} edge slots): {ms} ms (host "
          f"clock, synchronised), {RELMM_PER_EDGE_ENCODE} relmm launches "
          f"per encode; with the first-design relmm (simt_f32_general) "
          f"{first_ms} ms; node conv on the same batch {node_ms} ms; z edge vs "
          f"node max_abs_err={err:.3g} (tol {Z_RTOL:g}·max|z| = "
          f"{Z_RTOL * scale:.3g})")
    check(bool(torch.isfinite(z_edge).all()), "edge conv z not finite")
    check(err <= Z_RTOL * scale, "edge conv z disagrees with the node conv")
    return launches


def serve_rgat(rgat_run, graph, tmp, dev):
    """Phase 7d: train_kge's RGAT checkpoint served (a float32 full-graph
    RGAT encode in the relation layout, on simt_f32), its encode timed and
    its z held against the same encode with the plain versions, its answers
    checked against float64; returns the serving encode's launches."""
    proc, t0 = rgat_run
    ckpt = finish_train_kge(proc, "RGAT", graph, t0)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    served = serve_checkpoint(ckpt, tmp, "train_kge RGAT")
    launches = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(type(served.module.model.encoder).__name__ == "RGAT"
          and served.module.edge_layout == "relation",
          "train_kge did not train RGAT / not served in the relation layout")
    check(launches == expected_launches(0, "distmult_neg_scores", 0,
                                        (RELMM_PER_RGAT_ENCODE, 0),
                                        relmm_instance="simt_f32"),
          f"RGAT serving encode launches: {launches}")
    batch = batch_to_device(
        FullGraphLoader(served.dm.graph, edge_layout="relation").batch(), dev)
    z, ms = timed_encodes(served.module, batch, 2)
    with plain_versions():
        z_plain, plain_ms = timed_encodes(served.module, batch, 1)
    with first_design_relmm():
        _, first_ms = timed_encodes(served.module, batch, 1)
    scale = float(z_plain.abs().max())
    err = float((z - z_plain).abs().max())
    n = served.z.shape[0]
    check(bool(torch.isfinite(z).all()), "RGAT served z not finite")
    check(err <= Z_RTOL * scale,
          "RGAT served encode with the kernels disagrees with the plain "
          "versions")
    check(float((z[:n] - served.z).abs().max())
          <= Z_RTOL * float(served.z.abs().max()),
          "RGAT re-encode disagrees with the served z")
    del z_plain
    lat = serve_requests(served, np.random.default_rng(SEED))
    print(f"RGAT served: full-graph encode {ms} ms (host clock, "
          f"synchronised, {RELMM_PER_RGAT_ENCODE} relmm launches), with the "
          f"plain versions {plain_ms} ms, with the first-design relmm "
          f"(simt_f32_general) {first_ms} ms; z kernel vs plain "
          f"max_abs_err={err:.3g} (tol {Z_RTOL:g}·max|z| = "
          f"{Z_RTOL * scale:.3g}); peak device memory over the scorer's "
          f"start-up {peak_gb:.2f} GB; requests {json.dumps(lat)}")
    return launches


def relmm_records(times, errs, path_launches):
    """One record per relmm instance and direction. The redesigned
    instances carry the main path's launches and must have some; the
    general ones (the first design, off the path) are timed at the same
    shape as their type's redesign and must have none."""
    records = []
    for dtype in (torch.bfloat16, torch.float32):
        t = times[dtype]
        for instance in (relmm.FAST[dtype], relmm.GENERAL[dtype]):
            for kernel in (relmm.FORWARD, relmm.BACKWARD):
                d = "bwd" if kernel.transpose else "fwd"
                n = sum(c[relmm_key(kernel, instance)] for c in path_launches)
                on_path = instance == relmm.FAST[dtype]
                check((n > 0) == on_path,
                      f"{relmm_key(kernel, instance)}: {n} main-path "
                      f"launches")
                bound, by = t[f"bound_{d}"]
                records.append({
                    "name": relmm_key(kernel, instance), "route": "cuda",
                    "source": "biomedkg_tpu_torch/csrc/relmm.cu",
                    "replaces": f"biomedkg_tpu/ops/pallas/relmm.py:"
                                f"{RELMM_REPLACES[kernel.transpose]}",
                    "launches": n,
                    "max_abs_err": errs[(instance, kernel.transpose)],
                    "ms": t[d] if on_path else t[f"general_{d}"],
                    "plain_ms": t[f"plain_{d}"], "bound_ms": bound,
                    "bound_by": by, "library_ms": t[f"lib_{d}"]})
    return records


def rgat_phase(dm, dev, tmp, table, rgat_run, scorer_module):
    """Phase 7; returns the relmm instances' records."""
    errs = {}
    odd_relmm_checks(dev, errs)
    batches, launches = rgat_train_phase(dm, dev, table)
    full_batch = batch_to_device(
        FullGraphLoader(dm.graph, edge_layout="relation").batch(), dev)
    times = relmm_path_checks(dev, batches[0], full_batch, errs)
    launches.append(edge_conv_phase(scorer_module, full_batch))
    del full_batch, batches
    torch.cuda.empty_cache()
    launches.append(serve_rgat(rgat_run, dm.graph, tmp, dev))
    return relmm_records(times, errs, launches)


# -- phase 8: Stage B GCL pretraining and the flash InfoNCE kernels --------

def flash_bound_ms(n: int, d: int, dtype, backward: bool):
    """Least time for one flash_denom call, as (ms, "bytes" or
    "operations", the term that sets it): an and bn read once and the
    outputs written once (backward: col, den and g in, d_an and d_bn out)
    over HBM bandwidth; the products over the peak of the instance's unit
    (forward two N x N x d products, backward six: the logits rebuilt once
    and the four cotangent products); the exps on the special-function
    units (2 N^2 each way)."""
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = 2 * n * d * size + 8 * n
    if backward:
        nbytes += 8 * n + 2 * n * d * size
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        f"{str(dtype)[6:]} operations": (6 if backward else 2) * 2 * n * n
        * d / peak * 1e3,
        "special-function operations": 2 * n * n / SFU_OP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def unit_rows(n: int, d: int, gen, dtype) -> torch.Tensor:
    x = torch.randn(n, d, device=gen.device, generator=gen)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype).contiguous()


def flash_check(an, bn, col, g, what: str):
    """The flash kernels against the plain version on one input: the
    denominators (float32 within FLASH_TOL of |den| per row; bf16 within
    FLASH_TOL absolute of the float32 plain version's) and d_an, d_bn
    (within FLASH_TOL of their max, against the plain version in the same
    type); returns (max abs den error, max abs gradient error)."""
    dtype = an.dtype
    den_k = flashnce.FORWARD(an, bn, col, GCL_TAU)
    grads_k = flashnce.BACKWARD(an, bn, col, den_k, g, GCL_TAU)
    den_32 = flashnce.denominators_plain(an.float(), bn.float(), col,
                                         GCL_TAU)
    den_p = den_32 if dtype == torch.float32 else \
        flashnce.denominators_plain(an, bn, col, GCL_TAU)
    grads_p = flashnce.denominator_grads_plain(an, bn, col, den_p, g,
                                               GCL_TAU)
    torch.cuda.synchronize()
    val_tol, grad_tol = FLASH_TOL[dtype]
    den_err = (den_k - den_32).abs()
    if dtype == torch.float32:
        den_ok = bool(torch.all(den_err <= val_tol
                                * den_32.abs().clamp(min=1.0)))
    else:
        den_ok = float(den_err.max()) <= val_tol
    errs = [rel_err(a, b) for a, b in zip(grads_k, grads_p)]
    grad_abs = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(grads_k, grads_p))
    print(f"flash {what} {str(dtype)[6:]}: N = {an.shape[0]}, d = "
          f"{an.shape[1]}, {int((col != 0).sum())} pad rows: den max abs "
          f"err {float(den_err.max()):.3g} (tol {val_tol:g}"
          f"{'·max(|den|, 1)' if dtype == torch.float32 else ''}); d_an, "
          f"d_bn rel-to-max {errs[0]:.3g}, {errs[1]:.3g} (tol {grad_tol:g})")
    check(den_ok, f"flash {what} {dtype}: denominators disagree")
    check(max(errs) <= grad_tol, f"flash {what} {dtype}: gradients disagree")
    return float(den_err.max()), grad_abs


def flash_inputs(n, d, pads, gen, dtype):
    an, bn = unit_rows(n, d, gen, dtype), unit_rows(n, d, gen, dtype)
    real = torch.arange(n, device=gen.device) < n - pads
    col = torch.where(real, 0.0, flashnce.NEG).float()
    g = torch.rand(n, device=gen.device, generator=gen) * real
    return an, bn, col, g


def flash_odd_checks(dev):
    """Phase 8a: both flash kernels against the plain version off the
    path: N no multiple of the 64-row tile, d of 100, 36 and 30 (the
    scalar tile loads), one case at d = 256 across tiles, with and without
    a padded tail."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    for n, d, pads in FLASH_ODD:
        for dtype in (torch.float32, torch.bfloat16):
            flash_check(*flash_inputs(n, d, pads, gen, dtype),
                        "off the path")


def flash_path_records(dev, node_mask, launches):
    """Phase 8c: both kernels at the path's shape (the neighbour batch's
    node slots, d = 256, its pad tail), float32 and bf16, against the plain
    version, timed beside their bounds; returns the two ``kernels``
    records (float32, the config's type)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    n, d = node_mask.shape[0], GCL["hidden_dim"]
    col = torch.where(node_mask, 0.0, flashnce.NEG).float()
    g = torch.rand(n, device=dev, generator=gen) * node_mask
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        an, bn = unit_rows(n, d, gen, dtype), unit_rows(n, d, gen, dtype)
        errs = flash_check(an, bn, col, g, "at the path's shape")
        den = flashnce.FORWARD(an, bn, col, GCL_TAU)
        t = {"fwd": time_ms(lambda: flashnce.FORWARD(an, bn, col, GCL_TAU)),
             "bwd": time_ms(lambda: flashnce.BACKWARD(an, bn, col, den, g,
                                                      GCL_TAU))}
        t["plain_fwd"] = time_ms(lambda: flashnce.denominators_plain(
            an, bn, col, GCL_TAU))
        t["plain_bwd"] = time_ms(lambda: flashnce.denominator_grads_plain(
            an, bn, col, den, g, GCL_TAU))
        for backward, key in ((False, "fwd"), (True, "bwd")):
            bound, by, term = flash_bound_ms(n, d, dtype, backward)
            print(f"flash_denom{'_bwd' if backward else ''} time "
                  f"({str(dtype)[6:]}, N = {n}, d = {d}): kernel "
                  f"{t[key]:.4f} ms, plain {t['plain_' + key]:.4f} ms, "
                  f"bound {bound:.4f} ms ({term}), kernel at "
                  f"{bound / t[key]:.1%} of bound; no single PyTorch call "
                  f"returns these denominators (attention kernels return a "
                  f"row logsumexp only through private ops, without the "
                  f"two-table concat, the column mask or the masked "
                  f"diagonal)")
        out[dtype] = (t, errs)
        del an, bn, den
    t, errs = out[torch.float32]
    records = []
    for backward, key in ((False, "fwd"), (True, "bwd")):
        name = flashnce.NAME + ("_bwd" if backward else "")
        bound, by, _ = flash_bound_ms(n, d, torch.float32, backward)
        records.append({
            "name": name, "route": "cuda",
            "source": "biomedkg_tpu_torch/csrc/flashnce.cu",
            "replaces": "biomedkg_tpu/ops/pallas/flashnce.py:"
                        f"{FLASH_REPLACES[backward]}",
            "launches": launches[name], "max_abs_err": errs[backward],
            "ms": t[key], "plain_ms": t["plain_" + key], "bound_ms": bound,
            "bound_by": by, "library_ms": None})
    return records


def gcl_module_for(cls, sd, table, dev, dtype):
    module = cls(**GCL, compute_dtype=str(dtype)[6:])
    module.load_state_dict(sd)
    module.to(dev)
    module.edge_layout = "dst"
    module.feature_table = table
    return module


def gcl_grads(module, batch, draws):
    loss, _ = module._forward_loss(batch, True, draws=draws)
    grads = torch.autograd.grad(loss, list(module.parameters()))
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def gcl_compare_step(cls, sd, table, dev, batch, flash_n: int,
                     dtypes=(torch.bfloat16, torch.float32)):
    """One batch's loss and every gradient with the kernels against the
    same step with the plain versions, the features scaled by
    COMPARE_FEATURE_SCALE; one step makes SEGSUM_PER_GCL_STEP segsum and
    ``flash_n`` + ``flash_n`` flash launches. The loss within
    STEP_TOL of max(|loss|, 1) (DGI's loss is a difference of two terms
    near log 2). Each gradient within STEP_TOL of its max. In bf16, a leaf
    whose plain bf16 gradient is itself further than STEP_TOL from the
    float32 gradient (plain versions, same draws) is rounding noise (it
    moves even with the plain version's row tiling); such a leaf is held
    within STEP_TOL of the step's largest gradient instead."""
    what = cls.model_name.upper()
    draws = None
    table = table * COMPARE_FEATURE_SCALE
    for dtype in dtypes:
        module = gcl_module_for(cls, sd, table, dev, dtype)
        if draws is None:
            draws = module.model.draw(
                torch.Generator(device=dev).manual_seed(SEED + 1),
                module._batch_features(batch), batch.edge_mask,
                batch.node_mask, True)
        reset_launch_counts()
        loss_k, grads_k = gcl_grads(module, batch, draws)
        used = launch_counts()
        reset_launch_counts()
        with plain_versions():
            loss_p, grads_p = gcl_grads(module, batch, draws)
            if dtype == torch.bfloat16:
                _, grads_32 = gcl_grads(
                    gcl_module_for(cls, sd, table, dev, torch.float32),
                    batch, draws)
        check(not any(launch_counts().values()),
              "the plain versions launched a kernel")
        check(used == expected_launches(SEGSUM_PER_GCL_STEP, None, 0,
                                        flash_n=flash_n),
              f"{what}: launches in one step: {used}")
        loss_tol, grad_tol = STEP_TOL[dtype]
        loss_err = abs(loss_k - loss_p) / max(abs(loss_p), 1.0)
        names = [n for n, _ in module.named_parameters()]
        errs = {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
        noise = {}
        if dtype == torch.bfloat16:
            top = max(float(g.float().abs().max()) for g in grads_p)
            noise = {n: float((a.float() - b.float()).abs().max()) / top
                     for n, a, b, c in zip(names, grads_k, grads_p, grads_32)
                     if rel_err(b, c) > grad_tol}
        bad = [n for n in names
               if (noise[n] if n in noise else errs[n]) > grad_tol]
        held = [n for n in names if n not in noise]
        worst = max(held, key=errs.get) if held else None
        note = (f"; bf16 noise leaves (plain bf16 over {grad_tol:g} of its "
                f"max from float32), error of the step's largest gradient: "
                + ", ".join(f"{n} {v:.3g}" for n, v in noise.items())
                if noise else "")
        print(f"{what} step {str(dtype)[6:]}, kernels vs plain: loss "
              f"{loss_k:.7f} vs {loss_p:.7f} (err {loss_err:.3g} of "
              f"max(|loss|, 1), tol {loss_tol:g}); gradients max "
              f"rel-to-max "
              + (f"{errs[worst]:.3g} ({worst}; tol {grad_tol:g})" if worst
                 else "none held (every leaf bf16 noise)") + note)
        check(loss_err <= loss_tol, f"{what} {dtype} step: loss disagrees")
        check(not bad, f"{what} {dtype} step: {bad} disagree")


def gcl_loss_falls(module, batch, what: str, steps: int):
    """``steps`` steps on one batch with fixed draws and no dropout: the
    first (lr 0) leaves the loss as it was, and the loss then falls."""
    module.configure_optimizers(num_training_steps=2 * steps)
    st = module.init_state()
    x = module._batch_features(batch).to(module.compute_dtype)
    draws = module.model.draw(
        torch.Generator(device=x.device).manual_seed(SEED + 2), x,
        batch.edge_mask, batch.node_mask, True)
    draws["dropout"] = [[torch.ones_like(m) for m in v]
                        for v in draws["dropout"]]
    losses = []
    for _ in range(steps):
        st, out = module.train_step(st, batch, draws=draws)
        losses.append(float(out["train_loss"]))
    print(f"{what} fixed-batch losses (lr 0 at step 0): "
          f"{[round(v, 6) for v in losses]}")
    check(abs(losses[1] - losses[0]) <= 1e-4 * abs(losses[0]),
          f"{what}: the first update (schedule(0) = 0) changed the loss")
    check(losses[-1] < losses[1], f"{what}: the loss did not fall on a "
                                  f"fixed batch")


def gcl_batches(dev, tmp):
    """The gene/protein graph's PrimeKG module and its first training
    neighbour batches, on the card."""
    dm = PrimeKGModule(**dict(PRIMEKG_DATA, node_type=GCL_NODE_TYPE,
                              data_dir=tempfile.mkdtemp(dir=tmp)), seed=SEED)
    dm.setup(stage="split")
    dm.edge_layout = "dst"
    dm.device_features = True
    loader = dm.train_dataloader(loader_type="neighbor")
    loader.set_epoch(0)
    t0 = time.perf_counter()
    host = list(itertools.islice(loader, P8_BATCHES))
    sample_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    nodes = [int(b.node_mask.sum()) for b in host]
    edges = [int(b.edge_mask.sum()) for b in host]
    print(f"GCL {GCL_NODE_TYPE[0]} graph: {dm.graph.num_nodes} nodes, "
          f"{dm.graph.num_edges} edges ({dm.train_data.graph.num_edges} in "
          f"the train split); neighbour envelope {loader.node_budget} node "
          f"x {loader.edge_budget} edge slots, {len(loader)} batches per "
          f"epoch; real nodes {nodes}, edges {edges}; host sampling "
          f"{sample_ms:.1f} ms per batch")
    return dm, [batch_to_device(b, dev) for b in host]


def grace_phase(dev, table, batches):
    """Phase 8b: the GRACE step at full width in bf16 and float32; returns
    the launches of its timed runs."""
    total = {}
    for dtype in (torch.bfloat16, torch.float32):
        warm, steps, profiled = P8_STEPS[dtype]
        what = f"GRACE {str(dtype)[6:]} train step"
        module = gcl_module.GRACEModule(**GCL, compute_dtype=str(dtype)[6:])
        module.to(dev)
        module.edge_layout = "dst"
        module.feature_table = table
        module.configure_optimizers(num_training_steps=100)
        state = module.init_state(torch.Generator().manual_seed(SEED))
        sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
        gen = torch.Generator(device=dev).manual_seed(SEED)
        state, _ = module.train_steps(state, batches[:warm], gen)
        torch.cuda.synchronize()
        state, launches, _ = timed_steps(
            module, state, batches[warm:warm + steps], gen, what,
            work=real_nodes)
        check(launches == expected_launches(
            SEGSUM_PER_GCL_STEP * steps, None, 0,
            flash_n=FLASH_PER_STEP * steps),
            f"{what}: launches {launches}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        profile_steps(module, state, batches[-profiled:], gen, what)
        gcl_compare_step(gcl_module.GRACEModule, sd, table, dev, batches[0],
                         FLASH_PER_STEP, dtypes=(dtype,))
        gcl_loss_falls(gcl_module_for(gcl_module.GRACEModule, sd, table, dev,
                                      dtype), batches[0], what,
                       P8_FALL_STEPS[dtype])
        del module, state
        torch.cuda.empty_cache()
    return total


def dgi_ggd_phase(dev, table, batch):
    """Phase 8d: one DGI and one GGD step at the same width, kernels
    against the plain versions (segsum 8, flash 0)."""
    for cls in (gcl_module.DGIModule, gcl_module.GGDModule):
        module = cls(**GCL)
        module.init(torch.Generator().manual_seed(SEED))
        sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
        gcl_compare_step(cls, sd, table, dev, batch, 0)


def start_train_gcl(tmp: str) -> subprocess.Popen:
    """``python -m biomedkg_tpu_torch.train_gcl`` (GRACE on gene/protein,
    the config's float32) on the card for a few steps of the
    PrimeKG++-scale graph, in its own directory under ``tmp``."""
    root = os.path.dirname(os.path.abspath(__file__))
    cwd = tempfile.mkdtemp(dir=tmp)
    return subprocess.Popen(
        [sys.executable, "-m", "biomedkg_tpu_torch.train_gcl",
         "model.model_name=grace", "data.node_type=gene",
         f"steps={TRAIN_GCL_STEPS}", "epochs=1", f"seed={SEED}",
         f"ckpt_dir={cwd}/ckpt"],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def encode_train_gcl(gcl_run, dm, dev):
    """Phase 8e: train_gcl's checkpoint through ``load_gcl_module``, the
    node type's full graph encoded on the card and on the CPU."""
    proc, t0 = gcl_run
    out, errs = proc.communicate(timeout=600)
    print(f"train_gcl GRACE ({time.perf_counter() - t0:.1f} s, rc "
          f"{proc.returncode}):", out.strip().replace("\n", " | "))
    check(proc.returncode == 0, f"train_gcl failed: {errs[-2000:]}")
    check(out.startswith(f"train_gcl: grace on {GCL_NODE_TYPE[0]}: "
                         f"{dm.graph.num_nodes} nodes, "
                         f"{dm.graph.num_edges} edges"),
          "train_gcl did not train on the gene/protein graph")
    ckpt = out.split("checkpoint: ")[-1].strip()
    check("/gcl/gene/grace_none_random_" in ckpt,
          f"train_gcl checkpoint path {ckpt}")
    loader = FullGraphLoader(dm.graph, edge_layout="dst")
    reset_launch_counts()
    module = gcl_module.load_gcl_module(ckpt, device=dev)
    module.edge_layout = "dst"
    z, ms = timed_encodes(module, batch_to_device(loader.batch(), dev), 2)
    launches = launch_counts()
    cpu = gcl_module.load_gcl_module(ckpt, device="cpu")
    cpu.edge_layout = "dst"
    z_cpu = cpu.encode(batch_to_device(loader.batch(), "cpu"))
    scale = float(z_cpu.abs().max())
    err = float((z.cpu() - z_cpu).abs().max())
    print(f"train_gcl checkpoint ({type(module).__name__}, "
          f"{module.hparams['compute_dtype']}) encoded over the full "
          f"{GCL_NODE_TYPE[0]} graph ({z.shape[0]} node slots): {ms} ms "
          f"(host clock, synchronised), launches {launches}; card vs CPU "
          f"max_abs_err={err:.3g} (tol {Z_RTOL:g}·max|z| = "
          f"{Z_RTOL * scale:.3g})")
    check(launches == expected_launches(2 * CONVS, None, 0),
          f"GCL encode launches: {launches}")
    check(bool(torch.isfinite(z).all()), "GCL encode: z not finite")
    check(err <= Z_RTOL * scale, "GCL encode: card disagrees with the CPU")
    return launches["sorted_segment_sum"]


def gcl_phase(dev, tmp, gcl_run):
    """Phase 8; returns the flash kernels' records and the segsum launches
    of its paths."""
    flash_odd_checks(dev)
    dm, batches = gcl_batches(dev, tmp)
    table = torch.as_tensor(dm.graph.x, dtype=torch.float32).to(dev)
    launches = grace_phase(dev, table, batches)
    records = flash_path_records(dev, batches[0].node_mask, launches)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for dtype in (torch.float32, torch.bfloat16):
        segsum_batch_times(batches[0], GCL["hidden_dim"], dtype, gen,
                           "GRACE step shape")
    dgi_ggd_phase(dev, table, batches[0])
    del batches
    torch.cuda.empty_cache()
    encode_segsum = encode_train_gcl(gcl_run, dm, dev)
    return records, launches["sorted_segment_sum"] + encode_segsum


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
    libraries = (segsum.LIBRARY, negscore.LIBRARY, relmm.LIBRARY,
                 flashnce.LIBRARY)
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

    with tempfile.TemporaryDirectory() as tmp:
        # -- 5. the training main path ------------------------------------
        (neg_records, train_segsum, batches, table, rotate_run, rgat_run,
         gcl_run) = train_phase(scorer.dm, dev, tmp)
        # -- 6. the other decoders and the dual-sorted sampler ------------
        neg_records += decoder_phase(scorer.dm, dev, tmp, batches, table,
                                     rotate_run)
        # -- 7. RGAT and the relation-layout edge conv --------------------
        del batches
        relmm_records = rgat_phase(scorer.dm, dev, tmp, table, rgat_run,
                                   scorer.module)
        # -- 8. Stage B: GCL pretraining and the flash kernels ------------
        del table
        torch.cuda.empty_cache()
        flash_records, gcl_segsum = gcl_phase(dev, tmp, gcl_run)

    ms, plain_ms, lib_ms, bound_ms, bound_by = timed["conv f32"]
    print(json.dumps({"kernels": [{
        "name": "sorted_segment_sum", "route": "cuda",
        "source": "biomedkg_tpu_torch/csrc/segsum.cu",
        "replaces": "biomedkg_tpu/ops/pallas/segsum.py:74",
        "launches": launches["sorted_segment_sum"] + train_segsum
        + gcl_segsum,
        "max_abs_err": max(results.values()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms}] + neg_records
        + relmm_records + flash_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
