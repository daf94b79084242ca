#!/usr/bin/env python3
"""On-card check of the PyTorch port (biomedkg_tpu_torch): the KGE serving
path, the KGE training step (RGCN and RGAT), Stage B's GCL pretraining
(GRACE, DGI, GGD), held-out evaluation and the Trainer, filtered ranking
and the unseen-node protocol, and the repo's own scripts on the config
layer with modality fusion and the LM and GCL embedding caches, and DPI
fine-tuning with the csv on-ramps and the reference's Lightning
checkpoints, at full width on one CUDA card (Hopper, sm_90a).

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
    kernel's launch count is set to 0 just before and read just after
    (the segsum's 5 all on the owner design's ``packed`` instance);
 3. the segsum against its plain torch version at the serving shapes: the
    conv's messages and the count table in float32 and bf16 (the count
    table exactly), ids in any order, -1 pads anywhere, one hub segment
    over a tenth of the slots, odd widths (SEGSUM_ODD_WIDTHS) in both
    types; the conv and the count table timed on the device in turns
    against the first design (``first_design_segsum``), beside the plain
    version, one index_add_ and the bound;
 4. the encode timed, its launch count per encode, its device-busy time
    with either segsum design, z with the kernels against z with the
    plain versions on the card, and a small graph on the card against the
    CPU path (the path the CPU tests hold against the JAX package);
 5. the training main path: the KGE training step on GraphSAINT batches of
    the same graph (128 roots, walk 10, fill 0.92, dst layout, block 256,
    device-resident features), RGCN 768→256×4 + DistMult, K = 10 sorted
    negatives, bf16 compute with float32 masters, Adam + cosine warm-up +
    clip 1.0. Warm-up steps, then TRAIN_STEPS timed steps (host clock after
    a synchronise, and CUDA events) with every kernel's launch count set to
    0 just before and read just after; ms per step, triplets per second,
    the envelope, peak memory and a torch.profiler breakdown of PROFILED
    steps with its idle share, and the same window with the first-design
    segsum and, apart, the first-design negscore backward
    (``first_design_negscore``) and forward (``first_design_negscore_fwd``);
    one batch's loss and every gradient with the kernels against the same
    step with the plain versions (bf16 and float32); the negscore kernels
    and the segsum kernel against their plain versions at the path's
    shapes, timed beside their bounds (the negscore kernels on the device:
    the forward in its redesign, "run", and in its first
    design, checked in both types and timed in turns in both, with the L2
    bytes each gathers; the backward in its owner design against the first
    design in turns);
    the owner design's bucket build against ``buckets_plain`` at the
    path's shape and at odd sizes, timed; the segsum at the step's conv
    (and tail-gather backward) shape and its count table, timed on the
    device against the first design; the device launches of one
    negscore backward call per design (torch.profiler; the owner's fill,
    bucket build and kernel, at most the first design's four); the loss
    falling on a fixed batch;
    ``python -m biomedkg_tpu_torch.train_kge`` on the card on the same
    PrimeKG++-scale graph (2 epochs of 3 steps, each validated on one
    SAINT val batch, then tested on the best checkpoint; with it,
    concurrently, the RotatE + "sorted2" run of phase 6, phase 7's RGAT run
    and phase 8's ``train_gcl`` run, 1 epoch each): every run's reference
    flow checked (at most 3 ``epoch=*-val_loss=*.ckpt`` files and a
    ``last.ckpt``, the test on the least ``val_loss`` of them, a
    metrics.jsonl with the epoch's train loss and ``val_*`` and ``test_*``
    keys, all finite, AUROC in [0, 1], one ``<relation>_pre`` per
    relation), and the checkpoint the test loaded served by ``KGEScorer``;
 6. the other decoders and the dual-sorted sampler on the same SAINT
    batches at full width: ComplEx, TransE and RotatE (γ = 12) with
    "sorted" negatives and all four decoders with "sorted2". For each:
    warm-up steps, then P6_STEPS timed steps with every launch count set to
    0 just before and read just after (the mode's streamed or dual-sorted
    negscore pair 1 + 1 per step, the forward on "run", the
    backward on the owner design with one bucket build, segsum 6); one
    batch's loss and every
    gradient with the kernels against the plain versions (bf16 and
    float32); the mode's two kernels against the plain version at the
    path's shapes (the dual-sorted ones also on an input whose nd is in any
    order, both types), timed beside their bounds; the loss falling on a
    fixed batch; for RotatE + "sorted2" a torch.profiler breakdown as in
    phase 5, with either design of each direction. Before them every
    negscore kernel, both designs of each direction, on small shapes off
    the path in both types (odd widths, d of 128 and 256, ids clipped, ns
    in any order, a dst band that wraps the id range, one src id over
    many blocks; RotatE below the distance's clamp in float32).
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
    on ``simt_f32``), one eval step on a SAINT val batch in each type
    with its launch counts (relmm 8 forwards, no d_msg, negscore and segsum
    0), loss and gradients with the kernels against the plain
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
    (a) both flash kernels, in the design ``flash_design`` picks
    (``wide_f32``; in bf16 ``wgmma_bf16`` where d is a multiple of 8,
    else ``skip_bf16``), in ``skip_bf16`` where ``wgmma_bf16`` runs, and
    in the first design (``first_f32``, ``first_bf16``), against the plain
    version off the path (N of 1,000, 333, 200, 130 and 700, d of 100, 72,
    36, 30, 136, 8 and 256, with and without a padded tail, every slot a
    pad, scattered pads, g nonzero on pads), float32 and bf16, and every
    flash kernel's registers and spills; (b) the GRACE training
    step at full width (GCN 768→256×4, projection 256→256→256, τ = 0.2,
    Adam with cosine warm-up 0.2, clip 1.0) on [30, 30, 30] neighbour
    batches of 128 seeds in the dst layout with device-resident
    features, in bf16 and in float32 (the config's type): warm-up steps,
    timed steps with every launch count set to 0 just before and read
    just after (segsum 8, flash 2 + 2 per step), one eval step on a
    neighbour val batch with its counts (segsum 8, flash 2 forwards, no
    backward), ms per step, nodes per
    second, the envelope, peak memory and a torch.profiler window, one
    with the first-design segsum, and one more on the first-design flash
    kernels (bf16 also on ``skip_bf16``);
    one batch's loss and every gradient with the kernels against the plain
    versions; the loss falling on a fixed batch; (c) both flash kernels at
    the path's shape (the envelope's node slots, d = 256, its pad tail),
    float32 and bf16, ``skip_bf16`` bitwise against ``first_bf16``, each
    path design timed against its first design (bf16 also ``skip_bf16``)
    in turns beside the bounds (over the envelope and over the live tile
    pairs) and the plain version, and the segsum at the step's shape (the
    batch's edge slots × 256 into its node slots, both types), timed on the
    device against the first design beside index_add_; (d) one DGI
    and one GGD step at the same width, kernels against plain versions
    (segsum 8, flash 0); (e) ``python -m biomedkg_tpu_torch.train_gcl
    model.model_name=grace data.node_type=gene`` (started beside phase 5's
    ``train_kge`` runs; validated and tested on whole neighbour epochs, the
    top-1 checkpoint kept and tested, ``val_loss`` and ``test_loss``
    logged), its checkpoint loaded by ``load_gcl_module`` and the full
    gene/protein graph encoded on the card and on the CPU;
 9. held-out evaluation and the Trainer, on the same graph at full width
    (RGCN 768→256×4 + DistMult, K = 10): (a) the KGE eval step on
    EVAL_BATCHES SAINT val batches in float32 and bf16, with the kernels
    (launch counts set to 0 just before and read just after: segsum 5 a
    batch, the count table and 4 convs, all on ``packed``; no negscore,
    no relmm: eval scores iid negatives by gathers) and with the plain
    versions on the same batches and iid negatives: preds and loss within
    STEP_TOL, the kernels' histogram within EVAL_PLAIN_MOVES of the
    slots' bins of the plain versions' (and the float32 kernels' beyond it
    from the bf16 kernels', so the gate sees an error of bf16's rounding),
    ``_reduce_eval_aux``'s histogram and counts equal to a host
    reduction of the card's own float32 sigmoid values, that sigmoid's
    bins against float64's (EVAL_MOVE_SHARE of the distinct scores, in
    float32), ``eval_epoch``'s point metrics within EVAL_METRIC_TOL; ms
    per eval batch (host clock, device busy) and ``_reduce_eval_aux``'s
    device time; (b), last, in a fresh process of its own
    (``chip_smoke.py trainer-vs-serial``: a torch.profiler window slows
    every later host step of its process): ``Trainer.fit`` over FIT_STEPS
    SAINT steps on the prefetch thread against the serial loop of
    sampling, copying and stepping, and with one batch an item (K = 1),
    ms per step in turns, each one's
    profiled idle share, and one more turn of each after the profiled
    ones (reported only); (c) is phase 5's check of the entry points' reference
    flow; (d) a resume on the card: 2 epochs of 3 float32 steps straight
    through, against 1 epoch, a save and a fresh Trainer resumed from it:
    the second epoch's losses within RESUME_RTOL, the final weights within
    RESUME_WEIGHT_SHARE of the second epoch's movement (L2; float32
    atomics: no two runs on the card are bit-equal), a repeat of the
    uninterrupted run printed beside.
    The segsum record's ``launches`` adds (a)'s;
10. filtered ranking, ``test_kge`` and the unseen-node protocol, run right
    after phase 2 on its checkpoint (before any torch.profiler session):
    (a) ``rank_eval``'s path (``rank_eval.rank_eval``) over the whole
    test split of the PrimeKG++-scale graph, both directions: the
    full-graph encode (launch counts set to 0 just before and read just
    after: segsum 5, nothing else), the time of each part (filter build,
    pair assembly, scan 1, scan 2 or the fallback, the encode), the pair
    count and path, and no rank below 1 before the floor (read through
    eval/ranking.py's ``_ranks_before_floor``); (b) RANK_BRUTE sampled
    test triples ranked in float64 on the card with the filter as a dense
    mask: a float32 rank may differ only by its candidates within
    NEAR_ERRORS times the largest measured float32 error of the true
    score (counted and printed), MRR within RANK_MRR_TOL; (c) ComplEx,
    TransE and RotatE (seeded weights on the same z) over OTHER_RANKED
    test triples, their chunk, times and peak memory, each held as in
    (b) on OTHER_BRUTE; (d) the learning check of tests/test_planted.py:
    ``planted_triplets``, RGCN 32→96→24 + DistMult, 800 full-batch
    epochs through ``train_fullbatch`` ("dst", "sorted"), tail-side
    filtered MRR >= PLANTED_MRR and Hits@10 >= PLANTED_HITS10; (e)
    ``train_kge`` with ``data.unseen_node_ratio=0.1
    model.cold_start_dropout=0.1`` (3 SAINT steps, its validation and
    test, started at the phase's start), then ``test_kge
    filter_neg=true`` on its checkpoint: finite ``unseen_*`` metrics, the
    unseen MRR in (0, 1]; in-process, COLD_STEPS cold-start bf16 steps
    with their launches counted (segsum 6, negscore 1 + 1 a step) and one
    step with the kernels against the plain versions under one injected
    keep mask, at phase 5's tolerances. The segsum record's ``launches``
    adds (a)'s, (d)'s and the cold-start steps', the DistMult negscore
    records' (d)'s and the cold-start steps';
11. the config layer and Stage B's multimodal remainder, after phase 9,
    in a working directory with configs/ linked and an LM cache seeded
    for all the graph's names ((2, 768) rows from a seed, L2-normalised
    over the modality axis, as Stage A writes them): first, alone on the
    card, the GGD + attention step of scripts/gcl.sh at full width (GCN
    768→256×4 over fused LM features, the configs' float32, [30, 30, 30]
    neighbour batches of 64 gene/protein seeds): P11_GGD steps timed
    (host clock, CUDA events) with their launches (segsum 8 a step) and a
    torch.profiler window whose matrix products are split between the
    fuser (models/fusion.py) and the GCN by a profiler range around the
    fuser's forward and the autograd nodes it made; (a)
    ``python -m biomedkg_tpu_torch.train_gcl`` with scripts/gcl.sh's
    arguments for gene, drug and disease (read from the script; 100
    epochs cut to 1 of P11_GCL_STEPS steps, validated and tested on whole
    neighbour epochs) and (d) ``train_kge`` with scripts/kge.sh's LM
    arguments and ``model.fuse_method=attention``, started together; (e)
    beside them, one batch's loss and every gradient with the kernels
    against the plain versions in bf16 and float32: GGD + attention,
    GRACE + ReDAF (the keep mask one of the shared draws; before it
    P11_GRACE bf16 steps with their launches, flash 2 + 2 a step); each
    run's reference flow checked as phase 5 checks it; (b) ``GCLEncode`` from the three checkpoints, one
    full-graph encode per type on the card (segsum 4 each), its rows
    against the plain versions' encode; (c) ``train_kge`` with
    scripts/kge.sh's NODE_INIT_METHOD=gcl arguments (2 epochs of
    P11_KGE_STEPS steps, validated, tested on the best checkpoint), and
    beside it, in a process of its own (``python3 chip_smoke.py
    kge-sh-shapes <dir>``, whose 768 x 18,432-slot SAINT batches are the
    first the negscore kernels and the bucket build see), the data module
    and the model train_kge builds from the script's arguments (batch 64,
    K = 1; RGCN 256→256×4 + DistMult): one batch's loss and every
    gradient with the kernels against the plain versions, GCL-initialised
    and LM-initialised with attention fusion, in bf16 and float32; the
    segsum at that batch's shape against its plain version; P11_STAGE_C
    float32 steps with their launches (segsum 6, negscore 1 + 1); the
    negscore pair and the bucket build against their plain versions at
    that shape (the ``k1_*`` keys of the DistMult and bucket records);
    then ``rank_eval`` and the ``serve`` loop on its checkpoint
    with the script's arguments. The segsum, DistMult negscore, bucket
    and bf16 flash records' ``launches`` add phase 11's counted paths;
12. DPI fine-tuning and the on-ramps, after phase 11: (a) the PrimeKG++-
    scale synthetic columns (1.3 M rows drawn) written as a csv with its
    SHA-256 in BIOMEDKG_KG_CSV_SHA256, read through BIOMEDKG_KG_CSV
    (rows per second on the host): node list, edge arrays and edge map
    equal to the in-memory build's, a wrong checksum refused; (b) phase
    2's model written as the reference's Lightning ``.ckpt`` (this
    script's own writer: ``torch.save`` of the ``state_dict`` in the
    reference's key vocabulary, an ``AttributeDict`` of hyper-parameters,
    ``global_step``) and served by ``KGEScorer`` (segsum 5 in its
    full-graph encode), z against the encode of the native checkpoint of
    the same weights (Z_RTOL of max|z|); (c) ``train_dpi`` with
    scripts/dpi.sh's arguments over ``synthetic_dpi(seed=43)`` (RGCN
    768→256×4 + DistMult, K = 1, 64 roots, float32; 100 epochs cut to
    P12_EPOCHS of P12_STEPS steps): from scratch (R = 1), warm-started
    from (b)'s Lightning file with the unseen-drug protocol
    (``data.unseen_node_ratio=0.1 data.unseen_node_types=[drug]``) and
    from the native checkpoint (both ``fix_edge_id`` 1): each run's
    reference flow, finite ``test_*`` metrics, and the warm starts'
    relation rows other than 1 moved only by the L2 term (each entry
    towards 0); (d) ``test_dpi`` with scripts/test_dpi.sh's arguments
    (K = 3, ``filter_neg=true``) on the from-scratch run's checkpoint;
    (e) in a process of its own (``python3 chip_smoke.py dpi-shapes
    <dir>``, whose 768 × 6,144-slot SAINT batches are the first the
    negscore kernels and the bucket build see): the DPI step from
    scratch (R = 1) and warm-started (R = 8, every slot on relation 1),
    RGCN in float32 and bf16 and an RGAT warm start (relmm 8 + 6, every
    block on relation 1), kernels against plain versions within
    STEP_TOL (in bf16 the RGAT leaves RGAT_DPI_CANCELLING, which cancel
    at this batch, held to the plain float32 gradients, no further than
    the plain bf16 ones plus STEP_TOL), d(rel)'s other rows exactly 0
    from the owner backward, the rows other than 1 of the step's relation
    gradient equal to the L2 term alone, timed steps with their launches
    (segsum 6, the count table on ``general`` at R = 1; negscore 1 + 1;
    RGAT relmm 8 + 6 on ``wgmma``), the negscore pair, the bucket build,
    the segsum and relmm at that shape against plain versions and timed
    beside their bounds (the ``dpi_*`` keys of the records); (f) a
    BIOMEDKG_DPI_CSV written from ``synthetic_dpi`` at PrimeKG++'s drug
    and gene counts with 78,000 edges drawn, eight rows given NA tokens:
    the DPI graph dropped exactly those rows, and ``train_dpi`` trains on
    it. The segsum, DistMult negscore, bucket and wgmma relmm records'
    ``launches`` add phase 12's counted paths.

The second-to-last line is the ``{"kernels": [...]}`` JSON record, the last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import io
import itertools
import json
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from biomedkg_tpu_torch import rank_eval, train_dpi, train_kge
from biomedkg_tpu_torch.config import CONFIG_DIR, cli_overrides, load_config
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.data import csv_columns, node_encoders
from biomedkg_tpu_torch.data.csv_columns import write_csv_columns
from biomedkg_tpu_torch.data.dpi import DPI
from biomedkg_tpu_torch.data.primekg import PrimeKG
from biomedkg_tpu_torch.data.node_encoders import RandomEncode
from biomedkg_tpu_torch.data.synthetic import (COLUMNS, PRIMEKG_RELATIONS,
                                               planted_triplets,
                                               synthetic_dpi,
                                               synthetic_triplets)
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.device import check_full_fp32
from biomedkg_tpu_torch.eval import ranking
from biomedkg_tpu_torch.interop.jax_params import to_jax_params
from biomedkg_tpu_torch.models import decoders, encoders
from biomedkg_tpu_torch.nn import dropout_mask
from biomedkg_tpu_torch.ops import (_build, flashnce, negscore, relmm,
                                    segment, segsum)
from biomedkg_tpu_torch.sampling import native
from biomedkg_tpu_torch.sampling.batch import batch_to_device
from biomedkg_tpu_torch.sampling.csr import CSRGraph
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader
from biomedkg_tpu_torch.serve import PRIMEKG_DATA, serve_loop
from biomedkg_tpu_torch.serving import KGEScorer
from biomedkg_tpu_torch.training.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
from biomedkg_tpu_torch.training import gcl_module
from biomedkg_tpu_torch.training.stepping import param_grads
from biomedkg_tpu_torch.training.trainer import Trainer
from biomedkg_tpu_torch.training.kge_module import (HistogramBinaryMetrics,
                                                    KGEModule, _mix_factor,
                                                    load_kge_module,
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
# the segsum off the path: widths the 16-byte packs cannot take in one type
# or the other (d = 100 is whole packs in float32 only)
SEGSUM_ODD_WIDTHS = (7, 100, 257)
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
# phase 8a: (N, d, pad rows) off the path, the pads a tail; bf16 takes
# wgmma_bf16 where d is a multiple of 8 (256, 72, 136, 8), else skip_bf16
FLASH_ODD = [(1000, 100, 0), (333, 36, 40), (1000, 36, 57), (333, 100, 0),
             (130, 256, 5), (200, 30, 9), (1000, 72, 57), (333, 136, 40),
             (130, 8, 5)]
# and pad layouts the pad-tile skip must not assume away (flash_inputs):
# (N, d, layout)
FLASH_PADS = [(1000, 100, "all pads"), (1000, 256, "scattered pads"),
              (333, 36, "scattered pads"), (1000, 100, "g on pads"),
              (700, 256, "g on pads"), (1000, 256, "all pads")]
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


def device_ms(fn, only: str = None) -> float:
    """The device time of one call of ``fn`` in ms, after warm-up: the
    kernels torch.profiler records over ITERS calls (those whose name
    holds ``only``, if given), each kernel's mean time a record times its
    records a call, summed. The host's time between kernels does not
    enter. CUPTI drops a record now and then (a kernel counted 18 or 19
    times over 20 calls), so a window's total would read low; the means
    do not. A window with no kernel in it is profiled again, and after
    PROFILE_TRIES such windows the CUDA-event time (time_ms, host gaps
    included) stands in, said so."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(ITERS):
                fn()
            torch.cuda.synchronize()
        ms = sum(e.self_device_time_total / e.count
                 * max(1, round(e.count / ITERS))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.count and (only is None or only in e.key)) / 1e3
        if ms > 0:
            return ms
    ms = time_ms(fn)
    print(f"device_ms: torch.profiler recorded no kernel in "
          f"{PROFILE_TRIES} windows; CUDA-event time {ms:.4f} ms used")
    return ms


def segsum_times(data, ids, n: int, what: str, exact: bool = False) -> dict:
    """The segsum kernel at one shape: against the plain version (exact
    for count tables, else SUM_RTOL of Σ|x| per segment), and timed on the
    device (device_ms) in turns against the first design (owner, first,
    first, owner; the first design's fill included), beside the plain
    version, one float32 index_add_ and the bound. Returns the numbers."""
    got = segsum.KERNEL(data, ids, n)
    want = segsum.segsum_plain(data, ids, n)
    scale = segsum.segsum_plain(data.abs(), ids, n)
    err = (got - want).abs()
    check(bool(torch.all(err <= (0.0 if exact else SUM_RTOL) * scale)),
          f"segsum kernel disagrees at the {what}")
    instance = segsum.segsum_instance(data.dtype, data.shape[1],
                                      data.data_ptr(), ids.data_ptr(),
                                      got.data_ptr())

    def timed(first: bool) -> float:
        with first_design_segsum() if first else contextlib.nullcontext():
            return device_ms(lambda: segsum.KERNEL(data, ids, n))
    turns = [timed(first) for first in (False, True, True, False)]
    ids64 = ids.long()
    yard = torch.zeros(n, data.shape[1], device=data.device)
    out = dict(ms=min(turns[0], turns[3]), first_ms=min(turns[1:3]),
               plain_ms=device_ms(lambda: segsum.segsum_plain(data, ids, n)),
               library_ms=device_ms(
                   lambda: yard.index_add_(0, ids64, data.float())),
               max_abs_err=float(err.max()))
    out["bound_ms"], out["bound_by"] = segsum_bound_ms(data, n)
    print(f"segsum {what} {str(data.dtype)[6:]} ({tuple(data.shape)} into "
          f"{n}), device times: {instance} {turns[0]:.4f} / {turns[3]:.4f} "
          f"ms, first (fill included) {turns[1]:.4f} / {turns[2]:.4f}; "
          f"plain {out['plain_ms']:.4f}, index_add_ {out['library_ms']:.4f}, "
          f"bound {out['bound_ms']:.4f} ({out['bound_by']}); {instance} at "
          f"{out['bound_ms'] / out['ms']:.1%} of bound, first at "
          f"{out['bound_ms'] / out['first_ms']:.1%}; max abs err "
          f"{out['max_abs_err']:.3g}")
    return out


def count_table(etype, emask, r: int) -> torch.Tensor:
    """The RGCN's (edge slots, R) float32 one-hots of the real edges'
    relations, as models/encoders.py sums them by dst."""
    return ((etype[:, None] == torch.arange(r, device=etype.device)[None, :])
            & emask[:, None].bool()).float()


def segsum_batch_times(batch, d: int, dtype, gen, what: str,
                       counts: bool = False):
    """segsum_times at a batch's shape: (edge slots, d) random messages in
    ``dtype`` into its node slots by its dst ids; with ``counts``, also
    its count table."""
    dst = batch.edge_index[1].int()
    n_pad = batch.node_mask.shape[0]
    data = torch.randn(dst.shape[0], d, device=dst.device,
                       generator=gen).to(dtype)
    segsum_times(data, dst, n_pad, what)
    if counts:
        segsum_times(count_table(batch.edge_type, batch.edge_mask,
                                 HPARAMS["num_relation"]), dst, n_pad,
                     f"{what} count table", exact=True)


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
    d = z.shape[1]
    terms = {
        "bytes": neg_bytes(mode, z, m, r, backward) / HBM_BYTES_PER_S * 1e3,
        "float32 operations": NEG_FLOPS[mode][backward] * m * d
        / FP32_FLOP_PER_S * 1e3,
        "special-function operations": NEG_SFU.get(mode, (0, 0))[backward]
        * m * (d // 2) / SFU_OP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def neg_bytes(mode, z, m, r, backward: bool) -> int:
    """The bytes one negscore call must move: the z table, three int32
    index arrays, the float32 relation table and the scores; backward also
    ds in, and dz (in z's type) and the relation gradient out."""
    n, d = z.shape
    nbytes = n * d * z.element_size() + 3 * 4 * m + r * d * 4 + 4 * m
    if backward:
        dr = d // 2 if mode == "rotate" else d
        nbytes += n * d * z.element_size() + r * dr * 4
    return nbytes


def owner_l2_bytes(z, m: int) -> int:
    """What the owner backward reads from L2 per call: each slot's other
    endpoint's row once in each of its two owners' walks, and per walk
    the slot id and the slot's other id, relation and ds (4 bytes each);
    each owner's own row once."""
    n, d = z.shape
    return 2 * m * (d * z.element_size() + 16) + n * d * z.element_size()


def relmm_key(kernel, instance: str) -> str:
    return f"{kernel.name}[{instance}]"


def launch_counts() -> dict:
    """Every kernel's launches; the segsum's and relmm's also by instance,
    the flash kernels' and the negscore backwards' by design."""
    return {"sorted_segment_sum": segsum.KERNEL.launches,
            **{relmm_key(segsum.KERNEL, inst): c
               for inst, c in segsum.KERNEL.by_instance.items()},
            **{name: k.launches for name, k in negscore.KERNELS.items()},
            **{relmm_key(k, design): c for k in negscore.KERNELS.values()
               for design, c in getattr(k, "by_design", {}).items()},
            negscore.BUCKETS_NAME: negscore.BUCKETS.launches,
            **{name: k.launches for name, k in relmm.KERNELS.items()},
            **{relmm_key(k, inst): c for k in relmm.KERNELS.values()
               for inst, c in k.by_instance.items()},
            **{name: k.launches for name, k in flashnce.KERNELS.items()},
            **{relmm_key(k, design): c for k in flashnce.KERNELS.values()
               for design, c in k.by_design.items()}}


def reset_launch_counts():
    segsum.KERNEL.reset()
    negscore.BUCKETS.launches = 0
    for k in negscore.KERNELS.values():
        if hasattr(k, "reset"):
            k.reset()
        else:
            k.launches = 0
    for k in (*relmm.KERNELS.values(), *flashnce.KERNELS.values()):
        k.reset()


def expected_launches(segsum_n: int, kernel, n: int, relmm_n=(0, 0),
                      flash_n: int = 0, relmm_instance: str = None,
                      flash_design: str = None,
                      neg_design: str = "owner") -> dict:
    """Every count 0 but segsum's (all of them on the owner design's
    ``packed`` instance), the ``kernel`` negscore pair's (none
    when ``kernel`` is None), its forward's all on the redesign "run"
    (both families), its backward's all on
    ``neg_design`` (the owner design's with one bucket build each),
    relmm's (forward, d_msg),
    all of them on ``relmm_instance``, and the flash pair's (forward,
    backward), all of them on ``flash_design``."""
    want = dict.fromkeys(launch_counts(), 0)
    want.update({"sorted_segment_sum": segsum_n,
                 relmm_key(segsum.KERNEL, "packed"): segsum_n,
                 relmm.NAME: relmm_n[0],
                 relmm.NAME + "_bwd": relmm_n[1], flashnce.NAME: flash_n,
                 flashnce.NAME + "_bwd": flash_n})
    if any(relmm_n):
        want[relmm_key(relmm.FORWARD, relmm_instance)] = relmm_n[0]
        want[relmm_key(relmm.BACKWARD, relmm_instance)] = relmm_n[1]
    if flash_n:
        for k in flashnce.KERNELS.values():
            want[relmm_key(k, flash_design)] = flash_n
    if kernel is not None:
        fwd = negscore.KERNELS[kernel]
        want.update({kernel: n, kernel + "_bwd": n,
                     relmm_key(fwd, "run"): n,
                     relmm_key(negscore.KERNELS[kernel + "_bwd"],
                               neg_design): n})
        if neg_design == "owner":
            want[negscore.BUCKETS_NAME] = n
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


@contextlib.contextmanager
def segsum_instance_as(instance: str):
    """The segsum wrapper running ``instance`` for every call."""
    saved = segsum.segsum_instance
    segsum.segsum_instance = lambda *_: instance
    try:
        yield
    finally:
        segsum.segsum_instance = saved


def first_design_segsum():
    """The segsum wrapper running the first design (``first_kernel``: one
    element a lane into a zero-filled output, float32 atomics) for every
    call: the A/B of the owner design on its paths."""
    return segsum_instance_as("first")


@contextlib.contextmanager
def negscore_design_as(design: str):
    """The negscore backward wrappers running ``design`` for every call."""
    saved = negscore.negscore_design
    negscore.negscore_design = lambda *_: design
    try:
        yield
    finally:
        negscore.negscore_design = saved


def first_design_negscore():
    """The negscore backward wrappers running the first design
    (``bwd_kernel`` / ``ds_bwd_kernel``, float32 atomics on dz) for every
    call: the A/B of the owner design on its paths."""
    return negscore_design_as("first")


@contextlib.contextmanager
def negscore_fwd_design_as(design: str):
    """The negscore forward wrappers running ``design`` for every call."""
    saved = negscore.negscore_fwd_design
    negscore.negscore_fwd_design = lambda *_: design
    try:
        yield
    finally:
        negscore.negscore_fwd_design = saved


def first_design_negscore_fwd():
    """The negscore forward wrappers running the first design
    (``fwd_kernel`` / ``ds_fwd_kernel``: both rows gathered every slot)
    for every call: the A/B of "run" on both families' paths."""
    return negscore_fwd_design_as("first")


@contextlib.contextmanager
def flash_designs(by_type: dict):
    """The flash wrappers running ``by_type[dtype]`` (a design per type;
    a type not named keeps its path design)."""
    saved = flashnce.flash_design
    flashnce.flash_design = \
        lambda dtype, *shape: by_type.get(dtype) or saved(dtype, *shape)
    try:
        yield
    finally:
        flashnce.flash_design = saved


def on_flash_design(design: str):
    """The flash wrappers running ``design`` for its type."""
    return flash_designs({flashnce.DESIGNS[design]: design})


def first_design_flash():
    """The flash wrappers running the first design (every tile computed)
    in both types: the A/B of the redesign and the skip."""
    return flash_designs(flashnce.FIRST)


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
    ``batch``, and its cold-start draws (``{"cold_keep": mask}`` where it
    trains with ``cold_start_dropout``, else ``{}``)."""
    num_edges = batch.edge_type.shape[0]
    nreal = batch.node_mask.sum().clamp(min=1)
    negatives = sample_negatives_sorted(
        gen, module.neg_ratio, num_edges, nreal,
        dual=module.neg_sampler == "sorted2")
    n = batch.node_mask.shape[0]
    masks = [dropout_mask((n, dout), encoders.DROPOUT, gen, gen.device)
             for _, dout in module.model.encoder.dims[:-1]]
    if module.cold_start_dropout > 0.0:
        return negatives, masks, {"cold_keep": torch.rand(
            n, generator=gen, device=gen.device) >= module.cold_start_dropout}
    return negatives, masks, {}


def step_grads(module, batch, negatives, masks, cold=None):
    """The loss and every gradient of one training step (``cold``: the
    cold-start draws)."""
    loss, _ = module._forward_loss(batch, True, negatives=negatives,
                                   dropout_masks=masks, **(cold or {}))
    grads = param_grads(loss, dict(module.named_parameters()))
    torch.cuda.synchronize()
    return float(loss.detach()), grads


# gradients that are zero in exact arithmetic: attention fusion's key bias
# (a softmax row is invariant to a shift of all its logits), so both runs
# hold rounding noise there, held to the tolerance of the step's largest
# gradient (tests/test_torch_fusion.py holds it to the fuser's largest)
SHIFT_INVARIANT = ("fusion.k.b",)


def shift_invariant_errors(names, grads_k, grads_p) -> dict:
    """The SHIFT_INVARIANT leaves' errors relative to the step's largest
    gradient."""
    top = max(float(g.float().abs().max()) for g in grads_p)
    return {n: float((a.float() - b.float()).abs().max()) / top
            for n, a, b in zip(names, grads_k, grads_p)
            if n in SHIFT_INVARIANT}


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


# every kernel's launches over the timed steps of every path
PATH_LAUNCHES = {}


def timed_steps(module, state, batches, gen, what: str, work=triplets):
    """Run ``batches`` with every launch count set to 0 just before and
    read just after (and added into PATH_LAUNCHES); returns (state,
    launches, ms per step)."""
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
    for name, count in launches.items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + count
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


def eval_launches(module, batch, what: str, want: dict) -> dict:
    """One held-out step of ``module`` on ``batch`` with every launch
    count set to 0 just before and read just after (and added into
    PATH_LAUNCHES), held to ``want``; returns the counts."""
    gen = torch.Generator(device=batch.edge_mask.device).manual_seed(SEED)
    reset_launch_counts()
    out = module.eval_step(batch, gen)
    torch.cuda.synchronize()
    launches = launch_counts()
    for name, count in launches.items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + count
    print(f"{what} eval step: launches "
          f"{({k: v for k, v in launches.items() if v})}")
    check(launches == want, f"{what} eval step: launches {launches}")
    check(all(bool(torch.isfinite(v).all()) for v in out.values()),
          f"{what} eval step: not finite")
    return launches


def profile_steps(module, state, batches, gen, what: str,
                  split_op: str = None, fusion_ops=()):
    """Device busy time by kernel and host time by op over one profiled
    window of ``batches`` (torch.profiler), and the idle share against the
    same window's CUDA-event wall time; with ``split_op``, that op's calls
    by call site (the window then records Python stacks); with
    ``fusion_ops``, those ops' calls split between the module's fuser and
    the rest (split_by_fusion)."""
    steps = len(batches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA],
            with_stack=split_op is not None) as prof, \
            fusion_range(module) if fusion_ops else contextlib.nullcontext():
        start.record()
        module.train_steps(state, batches, gen)
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / steps
    events = prof.key_averages()
    # the fuser's range also shows on the device's timeline: not a kernel
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.key != FUSION_RANGE),
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
    if fusion_ops:
        split_by_fusion(prof, fusion_ops, steps, what)


# the torch.profiler range the GGD + attention window puts around the
# fuser's forward; its backward is found by the autograd nodes the range
# created (an evaluate_function event carries its node's sequence number)
FUSION_RANGE = "fusion"
BACKWARD_EVENT = "autograd::engine::evaluate_function: "


@contextlib.contextmanager
def fusion_range(module):
    """``module.fusion``'s forward inside a torch.profiler range named
    FUSION_RANGE."""
    forward = module.fusion.forward

    def ranged(*args, **kwargs):
        with torch.profiler.record_function(FUSION_RANGE):
            return forward(*args, **kwargs)

    module.fusion.forward = ranged
    try:
        yield
    finally:
        del module.fusion.forward


def ancestor(event, pred):
    parent = event.cpu_parent
    while parent is not None and not pred(parent):
        parent = parent.cpu_parent
    return parent


def split_by_fusion(prof, ops, steps: int, what: str):
    """``ops``' calls in a window run under ``fusion_range``, split into
    the fuser's and the rest's, forward and backward, each with the device
    time of the kernels they launched, per step."""
    events = prof.events()
    in_fusion = [e for e in events
                 if ancestor(e, lambda p: p.name == FUSION_RANGE)]
    nodes = {e.sequence_nr for e in in_fusion if e.sequence_nr >= 0}
    fused = {id(e) for e in in_fusion}
    parts = {}
    for e in events:
        if e.name not in ops:
            continue
        node = ancestor(e, lambda p: p.name.startswith(BACKWARD_EVENT))
        if node is None:
            key = ("fuser" if id(e) in fused else "rest", "forward")
        else:
            key = ("fuser" if node.sequence_nr in nodes else "rest",
                   "backward")
        ms, count = parts.get(key, (0.0, 0))
        parts[key] = (ms + e.device_time_total / 1e3, count + 1)
    total = sum(ms for ms, _ in parts.values())
    fuser = sum(ms for (who, _), (ms, _) in parts.items() if who == "fuser")
    check(total > 0 and any(who == "fuser" for who, _ in parts),
          f"{what}: no {'/'.join(ops)} call recorded in the fuser's range")
    print(f"{what} {' + '.join(ops)} by owner (torch.profiler range "
          f"{FUSION_RANGE!r} around the fuser's forward, its backward by "
          f"autograd node; device ms per step): {total / steps:.3f} ms, of "
          f"which the fuser {fuser / steps:.3f} ms ({fuser / total:.1%}); "
          + "; ".join(f"{who} {side} x{count / steps:g} {ms / steps:.3f} ms"
                      for (who, side), (ms, count) in sorted(parts.items())))


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


def step_launches(hp, steps: int, kernel, dtype, segsum_n=SEGSUM_PER_STEP,
                  relmm_n=(0, 0)) -> dict:
    """expected_launches of ``steps`` steps of a KGE module with hparams
    ``hp``. The RGCN's count table is (slots, R) float32: at R = 1 (DPI
    from scratch) a row is no whole 16-byte pack, so that segsum takes the
    ``general`` instance."""
    want = expected_launches(segsum_n * steps, kernel, steps,
                             tuple(k * steps for k in relmm_n),
                             relmm_instance=relmm.FAST[dtype])
    table = segsum.segsum_instance(torch.float32, hp["num_relation"], 0)
    if segsum_n and table != "packed":
        want[relmm_key(segsum.KERNEL, "packed")] -= steps
        want[relmm_key(segsum.KERNEL, table)] += steps
    return want


def pinned_rows_l2_only(step, grads, fix: int) -> float:
    """With every edge on relation ``fix``, the relation table's other rows
    get the L2 term's gradient alone (2·1e-2·p / numel): its error."""
    names = [n for n, _ in step.named_parameters()]
    rel = step.model.decoder.rel_emb.detach()
    others = torch.arange(rel.shape[0], device=rel.device) != fix
    return rel_err(grads[names.index("model.decoder.rel_emb")][others],
                   2e-2 * rel[others] / rel.numel())


def compare_step(sd, feature_table, dev, batch, kernel: str, what: str,
                 segsum_n=SEGSUM_PER_STEP, relmm_n=(0, 0), fix=None,
                 cancelling=(), **over):
    """One batch's loss and every gradient with the kernels against the
    same step with the plain versions, in bf16 and float32, each gradient
    within STEP_TOL of the plain version's; one step makes ``segsum_n``
    segsum launches and ``relmm_n`` relmm ones. ``fix``: the step's
    ``fix_edge_id``, and then the relation rows other than ``fix`` get
    exactly the L2 term's gradient from both runs. ``cancelling``: leaves
    whose gradient is a cancelling sum at this batch, so that bf16
    rounding in either version lies far above its own max; in bf16 each
    is held no further from the plain float32 gradient than the plain
    bf16 one is, plus STEP_TOL."""
    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        step = train_module(sd, feature_table, dev,
                            compute_dtype=str(dtype)[6:], **over)
        step.fix_edge_id = fix
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
        check(used == step_launches(dict(TRAIN, **over), 1, kernel, dtype,
                                    segsum_n, relmm_n),
              f"{what}: launches in one step: {used}")
        l2_err = (max(pinned_rows_l2_only(step, grads_k, fix),
                      pinned_rows_l2_only(step, grads_p, fix))
                  if fix is not None else None)
        runs[dtype] = loss_k, loss_p, grads_k, grads_p, l2_err
        names = [n for n, _ in step.named_parameters()]
    check(not set(cancelling) - set(names),
          f"{what}: no leaf {set(cancelling) - set(names)}")
    for dtype, (loss_k, loss_p, grads_k, grads_p, l2_err) in runs.items():
        loss_tol, grad_tol = STEP_TOL[dtype]
        if dtype == torch.bfloat16 and kernel.startswith("transe"):
            grad_tol = TRANSE_GRAD_TOL_BF16
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        errs = {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
        errs.update(shift_invariant_errors(names, grads_k, grads_p))
        anchored = ""
        if dtype == torch.bfloat16:
            ref = dict(zip(names, runs[torch.float32][3]))
            for n, a, b in zip(names, grads_k, grads_p):
                if n in cancelling:
                    k_far, p_far = rel_err(a, ref[n]), rel_err(b, ref[n])
                    anchored += (f"; {n} (cancels) kernels vs plain "
                                 f"{errs[n]:.3g}, against the plain float32 "
                                 f"gradient the kernels' {k_far:.3g}, the "
                                 f"plain bf16 {p_far:.3g} (tol: the plain "
                                 f"bf16 one + {grad_tol:g})")
                    errs[n] = k_far - p_far
        worst = max(errs, key=errs.get)
        over_tol = sorted(n for n in errs if errs[n] > grad_tol)
        pinned = (f"; rows other than {fix} of d(rel_emb) against the L2 "
                  f"term alone {l2_err:.3g} (tol 1e-5)"
                  if l2_err is not None else "")
        print(f"{what} step {str(dtype)[6:]}, kernels vs plain: loss "
              f"{loss_k:.7f} vs {loss_p:.7f} (rel {loss_err:.3g}, tol "
              f"{loss_tol:g}); gradients max rel-to-max {errs[worst]:.3g} "
              f"({worst}; tol {grad_tol:g})" + anchored + pinned
              + (f"; over the tolerance: {over_tol}" if over_tol else ""))
        check(loss_err <= loss_tol, f"{what} {dtype} step: loss disagrees")
        check(not over_tol, f"{what} {dtype} step: {over_tol} disagree")
        check(l2_err is None or l2_err <= 1e-5,
              f"{what} {dtype}: a relation row other than {fix} got a data "
              "gradient")


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


def fwd_l2_bytes(design: str, z, ns) -> int:
    """A model, not a measurement, of what one forward call of ``design``
    gathers from L2: the three int32 ids a slot, and rows of z: the first
    design both rows every slot; "run" t every slot and h once a run of
    equal ns. The least: "run" also reloads h where a warp's run starts,
    and once a pass and a group where ns changes."""
    m, row = ns.shape[0], z.shape[1] * z.element_size()
    if design == "first":
        return 12 * m + 2 * m * row
    runs = 1 + int((ns[1:] != ns[:-1]).sum())
    return 12 * m + (m + runs) * row


def negscore_records(mode, dual, z, negatives, rel_emb, ds, launches,
                     nd_wide=None):
    """The (mode, family) forward and backward kernels against the plain
    version at the path's shapes (scores, dz, the relation gradient; the
    forward in its redesign and its first design; the dual-sorted ones
    also with ``nd_wide``, ids in any order), in bf16 and float32, timed
    beside their bounds (the forward in both types, the redesign against
    the first design in turns); returns their two ``kernels`` records."""
    name = negscore.kernel_name(mode, dual)
    fwd, bwd = negscore.KERNELS[name], negscore.KERNELS[name + "_bwd"]
    design = "run"
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
        if nd_wide is not None:
            inputs.append((", nd in any order", nd_wide))
        for label, ndc in inputs:
            s_k = fwd(zt, ns, ndc, rel, re)
            with first_design_negscore_fwd():
                s_f = fwd(zt, ns, ndc, rel, re)
            dz_k, dre_k = bwd(zt, ns, ndc, rel, re, ds)
            zp = zt.clone().requires_grad_(True)
            rp = rel_emb.clone().requires_grad_(True)
            s_p = negscore.plain_scores(mode, zp, ns, ndc, rel, rp)
            dz_p, dre_p = torch.autograd.grad(s_p, (zp, rp), ds)
            torch.cuda.synchronize()
            pairs = ((s_k, s_p.detach()), (s_f, s_p.detach()),
                     (dz_k, dz_p), (dre_k, dre_p))
            rel_errs = [rel_err(a, b) for a, b in pairs]
            abs_errs = [float((a.float() - b.float()).abs().max())
                        for a, b in pairs]
            if dtype == torch.bfloat16:
                val_tol, grad_tol = NEG_TOL_BF16
                ok = max(rel_errs[:2]) <= val_tol \
                    and max(rel_errs[2:]) <= grad_tol
                how = f"tol {val_tol:g} / {grad_tol:g}"
            else:
                mags = neg_magnitudes(mode, zt, ns, ndc, rel, rel_emb, ds)
                mags = (mags[0], *mags)
                ratios = [float(((a.float() - b.float()).abs()
                                 / c.clamp(min=1e-30)).max())
                          for (a, b), c in zip(pairs, mags)]
                ok = max(ratios) <= SUM_RTOL
                how = (f"of Σ|terms| per element "
                       f"{', '.join(f'{x:.3g}' for x in ratios)}, tol "
                       f"{SUM_RTOL:g}")
            print(f"{name} {str(dtype)[6:]}{label}: z {tuple(zt.shape)}, "
                  f"{m} slots, R = {r}: kernels vs plain rel-to-max scores "
                  f"{rel_errs[0]:.3g} ({design}), {rel_errs[1]:.3g} "
                  f"(first), dz {rel_errs[2]:.3g}, d(rel_emb) "
                  f"{rel_errs[3]:.3g} ({how}); max abs {abs_errs}")
            check(ok, f"{name} {dtype}{label}: kernels disagree with the "
                      f"plain version")
            if not label:
                err[dtype] = (abs_errs[0], max(abs_errs[2:]))

    # device times (the host's time in the wrappers does not enter): the
    # forward's redesign against its first design in turns, in both types;
    # the owner backward against the first design in turns (bf16)
    fwd_ms, first_fwd_ms, l2 = {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        zt, re = kernel_table(dtype)
        turns = []
        for des in (design, "first", "first", design):
            with negscore_fwd_design_as(des):
                turns.append(device_ms(lambda: fwd(zt, ns, nd, rel, re)))
        fwd_ms[dtype] = min(turns[0], turns[3])
        first_fwd_ms[dtype] = min(turns[1], turns[2])
        l2[dtype] = {des: fwd_l2_bytes(des, zt, ns)
                     for des in (design, "first")}
        bound = negscore_bound_ms(mode, zt, m, r, False)
        print(f"{name} forward {str(dtype)[6:]} (training shape, device): "
              f"{design} {turns[0]:.4f} / {turns[3]:.4f} ms, first "
              f"{turns[1]:.4f} / {turns[2]:.4f} ms, bound {bound[0]:.4f} "
              f"({bound[2]}); {design} at {bound[0] / fwd_ms[dtype]:.1%} of "
              f"bound, first at {bound[0] / first_fwd_ms[dtype]:.1%}; "
              f"fwd_l2_bytes (modelled, the least) {design} "
              f"{l2[dtype][design] / 1e6:.1f} MB, first "
              f"{l2[dtype]['first'] / 1e6:.1f} MB")
    zt, re = kernel_table(torch.bfloat16)
    turns = []
    for bwd_design in ("owner", "first", "first", "owner"):
        with negscore_design_as(bwd_design):
            turns.append(device_ms(lambda: bwd(zt, ns, nd, rel, re, ds)))
    bwd_ms, first_ms = min(turns[0], turns[3]), min(turns[1], turns[2])
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: negscore.plain_scores(
            mode, zt, ns, nd, rel, rel_emb))
    zp = zt.clone().requires_grad_(True)
    rp = rel_emb.clone().requires_grad_(True)
    s_p = negscore.plain_scores(mode, zp, ns, nd, rel, rp)
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(
        s_p, (zp, rp), ds, retain_graph=True))
    records = []
    bf16 = torch.bfloat16
    for backward, ms, plain_ms in ((False, fwd_ms[bf16], plain_fwd_ms),
                                   (True, bwd_ms, plain_bwd_ms)):
        bound, by, term = negscore_bound_ms(mode, zt, m, r, backward)
        kname = name + ("_bwd" if backward else "")
        extra = ""
        if backward:
            extra = (f"; first design {first_ms:.4f} ms (turns "
                     f"{', '.join(f'{t:.4f}' for t in turns)}); the owner "
                     f"design gathers {owner_l2_bytes(zt, m) / 1e6:.1f} MB "
                     f"from L2 against "
                     f"{neg_bytes(mode, zt, m, r, True) / 1e6:.2f} MB that "
                     f"the function must move")
        print(f"{kname} time (bf16, training shape, device): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
              f"({term}), kernel at {bound / ms:.1%} of bound{extra}; no "
              f"single PyTorch call computes this function")
        record = {
            "name": kname, "design": "owner" if backward else design,
            "route": "cuda",
            "source": "biomedkg_tpu_torch/csrc/negscore.cu",
            "replaces": "biomedkg_tpu/ops/pallas/negscore.py:"
                        f"{NEG_REPLACES[dual, backward]}",
            "launches": launches[kname],
            "max_abs_err": err[bf16][backward], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}
        if backward:
            record["first_design_ms"] = first_ms
        else:
            f32 = torch.float32
            record.update(
                first_design_ms=first_fwd_ms[bf16],
                ms_float32=fwd_ms[f32],
                first_design_ms_float32=first_fwd_ms[f32],
                max_abs_err_float32=err[f32][0])
        records.append(record)
    return records


def loss_falls(sd, feature_table, dev, batch, what: str, **over):
    """Eight steps on one batch with fixed draws: the first (lr 0) leaves
    the loss as it was, and the loss then falls."""
    probe = train_module(sd, feature_table, dev, **over)
    probe.configure_optimizers(num_training_steps=20)
    st = probe.init_state()
    negatives, masks, _ = fixed_draws(
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
    """The batch's z as the bf16 training step computes it (no dropout;
    multi-modal features fused as the module fuses them)."""
    with torch.no_grad():
        return module.model.encoder(
            module.fusion_fn(module._batch_features(batch)),
            batch.edge_index,
            batch.edge_type, batch.edge_mask, batch.block_rel,
            compute_dtype=torch.bfloat16).float()


def path_negatives(batch, gen, dual: bool, k: int = TRAIN["neg_ratio"]):
    """The path's (ns, nd, per-slot relation) for ``batch``, K = ``k``."""
    num_edges = batch.edge_type.shape[0]
    ns, nd, off = sample_negatives_sorted(
        gen, k, num_edges,
        batch.node_mask.sum().clamp(min=1), dual=dual)
    rel = batch.edge_type[rolled_index(off, num_edges,
                                       _mix_factor(num_edges))].int()
    return ns, nd, rel


def start_train_kge(tmp: str, *extra) -> subprocess.Popen:
    """``python -m biomedkg_tpu_torch.train_kge`` on the card for 3 steps
    an epoch on the PrimeKG++-scale graph, validating every epoch (one
    SAINT batch: steps // 10, at least 1) and testing the best checkpoint,
    in its own directory under ``tmp``."""
    root = os.path.dirname(os.path.abspath(__file__))
    cwd = tempfile.mkdtemp(dir=tmp)
    proc = subprocess.Popen(
        [sys.executable, "-m", "biomedkg_tpu_torch.train_kge", "steps=3",
         "epochs=1", "val_every_epoch=1", "saint_fill=0.92",
         "model.compute_dtype=bfloat16", f"seed={SEED}",
         f"ckpt_dir={cwd}/ckpt", f"log_dir={cwd}/log", *extra],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.log_dir = f"{cwd}/log"
    proc.cwd = cwd
    return proc


def val_loss_of(path: str) -> float:
    return float(path.rsplit("val_loss=", 1)[1][:-len(".ckpt")])


def check_reference_flow(proc, ckpt: str, what: str, top_k: int,
                         last: bool, kind: str) -> dict:
    """An entry point's run followed the reference's flow: at most
    ``top_k`` ``epoch=*-val_loss=*.ckpt`` files (and ``last.ckpt`` where
    ``last``), the one the test loaded (``ckpt``) the least ``val_loss``
    of them, and a metrics.jsonl whose every value is finite, with the
    epoch's train loss and ``val_*`` and ``test_*`` keys. Returns the
    union of the logged records."""
    run_dir = os.path.dirname(ckpt)
    files = sorted(os.listdir(run_dir))
    kept = [os.path.join(run_dir, f) for f in files
            if f.startswith("epoch=") and "-val_loss=" in f]
    check(0 < len(kept) <= top_k and ("last.ckpt" in files) == last,
          f"{what}: checkpoints {files}")
    check(ckpt == min(kept, key=val_loss_of),
          f"{what}: the test loaded {ckpt}, not the best of {kept}")
    (log,) = [os.path.join(d, "metrics.jsonl") for d, _, f in
              os.walk(os.path.join(proc.log_dir, kind))
              if "metrics.jsonl" in f]
    with open(log) as f:
        records = [json.loads(line) for line in f]
    logged = {k: v for r in records for k, v in r.items()}
    check(all(np.isfinite(v) for r in records for v in r.values()),
          f"{what}: a logged metric is not finite")
    check("train_loss_epoch" in logged
          and any(k.startswith("val_") for k in logged)
          and any(k.startswith("test_") for k in logged),
          f"{what}: metrics.jsonl keys {sorted(logged)}")
    print(f"{what}: kept {[os.path.basename(k) for k in kept]}"
          f"{' + last.ckpt' if last else ''}; tested "
          f"{os.path.basename(ckpt)}; logged "
          + ", ".join(f"{k} {logged[k]:.6g}" for k in sorted(logged)
                      if k.endswith("loss") or "AUROC" in k
                      or k.endswith("_F1")))
    return logged


def finish_train_kge(proc, what: str, graph, t0: float,
                     epochs: int = 1) -> str:
    """Wait for a ``start_train_kge`` run and check its reference flow
    (top-3 and last, the test on the best, the metrics of ``epochs``
    validations and a test: AUROC in [0, 1], one precision per relation);
    returns the checkpoint the test loaded."""
    out, errs = proc.communicate(timeout=600)
    proc.out = out
    print(f"train_kge {what} ({time.perf_counter() - t0:.1f} s, rc "
          f"{proc.returncode}):", out.strip().replace("\n", " | "))
    check(proc.returncode == 0, f"train_kge {what} failed: {errs[-2000:]}")
    check(out.startswith(f"train_kge: {graph.num_nodes} nodes, "
                         f"{graph.num_edges} edges"),
          f"train_kge {what} did not train on the PrimeKG++-scale graph")
    ckpt = out.split("checkpoint: ")[-1].strip()
    check(ckpt != "None" and os.path.exists(ckpt),
          f"train_kge {what}: the test loaded no checkpoint ({ckpt})")
    logged = check_reference_flow(proc, ckpt, f"train_kge {what}", 3, True,
                                  "kge")
    check(out.count("] val_loss=") == epochs,
          f"train_kge {what}: {out.count('] val_loss=')} validations")
    check(all(0.0 <= logged[f"{s}_AUROC"] <= 1.0 for s in ("val", "test")),
          f"train_kge {what}: AUROC outside [0, 1]")
    pre = [k for k in logged if k.endswith("_pre")]
    check(len(pre) == graph.num_relations,
          f"train_kge {what}: per-relation precisions {pre}")
    return ckpt


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


def bucket_checks(dev, negatives, n: int):
    """The owner design's bucket build against ``buckets_plain`` at the
    path's shape (``negatives`` over ``n`` node slots) and at odd sizes:
    out-of-range ids (clipped), empty buckets, ns in any order, more ids
    than slots, more ids than one key range holds; its ``kernels``
    record, timed on the device."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ns, nd, _ = negatives
    m = ns.shape[0]

    def draw(lo, hi, size):
        return torch.randint(lo, hi, (size,), device=dev, generator=gen).int()

    cases = [("path", ns, nd, n),
             ("path, ns in any order", ns[torch.randperm(
                 m, device=dev, generator=gen)].contiguous(), nd, n)]
    for size, ids in ((1, 1), (100, 7), (5000, 37), (3001, 20000),
                      (70000, 9000)):
        cases.append((f"M = {size}, N = {ids}, clipped, sorted ns",
                      torch.sort(draw(-3, ids + 3, size))[0],
                      draw(-3, ids + 3, size), ids))
        cases.append((f"M = {size}, N = {ids}, clipped, ns in any order",
                      draw(-3, ids + 3, size), draw(-3, ids + 3, size), ids))
    for what, a, b, ids in cases:
        got = negscore.BUCKETS(a, b, ids)
        want = negscore.buckets_plain(a, b, ids)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"bucket build disagrees with buckets_plain ({what})")
    print(f"negscore bucket build: offsets and stable order equal "
          f"buckets_plain in {len(cases)} cases (the path's M = {m}, N = "
          f"{n}; odd sizes to N = 20,000, ids clipped, ns in any order)")
    ms = device_ms(lambda: negscore.BUCKETS(ns, nd, n), only="bucket_kernel")
    plain_ms = time_ms(lambda: negscore.buckets_plain(ns, nd, n))
    nbytes = 2 * 4 * m + 2 * 4 * m + 2 * 4 * (n + 1)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{negscore.BUCKETS_NAME} time (training shape, device): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
          f"(bytes: ns and nd read, both orders and offsets written), "
          f"kernel at {bound / ms:.1%} of bound; no single PyTorch call "
          f"computes both sides' offsets and orders")
    return {"name": negscore.BUCKETS_NAME, "design": "owner",
            "route": "cuda", "source": "biomedkg_tpu_torch/csrc/negscore.cu",
            "replaces": "biomedkg_tpu/ops/pallas/negscore.py:"
                        f"{NEG_REPLACES[False, True]}",
            "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None}


def backward_launches(z, negatives, rel_emb, ds) -> dict:
    """Device launches of one DistMult backward call on the path (bf16 z
    through the dispatcher and autograd), counted by torch.profiler, per
    design: at most the first design's four (two zero fills, the kernel,
    the cast to z's type)."""
    ns, nd, rel = negatives
    counts = {}
    for design in negscore.DESIGNS:
        zp = z.to(torch.bfloat16).requires_grad_(True)
        rp = rel_emb.clone().requires_grad_(True)
        with negscore_design_as(design):
            s = negscore.distmult_neg_scores(zp, ns, nd, rel, rp)
            torch.autograd.grad(s, (zp, rp), ds)       # warm
            for _ in range(PROFILE_TRIES):     # CUPTI may hand back nothing
                s = negscore.distmult_neg_scores(zp, ns, nd, rel, rp)
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    torch.autograd.grad(s, (zp, rp), ds)
                    torch.cuda.synchronize()
                events = [e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA]
                if events:
                    break
        counts[design] = (sum(e.count for e in events),
                          {e.key[:40]: e.count for e in events})
    print(f"device launches per negscore backward call (torch.profiler, "
          f"bf16 DistMult at the training shape): "
          + "; ".join(f"{d} {c} {k}" for d, (c, k) in counts.items()))
    check(0 < counts["owner"][0] <= 4,
          f"the owner backward launched {counts['owner'][0]} device "
          f"kernels in one call (at most 4)")
    return {d: c for d, (c, _) in counts.items()}


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
    with first_design_segsum():
        profile_steps(module, state, batches[-PROFILED:], gen,
                      "train step with the first-design segsum")
    with first_design_negscore():
        profile_steps(module, state, batches[-PROFILED:], gen,
                      "train step with the first-design negscore backward")
    with first_design_negscore_fwd():
        profile_steps(module, state, batches[-PROFILED:], gen,
                      "train step with the first-design negscore forward")

    # -- one step: kernels against the plain versions ---------------------
    batch = batches[0]
    compare_step(sd, module.feature_table, dev, batch, "distmult_neg_scores",
                 "train")

    # -- the negscore kernels against the plain version -------------------
    z = encoded(module, batch)
    ds = torch.randn(m, generator=gen, device=dev)
    negatives = path_negatives(batch, gen, False)
    rel_emb = module.model.decoder.rel_emb.detach()
    records = negscore_records("distmult", False, z, negatives, rel_emb, ds,
                               launches)
    records.append(bucket_checks(dev, negatives, z.shape[0]))
    backward_launches(z, negatives, rel_emb, ds)

    segsum_batch_times(batch, TRAIN["hidden_dim"], torch.bfloat16, gen,
                       "conv and tail gather (training shape)", counts=True)

    # -- training makes progress on a fixed batch -------------------------
    loss_falls(sd, module.feature_table, dev, batch, "train")

    # -- the train_kge entry point on the card, on the same graph, served;
    # phase 6's RotatE + sorted2 run and phase 7's RGAT run alongside ------
    t0 = time.perf_counter()
    runs = (start_train_kge(tmp, "epochs=2"), start_train_kge(
        tmp, "model.decoder_name=rotate", "model.neg_sampler=sorted2"),
        start_train_kge(tmp, "model.encoder_name=rgat"),
        start_train_gcl(tmp))
    ckpt = finish_train_kge(runs[0], "DistMult", dm.graph, t0, epochs=2)
    served = serve_checkpoint(ckpt, tmp, "train_kge DistMult")
    p = served.score("gene_000000", "protein_protein", "gene_000001")
    print(f"train_kge DistMult checkpoint: score {p:.6f}")
    check(0.0 < p < 1.0, "served score out of (0, 1)")
    return (records, launches["sorted_segment_sum"], batches,
            module.feature_table, (runs[1], t0), (runs[2], t0), (runs[3], t0))


def odd_shape_checks(dev):
    """Every negscore kernel against its plain version off the path, each
    direction in both designs (the forward's first design with the
    backward's, "run" with "owner"), in float32 and bf16: d not
    a multiple of the warp (nor the pair offset d/2), d of 128 and 256 (the
    redesigned forward's 4- and 8-feature lanes), K·E not a multiple of the
    chunk, ids out of range (clipped), ns in any order (nd is in any order
    throughout), a "sorted2" band that wraps the id range, one src id over
    3,000 slots (many warps); and rotate (float32) where
    pairs sit below the distance's clamp (|u| < 1e-6): tails that are
    their heads moved by 1e-7 in the pairs whose phase is 0, where both
    take du = −ds·u / 1e-6 (the reference's _distance_bwd). Tolerances
    relative to each result's max: float32 1e-4, bf16 NEG_TOL_BF16."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n, m, r = 37, 5000, 5
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}

    def draw(lo, hi, size):
        return torch.randint(lo, hi, size, device=dev, generator=gen).int()

    def compare(mode, z, ns, nd, rel, rel_emb, what, dtype=torch.float32):
        ds = torch.randn(ns.shape[0], device=dev, generator=gen)
        z = z.to(dtype)
        re = negscore.relation_table(mode, rel_emb, dtype).contiguous()
        val_tol, grad_tol = ((1e-4, 1e-4) if dtype == torch.float32
                             else NEG_TOL_BF16)
        errs = []
        for design, dual in itertools.product(negscore.DESIGNS,
                                              (False, True)):
            name = negscore.kernel_name(mode, dual)
            fwd_design = "first" if design == "first" else "run"
            with negscore_design_as(design), \
                    negscore_fwd_design_as(fwd_design):
                got = (negscore.KERNELS[name](z, ns, nd, rel, re),
                       *negscore.KERNELS[name + "_bwd"](z, ns, nd, rel, re,
                                                        ds))
            zp = z.clone().requires_grad_(True)
            rp = rel_emb.clone().requires_grad_(True)
            s_p = negscore.plain_scores(mode, zp, ns, nd, rel, rp)
            want = (s_p.detach(), *torch.autograd.grad(s_p, (zp, rp), ds))
            e = [rel_err(a, b) for a, b in zip(got, want)]
            errs += e
            check(e[0] <= val_tol and max(e[1:]) <= grad_tol,
                  f"{name} {design} {dtype} {what}: kernels disagree ({e})")
        worst[dtype] = max(worst[dtype], max(errs))
        return max(errs)

    for mode in negscore.MODES:
        width = (lambda d: d // 2 if mode == "rotate" else d)
        for dtype in (torch.float32, torch.bfloat16):
            for d in ((6, 100, 256) if mode in negscore.PAIRED
                      else (7, 100, 128, 256)):
                z = torch.randn(n, d, device=dev, generator=gen)
                ns = torch.sort(draw(-2, n + 3, (m,)))[0]
                nd, rel = draw(-2, n + 3, (m,)), draw(-1, r + 1, (m,))
                rel_emb = torch.randn(r, width(d), device=dev, generator=gen)
                compare(mode, z, ns, nd, rel, rel_emb, f"at d = {d}", dtype)
            z = torch.randn(n, 100, device=dev, generator=gen)
            rel_emb = torch.randn(r, width(100), device=dev, generator=gen)
            compare(mode, z, draw(-2, n + 3, (m,)), draw(-2, n + 3, (m,)),
                    draw(-1, r + 1, (m,)), rel_emb, "with ns in any order",
                    dtype)
            # the sampler's sorted2 bands over 300 ids, each chunk's band
            # of 12 ids starting 6 below the top, so that it wraps
            wide = 300
            z = torch.randn(wide, 256, device=dev, generator=gen)
            rel_emb = torch.randn(r, width(256), device=dev, generator=gen)
            ns = torch.sort(draw(0, wide, (m,)))[0]
            band = torch.remainder(wide - 6 + draw(0, 12, (m,)), wide).int()
            compare(mode, z, ns, band, draw(0, r, (m,)), rel_emb,
                    "with a dst band that wraps the id range", dtype)
            ns = torch.sort(torch.where(torch.arange(m, device=dev) < 3000,
                                        7, draw(0, wide, (m,))))[0].int()
            compare(mode, z, ns, draw(0, wide, (m,)), draw(0, r, (m,)),
                    rel_emb, "with one src id over 3,000 slots", dtype)
    d, half = 100, n // 2
    z = torch.randn(n, d, device=dev, generator=gen)
    z[half:2 * half] = z[:half]
    z[half:2 * half, :d // 2] += 1e-7
    rel_emb = torch.randn(r, d // 2, device=dev, generator=gen)
    rel_emb[:, ::2] = 0.0
    ns = torch.sort(draw(0, half, (m,)))[0]
    nd = torch.where(torch.arange(m, device=dev) % 2 == 0, ns + half,
                     draw(0, n, (m,)))
    clamp_err = compare("rotate", z, ns, nd, draw(0, r, (m,)), rel_emb,
                        "below the clamp")
    print(f"negscore kernels off the path (both designs of each direction; "
          f"N = {n} and 300, K·E = {m}, d of 6 or 7, 100, 128 and 256, ids "
          f"out of range, ns sorted and in any order, a dst band that "
          f"wraps, one src id over 3,000 slots): max rel-to-max error float32 "
          f"{worst[torch.float32]:.3g} (tol 1e-4), bf16 "
          f"{worst[torch.bfloat16]:.3g} (tol {NEG_TOL_BF16[0]:g} / "
          f"{NEG_TOL_BF16[1]:g}); rotate with pairs below the distance's "
          f"clamp {clamp_err:.3g} (float32, tol 1e-4)")


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
            with first_design_negscore():
                profile_steps(module, state, batches[-PROFILED:], step_gen,
                              f"{what} train step with the first-design "
                              f"negscore backward")
            with first_design_negscore_fwd():
                profile_steps(module, state, batches[-PROFILED:], step_gen,
                              f"{what} train step with the first-design "
                              f"negscore forward")
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
    float32 steps (train_kge's default type, timed), and one eval step on
    a SAINT val batch in each type; returns the device batches and the
    relmm launches of the timed steps and the eval steps."""
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
    val = batch_to_device(dm.val_dataloader(loader_type="saint").sample()[0],
                          dev)
    eval_n = [eval_launches(module, val, "RGAT bf16", expected_launches(
        0, None, 0, (RELMM_PER_STEP[0], 0), relmm_instance="wgmma"))]
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
    eval_n.append(eval_launches(f32, val, "RGAT float32", expected_launches(
        0, None, 0, (RELMM_PER_STEP[0], 0), relmm_instance="simt_f32")))
    del f32, state, val

    compare_step(sd, table, dev, batches[0], "distmult_neg_scores", "RGAT",
                 segsum_n=0, relmm_n=RELMM_PER_STEP, encoder_name="rgat")
    loss_falls(sd, table, dev, batches[0], "RGAT", encoder_name="rgat")
    return batches, [launches, f32_launches] + eval_n


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
    for name, count in launches.items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + count
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

def flash_live_work(col, g, backward: bool):
    """What one flash_denom call needs on this input, as (N x N x d
    products, N^2 exps), each counted over the share of the 64-row tile
    pairs (TILE) whose terms are not all 0 (flashnce.live_tiles; where no
    column is real every tile counts). Forward: the inter and the intra
    logits and their exps on the column tiles with a real column.
    Backward: the inter logits, G_inter bn and G_inter^T an on the pairs
    with a live rows term (job 0's pairs; job 2's are the same swapped),
    the intra logits and (G_intra + G_intra^T) an on the pairs with either
    term (job 1's), and one exp per softmax cotangent, inter and intra,
    each nonzero only on job 0's pairs. Each product counts once, as the
    function needs it: the designs rebuild the inter logits in job 2 too,
    which is not counted; the symmetry of an an^T is not used."""
    flags = flashnce.live_tiles(col, g if backward else None)
    if not backward:
        cols = float(flashnce.live_columns(flags).float().mean())
        return 2 * cols, 2 * cols
    rows, either = (float(flashnce.live_pairs(flags, job).float().mean())
                    for job in (0, 1))
    return 3 * rows + 2 * either, 2 * rows


FLASH_ENVELOPE_WORK = {False: (2, 2), True: (5, 2)}


def flash_bound_ms(n: int, d: int, dtype, backward: bool, work=None):
    """Least time for one flash_denom call, as (ms, "bytes" or
    "operations", the term that sets it): an and bn read once and the
    outputs written once (backward: col, den and g in, d_an and d_bn out)
    over HBM bandwidth; ``work`` (``flash_live_work``'s products and exps;
    by default the envelope's, every tile pair live) over the peak of the
    products' unit and of the special-function units."""
    products, exps = work or FLASH_ENVELOPE_WORK[backward]
    size = 2 if dtype == torch.bfloat16 else 4
    nbytes = 2 * n * d * size + 8 * n
    if backward:
        nbytes += 8 * n + 2 * n * d * size
    peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S
    terms = {
        "bytes": nbytes / HBM_BYTES_PER_S * 1e3,
        f"{str(dtype)[6:]} operations": products * 2 * n * n * d / peak
        * 1e3,
        "special-function operations": exps * n * n / SFU_OP_PER_S * 1e3}
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def unit_rows(n: int, d: int, gen, dtype) -> torch.Tensor:
    x = torch.randn(n, d, device=gen.device, generator=gen)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype).contiguous()


def flash_kernels(an, bn, col, g):
    """The denominators and (d_an, d_bn) through the wrappers, in the
    design flashnce.flash_design picks for them now."""
    den = flashnce.FORWARD(an, bn, col, GCL_TAU)
    return den, flashnce.BACKWARD(an, bn, col, den, g, GCL_TAU)


def flash_designs_of(an, bn):
    """The design the wrappers pick for an, bn, then the other skipping
    bf16 design where that is wgmma_bf16, then the first design."""
    picked = flashnce.flash_design(an.dtype, an.shape[1], an.data_ptr(),
                                   bn.data_ptr())
    others = [flashnce.GENERAL[an.dtype]] if picked != \
        flashnce.GENERAL[an.dtype] else []
    return [picked, *others, flashnce.FIRST[an.dtype]]


def flash_check(an, bn, col, g, what: str):
    """The flash kernels, in every design of ``flash_designs_of``, against
    the plain version on one input: the denominators (float32 within
    FLASH_TOL of |den| per row; bf16 within FLASH_TOL absolute of the
    float32 plain version's) and d_an, d_bn (within FLASH_TOL of their
    max, against the plain version in the same type); returns the picked
    design's (max abs den error, max abs gradient error)."""
    dtype = an.dtype
    den_32 = flashnce.denominators_plain(an.float(), bn.float(), col,
                                         GCL_TAU)
    den_p = den_32 if dtype == torch.float32 else \
        flashnce.denominators_plain(an, bn, col, GCL_TAU)
    grads_p = flashnce.denominator_grads_plain(an, bn, col, den_p, g,
                                               GCL_TAU)
    val_tol, grad_tol = FLASH_TOL[dtype]
    out = None
    for design in flash_designs_of(an, bn):
        with on_flash_design(design):
            den_k, grads_k = flash_kernels(an, bn, col, g)
        torch.cuda.synchronize()
        den_err = (den_k - den_32).abs()
        if dtype == torch.float32:
            den_ok = bool(torch.all(den_err <= val_tol
                                    * den_32.abs().clamp(min=1.0)))
        else:
            den_ok = float(den_err.max()) <= val_tol
        errs = [rel_err(a, b) for a, b in zip(grads_k, grads_p)]
        grad_abs = max(float((a.float() - b.float()).abs().max())
                       for a, b in zip(grads_k, grads_p))
        print(f"flash {what} [{design}]: N = {an.shape[0]}, d = "
              f"{an.shape[1]}, {int((col != 0).sum())} pad rows, "
              f"{int((g != 0).sum())} nonzero g: den max abs err "
              f"{float(den_err.max()):.3g} (tol {val_tol:g}"
              f"{'·max(|den|, 1)' if dtype == torch.float32 else ''}); "
              f"d_an, d_bn rel-to-max {errs[0]:.3g}, {errs[1]:.3g} (tol "
              f"{grad_tol:g})")
        check(den_ok, f"flash {what} {design}: denominators disagree")
        check(max(errs) <= grad_tol,
              f"flash {what} {design}: gradients disagree")
        out = out or (float(den_err.max()), grad_abs)
    return out


def flash_inputs(n, d, pads, gen, dtype, layout: str = "tail"):
    """Unit rows, the column mask and the cotangent g. ``layout``: "tail"
    (the last ``pads`` rows pads, g 0 there, as the neighbour batch lays
    them out); "all pads" (g nonzero on every row: with no real column the
    terms are exp(0), none skipped); "scattered pads" (every third 64-row
    tile all
    pads, the others pads at random); "g on pads" (the scattered pads, g
    nonzero on them, and every fourth tile's g all 0 beside real
    columns)."""
    an, bn = unit_rows(n, d, gen, dtype), unit_rows(n, d, gen, dtype)
    rows = torch.arange(n, device=gen.device)
    tile = rows // flashnce.TILE
    if layout == "tail":
        real = rows < n - pads
    elif layout == "all pads":
        real = torch.zeros(n, dtype=torch.bool, device=gen.device)
    else:
        real = (torch.rand(n, device=gen.device, generator=gen) > 0.4) \
            & (tile % 3 != 1)
    col = torch.where(real, 0.0, flashnce.NEG).float()
    g = torch.rand(n, device=gen.device, generator=gen)
    if layout == "g on pads":
        g = g * (tile % 4 != 2)
    elif layout != "all pads":
        g = g * real
    return an, bn, col, g


def flash_odd_checks(dev):
    """Phase 8a: the flash kernels against the plain version off the
    path: N no multiple of the 64-row tile, d of 100, 36 and 30 (the
    scalar tile loads; skip_bf16 in bf16), d of 72, 136 and 8 (wgmma_bf16
    with a ragged last 64-column panel, and a single k step), one
    case at d = 256 across tiles, with and without a padded tail; then
    every slot a pad, scattered pads (whole pad tiles between live ones)
    and g nonzero on pads (FLASH_PADS); float32 and bf16, each in every
    design of ``flash_designs_of``."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cases = [(n, d, pads, "tail") for n, d, pads in FLASH_ODD] \
        + [(n, d, 0, layout) for n, d, layout in FLASH_PADS]
    for n, d, pads, layout in cases:
        for dtype in (torch.float32, torch.bfloat16):
            flash_check(*flash_inputs(n, d, pads, gen, dtype, layout),
                        f"off the path ({layout})")


def flash_attributes():
    """Registers and spills of every flash kernel (cudaFuncGetAttributes:
    local memory a thread, where ptxas puts spilled registers)."""
    for design in flashnce.DESIGNS:
        for backward in (False, True):
            a = flashnce.attributes(backward, design)
            print(f"flash {design} {'backward' if backward else 'forward'}"
                  f": {a['registers']} registers, {a['local_bytes']} bytes "
                  f"of local memory (spills) a thread, {a['static_smem']} "
                  f"bytes static shared")


def flash_path_records(dev, node_mask, launches):
    """Phase 8c: both kernels at the path's shape (the neighbour batch's
    node slots, d = 256, its pad tail), float32 and bf16, against the plain
    version; ``skip_bf16`` bitwise against ``first_bf16``; timed in one
    call, the designs in turns (float32 first, path, path, first; bf16
    first, skip, path, path, skip, first) beside the plain version and the
    bounds over the envelope and over the live tile pairs; returns the
    ``kernels`` records of the path designs, float32 (the config's type)
    under the kernels' names and bf16 under the kernel and its design."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    n, d = node_mask.shape[0], GCL["hidden_dim"]
    col = torch.where(node_mask, 0.0, flashnce.NEG).float()
    g = torch.rand(n, device=dev, generator=gen) * node_mask
    work = {False: flash_live_work(col, g, False),
            True: flash_live_work(col, g, True)}
    flags = flashnce.live_tiles(col, g)
    computed = (float(flashnce.live_columns(flags, flashnce.OWN_ROWS)
                      .float().mean()),
                sum(float(flashnce.live_pairs(flags, job, flashnce.OWN_ROWS)
                          .float().mean())
                    for job in range(flashnce.JOBS)) / flashnce.JOBS)
    print(f"flash path shape: N = {n}, {int(node_mask.sum())} real slots "
          f"({float(node_mask.float().mean()):.4f} of the batch); over "
          f"its live 64-row tile pairs the function needs "
          f"{work[False][0]:.4f} N x N x d products and {work[False][1]:.4f} "
          f"N^2 exps forward, {work[True][0]:.4f} and {work[True][1]:.4f} "
          f"backward (the envelope 2 and 2, 5 and 2); wide_f32 and "
          f"wgmma_bf16 compute {computed[0]:.4f} of the forward's tile pairs "
          f"and {computed[1]:.4f} of the backward's three jobs' (their "
          f"128-row tiles)")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        an, bn = unit_rows(n, d, gen, dtype), unit_rows(n, d, gen, dtype)
        path, first = flashnce.PATH[dtype], flashnce.FIRST[dtype]
        check(flash_designs_of(an, bn)[0] == path,
              f"flash {dtype}: the path's shape does not take {path}")
        errs = flash_check(an, bn, col, g, "at the path's shape")
        turns = (first, path, path, first)
        if dtype == torch.bfloat16:
            skip = flashnce.GENERAL[dtype]
            with on_flash_design(skip):
                got = flash_kernels(an, bn, col, g)
            with first_design_flash():
                want = flash_kernels(an, bn, col, g)
            same = torch.equal(got[0], want[0]) and all(
                torch.equal(a, b) for a, b in zip(got[1], want[1]))
            print(f"flash {skip} against {first} at the path's shape: "
                  f"bitwise equal {same}")
            check(same, f"flash {skip} differs from {first}")
            del got, want
            turns = (first, skip, path, path, skip, first)
        den = flashnce.FORWARD(an, bn, col, GCL_TAU)
        t = {}
        for design in turns:
            with on_flash_design(design):
                for key, fn in (
                        ("fwd", lambda: flashnce.FORWARD(an, bn, col,
                                                         GCL_TAU)),
                        ("bwd", lambda: flashnce.BACKWARD(
                            an, bn, col, den, g, GCL_TAU))):
                    t.setdefault((design, key), []).append(time_ms(fn))
        t["plain_fwd"] = time_ms(lambda: flashnce.denominators_plain(
            an, bn, col, GCL_TAU))
        t["plain_bwd"] = time_ms(lambda: flashnce.denominator_grads_plain(
            an, bn, col, den, g, GCL_TAU))
        for backward, key in ((False, "fwd"), (True, "bwd")):
            ms = {dz: min(t[dz, key]) for dz in dict.fromkeys(turns)}
            t[key] = ms[path]
            env, _, _ = flash_bound_ms(n, d, dtype, backward)
            bound, by, term = flash_bound_ms(n, d, dtype, backward,
                                             work[backward])
            print(f"flash_denom{'_bwd' if backward else ''} time "
                  f"({str(dtype)[6:]}, N = {n}, d = {d}, CUDA events, "
                  f"min of two medians): "
                  + ", ".join(
                      f"{dz} {v:.4f} ms (runs "
                      f"{', '.join(f'{r:.4f}' for r in t[dz, key])}; "
                      f"{bound / v:.1%} of the live bound)"
                      for dz, v in ms.items())
                  + f"; {path} {ms[first] / ms[path]:.2f}x faster than "
                  f"{first}; plain {t['plain_' + key]:.4f} ms; bound over "
                  f"the envelope {env:.4f} ms, over the live tile pairs "
                  f"({work[backward][0]:.4f} products) {bound:.4f} ms "
                  f"({term}); no "
                  f"single PyTorch call returns these denominators "
                  f"(attention kernels return a row logsumexp only through "
                  f"private ops, without the two-table concat, the column "
                  f"mask or the masked diagonal)")
        out[dtype] = (t, errs)
        del an, bn, den
    for design in sorted(flashnce.SLICING):
        print(f"flash {design} forward slices of each 128-row tile's live "
              f"column tiles: {flashnce.FORWARD.splits(n, dev, design)}")
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        t, errs = out[dtype]
        path = flashnce.PATH[dtype]
        for backward, key in ((False, "fwd"), (True, "bwd")):
            kernel = flashnce.BACKWARD if backward else flashnce.FORWARD
            name = kernel.name if dtype == torch.float32 \
                else relmm_key(kernel, path)
            bound, by, _ = flash_bound_ms(n, d, dtype, backward,
                                          work[backward])
            records.append({
                "name": name, "route": "cuda",
                "source": "biomedkg_tpu_torch/csrc/flashnce.cu",
                "replaces": "biomedkg_tpu/ops/pallas/flashnce.py:"
                            f"{FLASH_REPLACES[backward]}",
                "launches": launches[relmm_key(kernel, path)],
                "max_abs_err": errs[backward],
                "ms": t[key], "plain_ms": t["plain_" + key],
                "bound_ms": bound, "bound_by": by, "library_ms": None})
    return records


def gcl_module_for(cls, sd, table, dev, dtype, hp=GCL):
    module = cls(**hp, compute_dtype=str(dtype)[6:])
    module.load_state_dict(sd)
    module.to(dev)
    module.edge_layout = "dst"
    module.feature_table = table
    return module


def gcl_grads(module, batch, draws):
    loss, _ = module._forward_loss(batch, True, draws=draws)
    grads = param_grads(loss, dict(module.named_parameters()))
    torch.cuda.synchronize()
    return float(loss.detach()), grads


def gcl_draws(module, batch, gen):
    """One set of the module's draws for ``batch``: the fuser's keep mask
    (where it has one) and the model's, over the fused features."""
    x = module._batch_features(batch)
    draws = {}
    if module.fusion is not None:
        draws["fusion_keep"] = module.fusion.draw_keep(x, gen, True)
    with torch.no_grad():
        fused = module.fusion_fn(x, draws.get("fusion_keep"), True)
    draws.update(module.model.draw(gen, fused, batch.edge_mask,
                                   batch.node_mask, True))
    return draws


def gcl_compare_step(cls, sd, table, dev, batch, flash_n: int,
                     dtypes=(torch.bfloat16, torch.float32), hp=GCL,
                     what=None):
    """One batch's loss and every gradient with the kernels against the
    same step with the plain versions, the features scaled by
    COMPARE_FEATURE_SCALE; one step makes SEGSUM_PER_GCL_STEP segsum and
    ``flash_n`` + ``flash_n`` flash launches. The loss within
    STEP_TOL of max(|loss|, 1) (DGI's loss is a difference of two terms
    near log 2). Each gradient within STEP_TOL of its max. In bf16, a leaf
    whose plain bf16 gradient is itself further than STEP_TOL from the
    float32 gradient (plain versions, same draws) is rounding noise (it
    moves even with the plain version's row tiling); such a leaf is held
    within STEP_TOL of the step's largest gradient instead. ``hp``: the
    module's hyper-parameters (a fuser's keep mask is one of the draws both
    runs share)."""
    what = what or cls.model_name.upper()
    draws = None
    table = table * COMPARE_FEATURE_SCALE
    for dtype in dtypes:
        module = gcl_module_for(cls, sd, table, dev, dtype, hp)
        if draws is None:
            draws = gcl_draws(
                module, batch,
                torch.Generator(device=dev).manual_seed(SEED + 1))
        reset_launch_counts()
        loss_k, grads_k = gcl_grads(module, batch, draws)
        used = launch_counts()
        reset_launch_counts()
        with plain_versions():
            loss_p, grads_p = gcl_grads(module, batch, draws)
            if dtype == torch.bfloat16:
                _, grads_32 = gcl_grads(
                    gcl_module_for(cls, sd, table, dev, torch.float32, hp),
                    batch, draws)
        check(not any(launch_counts().values()),
              "the plain versions launched a kernel")
        check(used == expected_launches(
            SEGSUM_PER_GCL_STEP, None, 0, flash_n=flash_n,
            flash_design=flashnce.PATH[dtype]),
              f"{what}: launches in one step: {used}")
        loss_tol, grad_tol = STEP_TOL[dtype]
        loss_err = abs(loss_k - loss_p) / max(abs(loss_p), 1.0)
        names = [n for n, _ in module.named_parameters()]
        errs = {n: rel_err(a, b) for n, a, b in zip(names, grads_k, grads_p)}
        noise = shift_invariant_errors(names, grads_k, grads_p)
        if dtype == torch.bfloat16:
            top = max(float(g.float().abs().max()) for g in grads_p)
            noise.update({
                n: float((a.float() - b.float()).abs().max()) / top
                for n, a, b, c in zip(names, grads_k, grads_p, grads_32)
                if rel_err(b, c) > grad_tol})
        bad = [n for n in names
               if (noise[n] if n in noise else errs[n]) > grad_tol]
        held = [n for n in names if n not in noise]
        worst = max(held, key=errs.get) if held else None
        note = (f"; noise leaves (zero in exact arithmetic, or in bf16 the "
                f"plain bf16 over {grad_tol:g} of its max from float32), "
                f"error of the step's largest gradient: "
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


def grace_phase(dev, table, batches, val):
    """Phase 8b: the GRACE step at full width in bf16 and float32, and one
    eval step on the neighbour val batch ``val`` (the flash forward only);
    returns the launches of its timed runs and its eval steps."""
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
            flash_n=FLASH_PER_STEP * steps,
            flash_design=flashnce.PATH[dtype]),
            f"{what}: launches {launches}")
        want = expected_launches(SEGSUM_PER_GCL_STEP, None, 0,
                                 flash_n=FLASH_PER_STEP,
                                 flash_design=flashnce.PATH[dtype])
        bwd = flashnce.KERNELS[flashnce.NAME + "_bwd"]
        want[bwd.name] = want[relmm_key(bwd, flashnce.PATH[dtype])] = 0
        held_out = eval_launches(module, val, f"GRACE {str(dtype)[6:]}",
                                 want)
        for k in launches:
            total[k] = total.get(k, 0) + launches[k] + held_out[k]
        profile_steps(module, state, batches[-profiled:], gen, what)
        with first_design_segsum():
            profile_steps(module, state, batches[-profiled:], gen,
                          f"{what} with the first-design segsum")
        if flashnce.GENERAL[dtype] != flashnce.PATH[dtype]:
            with on_flash_design(flashnce.GENERAL[dtype]):
                profile_steps(module, state, batches[-profiled:], gen,
                              f"{what} with the {flashnce.GENERAL[dtype]} "
                              f"flash kernels")
        with first_design_flash():
            profile_steps(module, state, batches[-profiled:], gen,
                          f"{what} with the first-design flash kernels "
                          f"({flashnce.FIRST[dtype]})")
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
    PrimeKG++-scale graph, validating and testing on whole neighbour
    epochs, in its own directory under ``tmp``."""
    root = os.path.dirname(os.path.abspath(__file__))
    cwd = tempfile.mkdtemp(dir=tmp)
    proc = subprocess.Popen(
        [sys.executable, "-m", "biomedkg_tpu_torch.train_gcl",
         "model.model_name=grace", "data.node_type=gene",
         f"steps={TRAIN_GCL_STEPS}", "epochs=1", "val_every_epoch=1",
         f"seed={SEED}", f"ckpt_dir={cwd}/ckpt", f"log_dir={cwd}/log"],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.log_dir = f"{cwd}/log"
    return proc


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
    logged = check_reference_flow(proc, ckpt, "train_gcl GRACE", 1, False,
                                  "gcl")
    check({"val_loss", "test_loss"} <= set(logged),
          f"train_gcl: metrics {sorted(logged)}")
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
    flash_attributes()
    flash_odd_checks(dev)
    dm, batches = gcl_batches(dev, tmp)
    table = torch.as_tensor(dm.graph.x, dtype=torch.float32).to(dev)
    val = dm.val_dataloader(loader_type="neighbor")
    val.set_epoch(0)
    launches = grace_phase(dev, table, batches,
                           batch_to_device(next(iter(val)), dev))
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


# -- phase 9: held-out evaluation and the Trainer -----------------------------

EVAL_BATCHES = 4
# share of the distinct scores whose bin the card's float32 sigmoid moves
# against the exact (float64) one: a correctly rounded float32 p >= 0.5
# crosses a bin edge k·2^-15 for 2^-10 of the values (half an ulp, 2^-25,
# over a bin); a sigmoid within 1 ulp, for twice that. Counted by distinct
# score, and held in float32 only: bf16 scores lie on a lattice whose
# values near 0 sit on the bin edges (0.5 + x/4 for x a multiple of
# 2^-13), where the exact sigmoid is just below the edge and float32's
# rounds onto it; their share is printed
EVAL_MOVE_SHARE = 2.0 ** -9
# the kernels' eval histogram against the plain versions': slots in
# another bin, as a share of the slots. Both sides take the same float32
# sigmoid of preds that differ only by summation order, so a slot moves
# only where that order crosses a bin edge: 1.11e-5 and 1.66e-5 in float32,
# 0 in bf16 (PERF.md, PR 13). The float32 kernels' histogram against the
# bf16 kernels' (an error of bf16's rounding) must read above it
EVAL_PLAIN_MOVES = 1e-4
# eval_epoch's point metrics, kernels against plain versions (absolute)
EVAL_METRIC_TOL = 1e-4
POINT_METRICS = ("AUROC", "AveragePrecision", "F1", "loss")
FIT_STEPS = 64                   # 4 prefetch items of the config's K = 16
RESUME_STEPS = 3
# a resumed run's losses against the uninterrupted run's (relative): each
# step's train loss and the final validation loss, which reads the final
# weights
RESUME_RTOL = 1e-5
# its final weights: their L2 distance from the uninterrupted run's, as a
# share of how far that run's weights moved in the second epoch. No two
# runs on the card are bit-equal: float32 atomics (the segsum's
# chunk-crossing adds, index_add_) reorder sums, and Adam turns a gradient
# that the order moves across zero into a full step of the other sign, so
# single weights differ by up to a step's size. A repeat of the
# uninterrupted run lies a few thousandths of the movement from it
# (PERF.md, PR 13); a resume from the epoch's start, about 1
RESUME_WEIGHT_SHARE = 0.05


def host_eval_state(aux, num_rel: int, probs: np.ndarray) -> dict:
    """``_reduce_eval_aux`` of ``aux`` on the host from the sigmoid values
    ``probs``: the bins, thresholds and sums in numpy (float64 sums)."""
    pred = aux["pred"].float().cpu().numpy()
    gt = aux["gt"].cpu().numpy() > 0.5
    w = aux["weights"].float().cpu().numpy().astype(np.float64)
    nbins = HistogramBinaryMetrics.NUM_BINS
    bins = np.minimum((probs * nbins).astype(np.int64), nbins - 1)
    pos = pred > 0
    em = aux["edge_mask"].cpu().numpy().astype(np.float64)
    et = aux["edge_type"].cpu().numpy()
    above = em * (aux["pos_pred"].float().cpu().numpy() > 0.5)
    return {"hist": np.stack([
                np.bincount(bins, np.where(gt, w, 0.0), nbins),
                np.bincount(bins, np.where(gt, 0.0, w), nbins)]),
            "f1_counts": np.array([w[pos & gt].sum(), w[pos & ~gt].sum(),
                                   w[~pos & gt].sum()]),
            "edge_counts": np.bincount(et, em, num_rel),
            "edge_above": np.bincount(et, above, num_rel)}


def bin_moves(a, b) -> float:
    """Slots that sit in another bin in two histograms of the same
    slots."""
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum() / 2)


def busy_window(fn, what: str):
    """One profiled call of ``fn`` (torch.profiler): (device busy ms, host
    wall ms), the top kernels printed."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{what} (torch.profiler): {busy:.3f} ms device busy of "
          f"{wall:.3f} ms host wall (idle share "
          f"{1 - busy / wall:.3f}); "
          + "; ".join(f"{e.key[:50]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f} ms"
                      for e in kernels[:8]))
    return busy, wall


def eval_step_check(dm, dev, sd, table) -> int:
    """Phase 9a: the KGE eval step on SAINT val batches, float32 and bf16,
    with the kernels and with the plain versions on the same batches and
    the same iid negatives; the device reduction against the host's; the
    epoch's metrics; times. Returns the segsum launches of the kernel
    eval steps (the counts set to 0 just before, read just after)."""
    loader = dm.val_dataloader(loader_type="saint")
    t0 = time.perf_counter()
    host = [loader.sample()[0] for _ in range(EVAL_BATCHES)]
    sample_ms = (time.perf_counter() - t0) * 1e3 / EVAL_BATCHES
    batches = [batch_to_device(b, dev) for b in host]
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    k, num_rel = TRAIN["neg_ratio"], TRAIN["num_relation"]

    def iid(batch):
        nreal = batch.node_mask.sum().clamp(min=1)
        e = batch.edge_type.shape[0]
        return tuple((torch.rand(k, e, generator=gen, device=dev)
                      * nreal).long() for _ in range(2))

    negatives = [iid(b) for b in batches]
    segsum_n = 0
    states_f32 = None
    for dtype in (torch.float32, torch.bfloat16):
        what = f"eval step {str(dtype)[6:]}"
        module = train_module(sd, table, dev, compute_dtype=str(dtype)[6:])
        module.edge_mapping = dm.edge_map_index
        module.eval_impl = "exact"

        def run():
            return [module.eval_step(b, negatives=n)
                    for b, n in zip(batches, negatives)]

        run()
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aux_k = run()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / EVAL_BATCHES
        launches = launch_counts()
        check(launches == expected_launches(
            SEGSUM_PER_ENCODE * EVAL_BATCHES, None, 0),
            f"{what}: launches over {EVAL_BATCHES} batches {launches}")
        segsum_n += launches["sorted_segment_sum"]
        reset_launch_counts()
        with plain_versions():
            aux_p = run()
        check(not any(launch_counts().values()),
              "the plain versions launched a kernel")
        loss_tol, pred_tol = STEP_TOL[dtype]
        pred_err = max(rel_err(a["pred"], b["pred"])
                       for a, b in zip(aux_k, aux_p))
        loss_err = max(abs(float(a["loss"]) - float(b["loss"]))
                       / abs(float(b["loss"])) for a, b in zip(aux_k, aux_p))
        check(pred_err <= pred_tol and loss_err <= loss_tol,
              f"{what}: kernels vs plain pred {pred_err:.3g} (tol "
              f"{pred_tol:g} of max), loss {loss_err:.3g} (tol {loss_tol:g})")

        states_k = [module._reduce_eval_aux(a) for a in aux_k]
        states_p = [module._reduce_eval_aux(a) for a in aux_p]
        worst = 0.0
        for aux, state in zip(aux_k, states_k):
            # the reduction exactly, on the card's own float32 sigmoid
            probs = torch.sigmoid(aux["pred"]).cpu().numpy()
            want = host_eval_state(aux, num_rel, probs)
            slots = float(aux["weights"].sum())
            for key in ("hist", "f1_counts", "edge_counts", "edge_above"):
                check(np.array_equal(state[key].double().cpu().numpy(),
                                     want[key]),
                      f"{what}: {key} differs from the host's reduction")
            # the card's float32 sigmoid against the exact one
            pred = aux["pred"].float().cpu().numpy()
            _, first = np.unique(pred, return_index=True)
            nbins = HistogramBinaryMetrics.NUM_BINS
            exact = 1.0 / (1.0 + np.exp(-pred[first].astype(np.float64)))
            moved = int(np.sum(np.floor(probs[first] * nbins)
                               != np.floor(exact * nbins)))
            worst = max(worst, moved / len(first))
            check(dtype != torch.float32
                  or moved <= EVAL_MOVE_SHARE * len(first),
                  f"{what}: float32 sigmoid moves the bin of {moved} of "
                  f"{len(first)} distinct scores against float64's")
        plain_moves = max(bin_moves(a["hist"].cpu(), b["hist"].cpu())
                          / float(a["hist"].sum())
                          for a, b in zip(states_k, states_p))
        check(plain_moves <= EVAL_PLAIN_MOVES,
              f"{what}: kernels vs plain move {plain_moves:.3g} of the "
              f"slots' bins (tol {EVAL_PLAIN_MOVES:g})")
        if states_f32 is None:
            states_f32, cross = states_k, ""
        else:
            moves = max(bin_moves(a["hist"].cpu(), b["hist"].cpu())
                        / float(a["hist"].sum())
                        for a, b in zip(states_f32, states_k))
            check(moves > EVAL_PLAIN_MOVES,
                  f"the float32 and bf16 histograms differ by {moves:.3g} "
                  f"of the slots: the bin-move gate cannot see a bf16 "
                  f"error")
            cross = f" (float32 kernels vs bf16 kernels: {moves:.3g})"
        got = module.eval_epoch(states_k, "val")
        ref = module.eval_epoch(states_p, "val")
        keys = [f"val_{m}" for m in POINT_METRICS] + [
            key for key in got if key.endswith("_pre")]
        metric_err = max(abs(got[key] - ref[key]) for key in keys)
        check(all(np.isfinite(v) for v in got.values())
              and 0.0 <= got["val_AUROC"] <= 1.0
              and len(keys) == len(POINT_METRICS) + num_rel,
              f"{what}: eval_epoch {got}")
        check(metric_err <= EVAL_METRIC_TOL,
              f"{what}: eval_epoch kernels vs plain {metric_err:.3g}")

        reduce_ms = device_ms(lambda: module._reduce_eval_aux(aux_k[0]))
        busy, wall = busy_window(run, f"{what} x{EVAL_BATCHES}")
        print(f"{what}: {step_ms:.3f} ms per SAINT val batch (host clock, "
              f"synchronised; {loader.node_budget} node x "
              f"{loader.edge_budget} edge slots, K = {k} iid negatives, "
              f"host sampling {sample_ms:.1f} ms a batch), device busy "
              f"{busy / EVAL_BATCHES:.3f} ms a batch; _reduce_eval_aux "
              f"{reduce_ms:.4f} ms on the device; kernels vs plain: pred "
              f"max rel-to-max {pred_err:.3g} (tol {pred_tol:g}), loss "
              f"{loss_err:.3g} (tol {loss_tol:g}), bin moves "
              f"{plain_moves:.3g} of the slots (tol {EVAL_PLAIN_MOVES:g})"
              f"{cross}; the reduction equal to the "
              f"host's on the same sigmoid values; float32 sigmoid "
              f"against float64's: {worst:.3g} of the distinct scores in "
              f"another bin (tol {EVAL_MOVE_SHARE:g} in float32); "
              f"eval_epoch point "
              f"metrics max diff {metric_err:.3g} (tol "
              f"{EVAL_METRIC_TOL:g}): "
              + ", ".join(f"{m} {got[f'val_{m}']:.6f}"
                          for m in POINT_METRICS))
    return segsum_n


class StepLosses:
    """A logger for the Trainer that keeps what it is given."""

    def __init__(self):
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((step, dict(metrics)))

    def losses(self, after: int) -> dict:
        """Each step's train loss and each validation's loss after step
        ``after``."""
        return {(step, key): v for step, row in self.rows if step > after
                for key, v in row.items() if key.endswith("loss")}


class SaveAndStop:
    """Saves at the first validation and stops the run there."""

    def __init__(self, path: str):
        self.path, self.should_stop = path, False

    def on_validation_end(self, trainer, metrics):
        trainer.save(self.path)
        self.should_stop = True


def trainer_vs_serial(dm, dev):
    """Phase 9b (``trainer_vs_serial_main``'s process): FIT_STEPS SAINT
    steps through ``Trainer.fit`` (the prefetch thread, K = 16 batches an
    item) against the serial loop of sampling, copying and stepping, on
    fresh copies of the same weights: a warm-up, ms per step in turns
    (serial, Trainer, Trainer with K = 1 twice, Trainer, serial: whether
    grouping K batches an item moves anything while the K steps still run
    one by one), one profiled epoch of serial and Trainer with its idle
    share, then one more turn of each (a torch.profiler window slows the
    later host steps of its process). Reported only."""
    dm.edge_layout = "dst"
    dm.device_features = True
    dm.saint_fill_target = SAINT_FILL
    init = KGEModule(**TRAIN)
    init.init(torch.Generator().manual_seed(SEED + 3))
    sd = {n: t.detach().clone() for n, t in init.state_dict().items()}
    table = torch.as_tensor(dm.graph.x, dtype=torch.float32).to(dev)

    def serial(steps=FIT_STEPS):
        dm.SAINT_TRAIN_STEPS = steps
        module = train_module(sd, table, dev)
        module.configure_optimizers(steps)
        state = module.init_state()
        gen = torch.Generator(device=dev).manual_seed(SEED)
        loader = dm.train_dataloader(loader_type="saint")
        loader.set_epoch(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in loader:
            state, logs = module.train_step(
                state, batch_to_device(batch, dev), gen)
        check(np.isfinite(float(logs["train_loss"])), "serial loss")
        return (time.perf_counter() - t0) * 1e3 / steps

    def trainer(steps=FIT_STEPS, k=16):
        dm.SAINT_TRAIN_STEPS = steps
        module = train_module(sd, table, dev)
        fit = Trainer(max_epochs=1, steps_per_execution=k,
                      enable_progress_bar=False, enable_checkpointing=False)
        torch.cuda.synchronize()
        fit.fit(module, dm.train_dataloader(loader_type="saint"),
                init_params=to_jax_params(module.model))
        check(fit.global_step == steps
              and np.isfinite(fit.history[0]["train_loss_epoch"]),
              f"Trainer.fit: {fit.history}")
        return 1e3 / fit.history[0]["batches_per_sec"]

    serial(8)
    trainer(8)
    turns = {"serial": [], "Trainer": [], "K = 1": []}
    run = {"serial": serial, "Trainer": trainer,
           "K = 1": lambda: trainer(k=1)}
    for name in ("serial", "Trainer", "K = 1", "K = 1", "Trainer",
                 "serial"):
        turns[name].append(run[name]())
    idle = {}
    for name, fn in (("serial", serial), ("Trainer", trainer)):
        busy, wall = busy_window(fn, f"{FIT_STEPS} SAINT steps, {name}")
        idle[name] = 1 - busy / wall
    after = {"serial": serial(), "Trainer": trainer()}
    del dm.SAINT_TRAIN_STEPS  # back to the class's 1,000
    print(f"Trainer.fit on the prefetch thread vs the serial loop, "
          f"{FIT_STEPS} bf16 DistMult SAINT steps (sampling included, host "
          f"clock): serial {turns['serial'][0]:.3f} / "
          f"{turns['serial'][1]:.3f} ms per step, Trainer "
          f"{turns['Trainer'][0]:.3f} / {turns['Trainer'][1]:.3f}, "
          f"Trainer with K = 1 {turns['K = 1'][0]:.3f} / "
          f"{turns['K = 1'][1]:.3f}; idle "
          f"share (profiled epoch) serial {idle['serial']:.3f}, Trainer "
          f"{idle['Trainer']:.3f}; after the profiled epochs serial "
          f"{after['serial']:.3f}, Trainer {after['Trainer']:.3f}")
    del table


def flat_weights(module) -> torch.Tensor:
    return torch.cat([p.detach().flatten() for p in module.parameters()])


def resume_check(dm, dev, sd, table, tmp):
    """Phase 9d: 2 epochs of RESUME_STEPS float32 steps straight through
    (and once more, as a repeat), against 1 epoch, a save and a fresh
    Trainer resumed from it: the second epoch's losses within RESUME_RTOL
    of the uninterrupted run's, and the final weights within
    RESUME_WEIGHT_SHARE of the second epoch's movement (the card's float32
    atomics make no two runs bit-equal)."""
    dm.SAINT_TRAIN_STEPS, dm.SAINT_EVAL_STEPS = RESUME_STEPS, 1

    def run(callbacks=(), resume_from=None):
        module = train_module(sd, table, dev, compute_dtype="float32")
        module.edge_mapping = dm.edge_map_index
        logger = StepLosses()
        fit = Trainer(max_epochs=2, callbacks=list(callbacks), logger=logger,
                      log_every_n_steps=1, enable_progress_bar=False)
        fit.fit(module, dm.train_dataloader(loader_type="saint"),
                dm.val_dataloader(loader_type="saint"),
                resume_from=resume_from)
        return fit, module, logger

    t0 = time.perf_counter()
    full, module, logs = run()
    _, repeat, repeat_logs = run()
    path = os.path.join(tmp, "resume", "epoch0.ckpt")
    first, snapshot, _ = run([SaveAndStop(path)])
    check(first.global_step == RESUME_STEPS and len(first.history) == 1,
          "the interrupted run did not stop after its first epoch")
    resumed, again, logs2 = run(resume_from=path)
    want = logs.losses(RESUME_STEPS)
    errs = {}
    for name, lg in (("resumed", logs2), ("repeat", repeat_logs)):
        got = lg.losses(RESUME_STEPS)
        check(sorted(want) == sorted(got)
              and len(want) == RESUME_STEPS + 1,
              f"{name}: logged {sorted(got)} against {sorted(want)}")
        errs[name] = max(abs(got[key] - want[key]) / abs(want[key])
                         for key in want)
    w_full = flat_weights(module)
    movement = float(torch.linalg.vector_norm(w_full
                                              - flat_weights(snapshot)))
    share = {name: float(torch.linalg.vector_norm(flat_weights(m) - w_full))
             / movement for name, m in (("resumed", again),
                                        ("repeat", repeat))}
    print(f"resume on the card ({time.perf_counter() - t0:.1f} s): epoch 1's "
          f"{len(want)} losses max rel diff {errs['resumed']:.3g} (a repeat "
          f"of the uninterrupted run: {errs['repeat']:.3g}; tol "
          f"{RESUME_RTOL:g}); final weights {share['resumed']:.3g} of the "
          f"second epoch's movement ({movement:.4g}, L2) from the "
          f"uninterrupted run's, the repeat's {share['repeat']:.3g} (tol "
          f"{RESUME_WEIGHT_SHARE:g}); uninterrupted "
          f"{[round(full.history[1][k], 6) for k in ('train_loss_epoch', 'val_loss')]}, "
          f"resumed "
          f"{[round(resumed.history[0][k], 6) for k in ('train_loss_epoch', 'val_loss')]}")
    check(errs["resumed"] <= RESUME_RTOL,
          "the resumed run's losses disagree with the uninterrupted run's")
    check(share["resumed"] <= RESUME_WEIGHT_SHARE,
          "the resumed run's weights disagree with the uninterrupted run's")


def eval_phase(dm, dev, tmp) -> int:
    """Phase 9; returns the segsum launches of the eval main path."""
    dm.edge_layout = "dst"
    dm.device_features = True
    dm.saint_fill_target = SAINT_FILL
    module = KGEModule(**TRAIN)
    module.init(torch.Generator().manual_seed(SEED + 3))
    sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
    table = torch.as_tensor(dm.graph.x, dtype=torch.float32).to(dev)
    segsum_n = eval_step_check(dm, dev, sd, table)
    resume_check(dm, dev, sd, table, tmp)
    return segsum_n


TRAINER_VS_SERIAL = "trainer-vs-serial"


def trainer_vs_serial_main(dev) -> int:
    """Phase 9b alone, in a process of its own: no torch.profiler window
    before its turns (one slows every later host step of the
    process), and its prefetch threads' CUDA work stays out of the main
    process's profiler windows. Uses the kernels phase 1 built."""
    for lib in (segsum.LIBRARY, negscore.LIBRARY):
        lib.lib()
    check(native.get_lib() is not None, "the host sampler did not build")
    os.environ["BIOMEDKG_SYNTHETIC_SCALE"] = "primekg"
    with tempfile.TemporaryDirectory() as tmp:
        dm = PrimeKGModule(**dict(PRIMEKG_DATA, data_dir=tmp), seed=SEED)
        dm.setup(stage="split")
        trainer_vs_serial(dm, dev)
    return 0


# -- phase 10: filtered ranking, test_kge and the unseen-node protocol ------

RANK_BRUTE = 2048               # (b): test triples held to float64
OTHER_RANKED, OTHER_BRUTE = 8192, 512   # (c): per decoder
OTHER_DECODERS = ("complex", "transe", "rotate")
RANK_MRR_TOL = 1e-6
# a candidate "near" the true score for the float64 comparison: within
# NEAR_ERRORS times the largest float32 error of the decoder's candidate
# pass measured on the same rows (float32 against float64 on the card)
NEAR_ERRORS = 2.0
# (d): tests/test_planted.py's recipe (N, R, latent K, M tails per head,
# 800 full-batch epochs) and its bounds on tail-side filtered metrics
PLANTED = dict(num_nodes=256, num_relations=4, latent_dim=8,
               edges_per_head=4, seed=0)
PLANTED_EPOCHS = 800
PLANTED_MRR, PLANTED_HITS10 = 0.5, 0.8
# (e): the unseen-node runs and the in-process cold-start steps
UNSEEN_KEYS = ("data.unseen_node_ratio=0.1", "model.cold_start_dropout=0.1")
COLD_START = 0.1
COLD_STEPS = 3


@contextlib.contextmanager
def raw_ranks():
    """Each direction's ranks before the floor, in call order, read
    through eval/ranking.py's direction function."""
    seen = []
    inner = ranking._ranks_before_floor

    def keep(*args, **kwargs):
        seen.append(inner(*args, **kwargs))
        return seen[-1]

    ranking._ranks_before_floor = keep
    try:
        yield seen
    finally:
        ranking._ranks_before_floor = inner


def print_timings(what: str, timings: dict, total_s: float):
    parts = ", ".join(f"{k[:-2]} {v:.3f} s" for k, v in timings.items()
                      if k.endswith("_s"))
    facts = ", ".join(f"{side} {timings[f'{side}_pairs']} pairs on the "
                      f"{timings[f'{side}_path']} path (chunk "
                      f"{timings[f'{side}_chunk']})"
                      for side in ("tail", "head")
                      if f"{side}_pairs" in timings)
    print(f"{what}: {total_s:.3f} s in all (host clock); parts "
          f"(synchronised): {parts}; {facts}")


def brute_force_check(decoder, z, triples, ranks32, known, what: str,
                      rows_per_pass: int) -> int:
    """(b), (c): ``triples``' filtered ranks in float64 on the card (every
    candidate scored, the filter a dense mask) against ``ranks32`` (tail
    then head, the path's floored float32 ranks). A rank may differ only
    by at most the number of candidates whose float64 score lies within
    NEAR_ERRORS times the largest measured float32 error of the true
    score; those exceptions are counted. MRR within RANK_MRR_TOL. Returns
    the exceptions."""
    dev = z.device
    dec64 = copy.deepcopy(decoder).double()
    z64 = z.double()
    num_keys = int(known[:, 1].max()) + 1
    n = z.shape[0]
    all64, all32 = [], []
    exceptions = near_ulp = near_filtered = 0
    worst_err = 0.0
    for side, r32 in zip(("tail", "head"), ranks32):
        anchor = triples[:, 0] if side == "tail" else triples[:, 2]
        target = triples[:, 2] if side == "tail" else triples[:, 0]
        order = [0, 1, 2] if side == "tail" else [2, 1, 0]
        filt = ranking._build_filter(known[:, order], n, num_keys)
        rows, cols, *_ = ranking._assemble_filter_pairs(
            anchor, triples[:, 1], np.ones(len(triples), bool),
            len(triples), 1, filt, num_keys)
        fn32 = getattr(decoder, f"score_all_{side}s")
        fn64 = getattr(dec64, f"score_all_{side}s")
        rank64 = np.empty(len(triples))
        for lo in range(0, len(triples), rows_per_pass):
            hi = min(lo + rows_per_pass, len(triples))
            a = torch.as_tensor(anchor[lo:hi]).to(dev)
            r = torch.as_tensor(triples[lo:hi, 1]).to(dev)
            t = torch.as_tensor(target[lo:hi]).to(dev)
            with torch.inference_mode():
                s64 = fn64(z64, a, r)
                err = float((fn32(z, a, r).double() - s64).abs().max())
            worst_err = max(worst_err, err)
            sel = (rows >= lo) & (rows < hi)
            mask = torch.zeros(hi - lo, n, dtype=torch.bool, device=dev)
            mask[torch.as_tensor(rows[sel] - lo).to(dev),
                 torch.as_tensor(cols[sel].astype(np.int64)).to(dev)] = True
            idx = torch.arange(hi - lo, device=dev)
            mask[idx, t] = False
            ts = s64[idx, t][:, None]
            higher = ((s64 > ts) & ~mask).sum(1)
            ties = ((s64 == ts) & ~mask).sum(1) - 1
            rk = (1 + higher + 0.5 * ties).double().cpu().numpy()
            rank64[lo:hi] = rk
            gap = (s64 - ts).abs()
            gap[idx, t] = float("inf")
            near = (gap <= NEAR_ERRORS * worst_err).sum(1).cpu().numpy()
            ulp = torch.nextafter(ts.float().abs(), torch.tensor(
                float("inf"), device=dev)) - ts.float().abs()
            near1 = (gap <= ulp.double()).sum(1).cpu().numpy()
            nearf = ((gap <= NEAR_ERRORS * worst_err) & mask).sum(
                1).cpu().numpy()
            diff = np.abs(r32[lo:hi] - rk)
            bad = diff > 0
            check(bool(np.all(diff[bad] <= near[bad])),
                  f"{what} {side}: {int(np.sum(diff > near))} ranks differ "
                  f"from the float64 brute force by more than their near "
                  f"candidates")
            exceptions += int(bad.sum())
            near_ulp += int(np.sum(bad & (near1 > 0)))
            near_filtered += int(np.sum(bad & (nearf > 0)))
        all64.append(rank64)
        all32.append(r32)
    mrr64 = float(np.mean(1.0 / np.concatenate(all64)))
    mrr32 = float(np.mean(1.0 / np.concatenate(all32).astype(np.float64)))
    print(f"{what}: {len(triples)} triples x 2 directions against a float64 "
          f"brute force: {exceptions} ranks differ, each by at most its "
          f"candidates within {NEAR_ERRORS:g} x the largest float32 error "
          f"({worst_err:.3g}) of the true score ({near_ulp} of them with "
          f"one within 1 float32 ulp, {near_filtered} with a filtered one "
          f"that near); MRR {mrr32:.9f} against float64's {mrr64:.9f} "
          f"(diff {abs(mrr32 - mrr64):.3g}, tol {RANK_MRR_TOL:g})")
    check(abs(mrr32 - mrr64) <= RANK_MRR_TOL,
          f"{what}: MRR differs from the float64 brute force")
    return exceptions


def full_split_ranking(dm, dev, ckpt):
    """(a) and (b): rank_eval's path over the whole test split (RGCN
    768→256×4 + DistMult from phase 2's checkpoint); returns the encode's
    segsum launches (the counts set to 0 just before, read just after)
    and z."""
    module = load_kge_module(ckpt, dev)
    module.edge_layout = module.default_layout
    timings = {}
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with raw_ranks() as raw:
        t0 = time.perf_counter()
        metrics = rank_eval.rank_eval(module, dm, timings)
        total = time.perf_counter() - t0
    launches = launch_counts()
    for name, count in launches.items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + count
    test = rank_eval.triples(dm.test_data)
    known = np.concatenate([rank_eval.triples(dm.train_data),
                            rank_eval.triples(dm.val_data), test])
    below = [int(np.sum(r < 1.0)) for r in raw]
    print_timings(f"rank_eval (a), {len(test)} test triples x 2 directions, "
                  f"{len(known)} known", timings, total)
    print(f"rank_eval (a): metrics {json.dumps(metrics)}; ranks below 1 "
          f"before the floor: tail {below[0]}, head {below[1]} (min "
          f"{min(float(r.min()) for r in raw):g}); encode launches "
          f"{({k: v for k, v in launches.items() if v})}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(len(raw) == 2 and all(len(r) == len(test) for r in raw),
          "rank_eval: not both directions of the whole test split")
    check(below == [0, 0], f"rank_eval: ranks below 1 before the floor "
                           f"{below}")
    check(launches == expected_launches(SEGSUM_PER_ENCODE, None, 0),
          f"rank_eval encode launches {launches}")
    check(all(np.isfinite(v) for v in metrics.values())
          and 0.0 < metrics["mrr"] <= 1.0, f"rank_eval metrics {metrics}")

    # (b) the float64 brute force on sampled triples
    z = rank_eval_z(module, dm)
    pick = np.random.default_rng(SEED).choice(len(test), RANK_BRUTE,
                                              replace=False)
    brute_force_check(module.model.decoder, z, test[pick],
                      [np.maximum(r[pick], 1.0) for r in raw], known,
                      "rank_eval (b) DistMult", rows_per_pass=256)
    return launches["sorted_segment_sum"], z, test, known


def rank_eval_z(module, dm) -> torch.Tensor:
    """rank_eval's z: the test split's message-passing graph encoded."""
    batch = FullGraphLoader(dm.test_data.graph, block_size=dm.block_size,
                            edge_layout=module.edge_layout).batch()
    return module.encode(batch_to_device(batch, module.device))[
        :dm.graph.num_nodes]


def other_decoders_ranking(z, test, known, dev):
    """(c): ComplEx, TransE and RotatE (seeded weights) over 8,192 test
    triples at full N, each held to the float64 brute force on 512."""
    pick = np.random.default_rng(SEED + 1).choice(len(test), OTHER_RANKED,
                                                  replace=False)
    triples = test[pick]
    total_gb = torch.cuda.get_device_properties(dev).total_memory / 1e9
    for name in OTHER_DECODERS:
        decoder = decoders_by_name(name).to(dev)
        decoder.init(torch.Generator().manual_seed(SEED + 5))
        timings = {}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with raw_ranks() as raw:
            t0 = time.perf_counter()
            metrics = ranking.filtered_ranking_metrics(
                decoder, z, triples, known, timings=timings)
            total = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        print_timings(f"ranking (c) {name}, {OTHER_RANKED} triples",
                      timings, total)
        print(f"ranking (c) {name}: metrics {json.dumps(metrics)}; peak "
              f"device memory {peak:.2f} GB of {total_gb:.2f} GB")
        check(all(np.isfinite(v) for v in metrics.values()),
              f"ranking (c) {name}: metrics not finite")
        rows = 256 if decoder.candidate_intermediates == 0 else 8
        brute_force_check(decoder, z, triples[:OTHER_BRUTE],
                          [np.maximum(r[:OTHER_BRUTE], 1.0) for r in raw],
                          known, f"ranking (c) {name}", rows_per_pass=rows)


def decoders_by_name(name: str):
    cls = {"complex": decoders.ComplEx, "transe": decoders.TransE,
           "rotate": decoders.RotatE}[name]
    return cls(num_relations=HPARAMS["num_relation"],
               hidden_channels=HPARAMS["out_dim"])


def planted_check(dev):
    """(d): the learning check of tests/test_planted.py on the card:
    RGCN 32→96→24 + DistMult, 800 full-batch epochs through
    ``train_fullbatch`` ("dst": the segsum; "sorted": negscore), then the
    tail-side filtered MRR and Hits@10 of the held-out tenth. Returns the
    training's launches (the counts set to 0 just before, read just
    after)."""
    columns, u = planted_triplets(**PLANTED)
    n, r = PLANTED["num_nodes"], PLANTED["num_relations"]
    feats = np.concatenate([u, np.random.default_rng(1).standard_normal(
        (n, 24)).astype(np.float32) * 0.1], axis=1)
    graph = TripletGraph(columns, encoder=lambda names: feats[np.array(
        [int(x.split("_")[1]) for x in names])]).graph
    tri = np.stack([graph.edge_index[0], graph.edge_type,
                    graph.edge_index[1]], 1)
    perm = np.random.default_rng(2).permutation(len(tri))
    n_test = len(tri) // 10
    test, train = tri[perm[:n_test]], tri[perm[n_test:]]
    gtrain = CSRGraph(num_nodes=n, num_relations=r, x=graph.x,
                      edge_index=np.stack([train[:, 0], train[:, 2]]),
                      edge_type=train[:, 1])
    module = KGEModule(
        encoder_name="rgcn", decoder_name="dismult", in_dim=32,
        hidden_dim=96, out_dim=24, num_hidden_layers=1, num_relation=r,
        num_heads=2, scheduler_type="cosine", learning_rate=1.5e-2,
        warm_up_ratio=0.05, fuse_method="none", neg_ratio=16,
        node_init_method="random").to(dev)
    module.edge_layout = "dst"
    batch = batch_to_device(FullGraphLoader(gtrain, edge_layout="dst")
                            .batch(), dev)
    module.configure_optimizers(PLANTED_EPOCHS)
    state = module.init_state(torch.Generator().manual_seed(0))
    reset_launch_counts()
    t0 = time.perf_counter()
    state, loss = module.train_fullbatch(
        state, batch, torch.Generator(device=dev).manual_seed(3),
        PLANTED_EPOCHS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    for name, count in launches.items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + count
    z = module.encode(batch)[:n]
    metrics = ranking.filtered_ranking_metrics(
        module.model.decoder, z, test, tri, both_sides=False, chunk=128)
    used = {k: v for k, v in launches.items() if v}
    print(f"planted (d): {len(train)} train / {len(test)} test triples; "
          f"{PLANTED_EPOCHS} full-batch epochs in {train_s:.2f} s, last loss "
          f"{float(loss):.6f}, launches {used}; "
          f"tail-side filtered {json.dumps(metrics)} (bounds MRR >= "
          f"{PLANTED_MRR}, Hits@10 >= {PLANTED_HITS10})")
    check(launches["sorted_segment_sum"] > 0
          and launches["distmult_neg_scores"] == PLANTED_EPOCHS,
          f"planted: the kernels did not run ({launches})")
    check(metrics["mrr"] >= PLANTED_MRR
          and metrics["hits@10"] >= PLANTED_HITS10,
          f"planted: the port did not learn the planted structure "
          f"({metrics})")
    return launches


def printed_metrics(out: str, header: str) -> dict:
    """The ``  key: value`` lines an entry point prints under
    ``header``."""
    check(header in out, f"no {header!r} block printed")
    metrics = {}
    for line in out.split(header + "\n", 1)[1].splitlines():
        if not line.startswith("  "):
            break
        key, value = line.strip().rsplit(": ", 1)
        metrics[key] = float(value)
    return metrics


def check_unseen(metrics: dict, what: str):
    print(f"{what} unseen-node metrics: {json.dumps(metrics)}")
    check(metrics and all(np.isfinite(v) for v in metrics.values()),
          f"{what}: unseen metrics missing or not finite")
    check(0.0 < metrics["unseen_mrr"] <= 1.0,
          f"{what}: unseen MRR {metrics.get('unseen_mrr')}")
    check(metrics["unseen_num_nodes"] > 0
          and metrics["unseen_num_test_edges"] > 0,
          f"{what}: no unseen nodes or edges")


def cold_start_steps(dm, dev):
    """(e) in-process: a warm-up step, then COLD_STEPS cold-start
    training steps (bf16, "sorted", "dst", keep masks from the step's
    generator) with the launch counts set to 0 just before and read just
    after, then one step with the kernels against the plain versions
    under one injected keep mask. Returns the counted launches."""
    loader = dm.train_dataloader(loader_type="saint")
    batches = [batch_to_device(loader.sample()[0], dev)
               for _ in range(COLD_STEPS + 2)]
    module = KGEModule(**dict(TRAIN, cold_start_dropout=COLD_START)).to(dev)
    module.edge_layout = "dst"
    module.set_feature_table(dm.graph.x)
    module.configure_optimizers(num_training_steps=100)
    state = module.init_state(torch.Generator().manual_seed(SEED + 7))
    sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    state, _ = module.train_steps(state, batches[1:2], gen)
    state, launches, _ = timed_steps(module, state, batches[2:], gen,
                                     "cold-start train step")
    check(launches == expected_launches(SEGSUM_PER_STEP * COLD_STEPS,
                                        "distmult_neg_scores", COLD_STEPS),
          f"cold-start steps: launches {launches}")
    compare_step(sd, module.feature_table, dev, batches[0],
                 "distmult_neg_scores", "cold-start",
                 cold_start_dropout=COLD_START)
    return launches


def ranking_phase(dm, dev, tmp, ckpt):
    """Phase 10; returns every kernel's launches over its counted paths:
    (a)'s encode, (d)'s training and the cold-start steps."""
    t0 = time.perf_counter()
    unseen_run = start_train_kge(tmp, *UNSEEN_KEYS)
    segsum_n, z, test, known = full_split_ranking(dm, dev, ckpt)
    other_decoders_ranking(z, test, known, dev)
    del z
    torch.cuda.empty_cache()
    planted = planted_check(dev)
    cold = cold_start_steps(dm, dev)

    unseen_ckpt = finish_train_kge(unseen_run, "unseen-node", dm.graph, t0)
    check_unseen(printed_metrics(unseen_run.out,
                                 "unseen-node (inductive) metrics:"),
                 "train_kge")
    t1 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    run = subprocess.run(
        [sys.executable, "-m", "biomedkg_tpu_torch.test_kge",
         f"pretrained_path={unseen_ckpt}", "filter_neg=true", "steps=3",
         UNSEEN_KEYS[0], f"seed={SEED}"],
        cwd=unseen_run.cwd, env=dict(os.environ, PYTHONPATH=root),
        capture_output=True, text=True, timeout=600)
    print(f"test_kge on the unseen-node checkpoint, filter_neg=true "
          f"({time.perf_counter() - t1:.1f} s, rc {run.returncode})")
    check(run.returncode == 0, f"test_kge failed: {run.stderr[-3000:]}")
    tested = printed_metrics(run.stdout, "test metrics:")
    shown = {k: v for k, v in tested.items()
             if "AUROC" in k or k.endswith("loss")}
    print(f"test_kge test metrics: {json.dumps(shown)}")
    check(all(np.isfinite(v) for v in tested.values())
          and 0.0 <= tested["test_AUROC"] <= 1.0,
          f"test_kge: test metrics {tested}")
    check_unseen(printed_metrics(run.stdout,
                                 "unseen-node (inductive) metrics:"),
                 "test_kge")
    return {name: cold[name] + planted[name]
            + (segsum_n if name == "sorted_segment_sum" else 0)
            for name in cold}


# -- phase 11: the config layer and Stage B's multimodal remainder ---------
# (scripts/gcl.sh; scripts/kge.sh with NODE_INIT_METHOD gcl and lm) ------
LM_DIM = 768                      # Stage A's rows (configs/data embed_dim)
GCL_TYPES = ("gene", "drug", "disease")
GCL_FUSED = dict(GCL, fuse_method="attention")   # scripts/gcl.sh
GCL_REDAF = dict(GCL, fuse_method="redaf")
GCL_EMBED = GCL["out_dim"]        # GCLEncode's rows, scripts/kge.sh's 256
P11_GCL_STEPS = 3                 # train_gcl steps (the script: 100 epochs)
P11_KGE_STEPS = 3                 # train_kge steps (the script: 100 epochs)
P11_GGD = (2, 5, 2)               # GGD + attention: warm-up, timed, profiled
P11_GRACE = (1, 2)                # GRACE + ReDAF bf16: warm-up, counted
P11_STAGE_C = (2, 5)              # GCL-initialised Stage C steps at K = 1
# scripts/kge.sh's shapes in a process of their own (python3 chip_smoke.py
# KGE_SH_SHAPES <working directory>): its result line's prefix
KGE_SH_SHAPES = "kge-sh-shapes"
KGE_SH_RESULT = "kge.sh shapes result: "
P11_SERVE = ("score gene_000000 protein_protein gene_000001\n"
             "topk drug_000001 drug_drug 3\nquit\n")


def script_args(script: str, **variables) -> list:
    """The arguments ``scripts/<script>`` passes to its entry point, as
    bash expands them, with ``variables`` set first."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "scripts", script)) as f:
        text = f.read()
    for name, value in variables.items():
        text, n = re.subn(rf"^{name}=.*$", f'{name}="{value}"', text,
                          flags=re.M)
        check(n == 1, f"{script}: no {name}= line")
    text, n = re.subn(r"^python3 \S+\.py", "printf '%s\\n'", text,
                      flags=re.M)
    check(n == 1, f"{script}: no python3 line")
    return subprocess.run(["bash", "-c", text], capture_output=True,
                          text=True, check=True, timeout=60).stdout.split()


@contextlib.contextmanager
def working_dir(path: str):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def lm_workspace(tmp: str, names) -> str:
    """A working directory with configs/ linked and the LM cache Stage A
    would write (``data/embed/primekg_modality_lm.pickle``): a (2, 768)
    row for every name, from a seed, L2-normalised over the modality
    axis."""
    root = os.path.dirname(os.path.abspath(__file__))
    ws = tempfile.mkdtemp(dir=tmp)
    os.symlink(os.path.join(root, "configs"), os.path.join(ws, "configs"))
    t0 = time.perf_counter()
    rows = np.random.default_rng(SEED).standard_normal(
        (len(names), 2, LM_DIM), dtype=np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    os.makedirs(os.path.join(ws, "data", "embed"))
    with open(os.path.join(ws, "data", "embed",
                           "primekg_modality_lm.pickle"), "wb") as f:
        pickle.dump(dict(zip(names, rows)), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    print(f"LM cache: {len(names)} names x (2, {LM_DIM}) float32, "
          f"L2-normalised over the modality axis, written in "
          f"{time.perf_counter() - t0:.1f} s")
    return ws


def start_entry(ws: str, entry: str, args, log_dir: str, env=None):
    """``python -m biomedkg_tpu_torch.<entry> <args> log_dir=<log_dir>`` on
    the card in ``ws`` (``env``: more environment variables)."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"biomedkg_tpu_torch.{entry}", *args,
         f"log_dir={log_dir}"],
        cwd=ws, env=dict(os.environ, PYTHONPATH=root, **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.log_dir, proc.cwd = log_dir, ws
    return proc


def finish_train_gcl(proc, node_type: str, t0: float) -> str:
    """Wait for a scripts/gcl.sh run and check it: GGD with attention
    fusion over the LM features of the node type's graph, the reference's
    flow (top-1, the test on it, val and test losses logged), the
    checkpoint where GCLEncode globs."""
    out, errs = proc.communicate(timeout=900)
    full = "gene/protein" if node_type == "gene" else node_type
    print(f"train_gcl scripts/gcl.sh {node_type} "
          f"({time.perf_counter() - t0:.1f} s, rc {proc.returncode}):",
          out.strip().replace("\n", " | "))
    check(proc.returncode == 0, f"train_gcl {node_type}: {errs[-2000:]}")
    check(out.startswith(f"train_gcl: ggd on {full}: ")
          and f"features (2, {LM_DIM}) (lm), fusion attention" in out,
          f"train_gcl {node_type}: not GGD + attention over LM features")
    ckpt = os.path.normpath(os.path.join(
        proc.cwd, out.split("checkpoint: ")[-1].strip()))
    check(f"/ckpt/gcl/{node_type}/ggd_attention_lm_" in ckpt,
          f"train_gcl {node_type}: checkpoint {ckpt}")
    logged = check_reference_flow(proc, ckpt, f"train_gcl {node_type}", 1,
                                  False, "gcl")
    check({"val_loss", "test_loss"} <= set(logged),
          f"train_gcl {node_type}: metrics {sorted(logged)}")
    return ckpt


def lm_gene_module(ws: str):
    """The gene/protein graph's data module over the LM cache
    (scripts/gcl.sh's batch of 64 seeds), set up in ``ws``."""
    with working_dir(ws):
        dm = PrimeKGModule(**dict(PRIMEKG_DATA, node_type=GCL_NODE_TYPE,
                                  batch_size=64, node_init_method="lm"),
                           seed=SEED)
        dm.setup(stage="split")
    dm.edge_layout = "dst"
    dm.device_features = True
    return dm


def ggd_attention_steps(dm, dev):
    """Phase 11's GGD + attention step at full width (the configs'
    float32): timed (host clock, CUDA events), launches counted, and a
    torch.profiler window whose matrix products are split between the
    fuser (models/fusion.py) and the GCN by a profiler range around the
    fuser's forward (split_by_fusion); returns (the device batches, the
    feature table, the launches)."""
    warm, steps, profiled = P11_GGD
    loader = dm.train_dataloader(loader_type="neighbor")
    loader.set_epoch(0)
    t0 = time.perf_counter()
    host = list(itertools.islice(loader, warm + steps))
    sample_ms = (time.perf_counter() - t0) * 1e3 / len(host)
    batches = [batch_to_device(b, dev) for b in host]
    table = torch.as_tensor(dm.graph.x, dtype=torch.float32).to(dev)
    print(f"GGD + attention: {GCL_NODE_TYPE[0]} graph {dm.graph.num_nodes} "
          f"nodes, features {tuple(dm.graph.x.shape[1:])}; neighbour "
          f"envelope {loader.node_budget} node x {loader.edge_budget} edge "
          f"slots (64 seeds); host sampling {sample_ms:.1f} ms per batch")
    module = gcl_module.GGDModule(**GCL_FUSED).to(dev)
    module.edge_layout = "dst"
    module.feature_table = table
    module.configure_optimizers(num_training_steps=100)
    state = module.init_state(torch.Generator().manual_seed(SEED))
    sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state, _ = module.train_steps(state, batches[:warm], gen)
    torch.cuda.synchronize()
    what = "GGD + attention float32 train step"
    state, launches, _ = timed_steps(module, state, batches[warm:], gen,
                                     what, work=real_nodes)
    check(launches == expected_launches(SEGSUM_PER_GCL_STEP * steps, None,
                                        0), f"{what}: launches {launches}")
    profile_steps(module, state, batches[-profiled:], gen, what,
                  fusion_ops=("aten::mm", "aten::bmm", "aten::addmm"))
    fusion_times(module, batches[-1], what)
    del module, state
    return batches, table, sd, launches


def fusion_times(module, batch, what: str):
    """The fuser alone on one batch's features, forward and forward +
    backward (CUDA events, median of ITERS), beside the step."""
    x = module._batch_features(batch)
    params = list(module.fusion.parameters())
    g = torch.randn(x.shape[0], x.shape[2], device=x.device,
                    generator=torch.Generator(x.device).manual_seed(SEED))

    def both():
        torch.autograd.grad(module.fusion(x), params, g)

    with torch.no_grad():
        fwd = time_ms(lambda: module.fusion(x))
    ms = time_ms(both)
    rows, d = x.shape[0] * x.shape[1], x.shape[2]
    # q, k, v: the forward and the weight gradient (the features need
    # none)
    flop = 3 * 2 * rows * d * d * 2
    print(f"{what}: the fuser ({type(module.fusion).__name__}, "
          f"{tuple(x.shape)} float32) alone {fwd:.3f} ms forward, "
          f"{ms:.3f} ms forward + backward (CUDA events); its q, k, v "
          f"products {flop / 1e9:.1f} GFLOP, bound "
          f"{flop / FP32_FLOP_PER_S * 1e3:.3f} ms at "
          f"{FP32_FLOP_PER_S / 1e12:g} TFLOP/s float32")


def grace_redaf_steps(dev, table, batches):
    """GRACE + ReDAF in bf16: a few steps with launches counted (segsum 8,
    flash 2 + 2 a step), then one batch's loss and every gradient with the
    kernels against the plain versions in both types, ReDAF's keep mask
    one of the draws both runs share."""
    warm, steps = P11_GRACE
    module = gcl_module.GRACEModule(**GCL_REDAF,
                                    compute_dtype="bfloat16").to(dev)
    module.edge_layout = "dst"
    module.feature_table = table
    module.configure_optimizers(num_training_steps=100)
    state = module.init_state(torch.Generator().manual_seed(SEED + 3))
    sd = {n: t.detach().clone() for n, t in module.state_dict().items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    state, _ = module.train_steps(state, batches[:warm], gen)
    what = "GRACE + ReDAF bf16 train step"
    _, launches, _ = timed_steps(module, state,
                                 batches[warm:warm + steps], gen, what,
                                 work=real_nodes)
    check(launches == expected_launches(
        SEGSUM_PER_GCL_STEP * steps, None, 0, flash_n=FLASH_PER_STEP * steps,
        flash_design=flashnce.PATH[torch.bfloat16]),
        f"{what}: launches {launches}")
    del module, state
    gcl_compare_step(gcl_module.GRACEModule, sd, table, dev, batches[0],
                     FLASH_PER_STEP, hp=GCL_REDAF, what="GRACE + ReDAF")
    return launches


def gcl_encode_phase(ws: str, dev):
    """Phase 11b: ``GCLEncode`` from the three scripts/gcl.sh checkpoints:
    one full-graph encode per node type on the card (launch counts set to
    0 just before and read just after), each encode's z (the cache's rows)
    held against the plain versions' encode of the same batch on the
    card; returns the launches."""
    encodes = []
    load = gcl_module.load_gcl_module

    def recording_load(path, device=None):
        module = load(path, device)
        encode = module.encode

        def recorded(batch):
            z = encode(batch)
            encodes.append((module, encode, batch, z))
            return z

        module.encode = recorded
        return module

    gcl_module.load_gcl_module = recording_load
    try:
        with working_dir(ws):
            reset_launch_counts()
            t0 = time.perf_counter()
            enc = node_encoders.GCLEncode("ggd", "attention",
                                          embed_dim=GCL_EMBED, device="cuda")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            launches = launch_counts()
    finally:
        gcl_module.load_gcl_module = load
    check(len(encodes) == len(GCL_TYPES)
          and launches == expected_launches(len(GCL_TYPES) * CONVS, None, 0),
          f"GCLEncode: {len(encodes)} encodes, launches {launches}")
    for node_type, (module, encode, batch, z) in zip(GCL_TYPES, encodes):
        with plain_versions():
            z_plain = encode(batch)
        n = int(batch.node_mask.sum())
        err = float((z[:n] - z_plain[:n]).abs().max())
        scale = float(z_plain[:n].abs().max())
        print(f"GCLEncode {node_type}: {n} rows of {z.shape[1]} (fusion "
              f"{module.hparams['fuse_method']}); kernels vs plain "
              f"max_abs_err={err:.3g} (tol {Z_RTOL:g}·max|z| = "
              f"{Z_RTOL * scale:.3g})")
        check(bool(torch.isfinite(z[:n]).all()),
              f"GCLEncode {node_type}: rows not finite")
        check(err <= Z_RTOL * scale, f"GCLEncode {node_type}: rows disagree "
                                     "with the plain versions' encode")
    rows = sum(int(b.node_mask.sum()) for _, _, b, _ in encodes)
    check(len(enc.node_mapping) <= rows,
          f"GCLEncode: {len(enc.node_mapping)} cached rows of {rows}")
    print(f"GCLEncode: cache of {len(enc.node_mapping)} rows built in "
          f"{build_s:.1f} s (three graph builds over the LM cache, three "
          f"encodes); launches {({k: v for k, v in launches.items() if v})}")
    del encodes
    return launches


def kge_sh_config(ws: str, init: str, *extra):
    """configs/kge.yaml composed with scripts/kge.sh's arguments for
    NODE_INIT_METHOD ``init`` and ``extra``, on the card, in ``ws``."""
    args = script_args("kge.sh", NODE_INIT_METHOD=init) + [*extra,
                                                            "device=cuda"]
    with working_dir(ws):
        return load_config(CONFIG_DIR, "kge", cli_overrides(args))


def kge_sh_hparams(cfg, num_relation: int) -> dict:
    """The KGE module train_kge builds from ``cfg``, without its
    ``compute_dtype`` (compare_step sets each type)."""
    hp = dict(cfg.model, in_dim=cfg.data.embed_dim, num_relation=num_relation,
              neg_ratio=cfg.neg_ratio,
              node_init_method=cfg.data.node_init_method, seed=cfg.seed)
    hp.pop("compute_dtype")
    return hp


def lm_table(ws: str, names, dev) -> torch.Tensor:
    """The LM cache's (N, 2, 768) rows in ``names``' order, on the card."""
    with open(os.path.join(ws, "data", "embed",
                           "primekg_modality_lm.pickle"), "rb") as f:
        rows = pickle.load(f)
    return torch.from_numpy(np.stack([rows[n] for n in names])).to(dev)


def kge_sh_shapes_main(dev, ws: str) -> int:
    """Phase 11 (e) at scripts/kge.sh's shapes (batch 64, K = 1), in a
    process of its own so that its 768-slot SAINT batches are the first
    the negscore kernels and the bucket build see: the data module and the
    model train_kge builds from the script's arguments (NODE_INIT_METHOD
    gcl, over the GCL cache phase 11b wrote in ``ws``); one batch's loss
    and every gradient with the kernels against the plain versions, GCL-
    and LM-initialised (attention fusion), in bf16 and float32; the segsum
    at that batch's shape; P11_STAGE_C float32 steps with their launches
    counted (segsum 6, negscore 1 + 1 a step); then the negscore pair and
    the bucket build against their plain versions at that shape. Prints
    KGE_SH_RESULT and a JSON object: the launches, the K = 1 records."""
    for lib in (segsum.LIBRARY, negscore.LIBRARY):
        lib.lib()
    check(native.get_lib() is not None, "the host sampler did not build")
    cfg = kge_sh_config(ws, "gcl")
    with working_dir(ws):
        dm = train_kge.data_module(cfg)
    dm.device_features = True
    dm.saint_fill_target = train_kge.saint_fill(cfg)
    dm.edge_layout = "dst"
    loader = dm.train_dataloader(loader_type="saint")
    warm, steps = P11_STAGE_C
    batches = [batch_to_device(loader.sample()[0], dev)
               for _ in range(warm + steps)]
    batch = batches[0]
    n = batch.node_mask.shape[0]
    table = torch.as_tensor(dm.graph.x, dtype=torch.float32).to(dev)
    hp = kge_sh_hparams(cfg, dm.data.num_edge_types)
    print(f"scripts/kge.sh gcl in-process: SAINT envelope {loader.node_budget}"
          f" node x {loader.edge_budget} edge slots (batch "
          f"{cfg.data.batch_size}, K = {cfg.neg_ratio}); features "
          f"{tuple(table.shape)}")
    check(n == loader.node_budget and cfg.neg_ratio == 1
          and cfg.data.batch_size == 64,
          f"not scripts/kge.sh's shapes: {n} node slots, K = "
          f"{cfg.neg_ratio}, batch {cfg.data.batch_size}")
    check(all(k.launches == 0 for k in negscore.KERNELS.values())
          and negscore.BUCKETS.launches == 0,
          "a negscore kernel ran before scripts/kge.sh's shapes")

    # one batch, kernels against plain versions: GCL- then LM-initialised
    module = KGEModule(**hp)
    module.init(torch.Generator().manual_seed(SEED))
    compare_step({k: t.detach().clone() for k, t in
                  module.state_dict().items()}, table, dev, batch,
                 "distmult_neg_scores", "scripts/kge.sh gcl (K = 1)", **hp)
    lm_cfg = kge_sh_config(ws, "lm", "model.fuse_method=attention")
    lm_hp = kge_sh_hparams(lm_cfg, dm.data.num_edge_types)
    lm = KGEModule(**lm_hp)
    lm.init(torch.Generator().manual_seed(SEED))
    compare_step({k: t.detach().clone() for k, t in lm.state_dict().items()},
                 lm_table(ws, dm.data.node_list, dev), dev, batch,
                 "distmult_neg_scores", "scripts/kge.sh lm + attention "
                 "(K = 1)", **lm_hp)
    del lm
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    segsum_batch_times(batch, hp["hidden_dim"], torch.float32, gen,
                       "conv (scripts/kge.sh's SAINT batch)", counts=True)

    # the steps, launches counted
    module = KGEModule(**dict(hp, compute_dtype=cfg.model.compute_dtype))
    module.to(dev)
    module.edge_layout = "dst"
    module.feature_table = table
    module.configure_optimizers(num_training_steps=100)
    state = module.init_state(torch.Generator().manual_seed(SEED))
    state, _ = module.train_steps(state, batches[:warm], gen)
    what = "GCL-initialised Stage C float32 train step (K = 1)"
    _, launches, _ = timed_steps(module, state, batches[warm:], gen, what,
                                 work=lambda b: (
                                     sum(int(x.edge_mask.sum()) for x in b)
                                     * (1 + cfg.neg_ratio),
                                     "triplets/s (real edges x (1 + K))"))
    check(launches == expected_launches(SEGSUM_PER_STEP * steps,
                                        "distmult_neg_scores", steps),
          f"{what}: launches {launches}")

    # the negscore pair and the bucket build at this shape
    z = encoded(module, batch)
    negatives = path_negatives(batch, gen, False, k=cfg.neg_ratio)
    ds = torch.randn(negatives[0].shape[0], generator=gen, device=dev)
    records = negscore_records(
        "distmult", False, z, negatives,
        module.model.decoder.rel_emb.detach(), ds, launches)
    records.append(bucket_checks(dev, negatives, n))
    print(KGE_SH_RESULT + json.dumps({"launches": launches,
                                      "records": records}))
    return 0


def kge_sh_shapes(ws: str):
    """``python3 chip_smoke.py KGE_SH_SHAPES ws`` started (kge_sh_shapes_main);
    ``finish_kge_sh_shapes`` reads it."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), KGE_SH_SHAPES, ws],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_kge_sh_shapes(proc, t0: float):
    """(the launches, the K = 1 records) of a kge_sh_shapes run, its
    launches added into PATH_LAUNCHES."""
    out, errs = proc.communicate(timeout=900)
    body = "\n".join(line for line in out.strip().splitlines()
                     if not line.startswith(KGE_SH_RESULT))
    print(f"scripts/kge.sh's shapes in their own process "
          f"({time.perf_counter() - t0:.1f} s, rc {proc.returncode}):\n"
          f"{body}")
    check(proc.returncode == 0, f"scripts/kge.sh's shapes failed: "
                                f"{errs[-3000:]}")
    result = json.loads(next(line for line in out.splitlines()
                             if line.startswith(KGE_SH_RESULT))
                        [len(KGE_SH_RESULT):])
    for name, count in result["launches"].items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + count
    return result["launches"], result["records"]


def finish_entry(proc, what: str, t0: float, timeout=900) -> str:
    out, errs = proc.communicate(timeout=timeout)
    print(f"{what} ({time.perf_counter() - t0:.1f} s, rc "
          f"{proc.returncode})")
    check(proc.returncode == 0, f"{what} failed: {errs[-3000:]}")
    return out


def multimodal_phase(dm, dev, tmp):
    """Phase 11; returns every kernel's launches over its counted paths
    and the negscore pair's records at K = 1."""
    t_phase = time.perf_counter()
    dm.edge_layout = "dst"
    dm.device_features = True
    ws = lm_workspace(tmp, dm.data.node_list)
    gcl_sh = {t: script_args("gcl.sh", NODE_TYPE=t) for t in GCL_TYPES}
    kge_gcl = script_args("kge.sh", NODE_INIT_METHOD="gcl")
    kge_lm = script_args("kge.sh", NODE_INIT_METHOD="lm")
    print(f"scripts/gcl.sh (gene): {' '.join(gcl_sh['gene'])}")
    print(f"scripts/kge.sh (gcl): {' '.join(kge_gcl)}")
    cut = ["epochs=1", "val_every_epoch=1"]

    # (a) first, alone on the card: the GGD + attention step, timed
    gene = lm_gene_module(ws)
    batches, table, ggd_sd, total = ggd_attention_steps(gene, dev)

    # (a) scripts/gcl.sh for the three node types and (d) scripts/kge.sh's
    # LM branch with attention fusion, started together
    t0 = time.perf_counter()
    gcl_runs = {t: start_entry(ws, "train_gcl", gcl_sh[t] + cut + [
        f"steps={P11_GCL_STEPS}"], f"{ws}/log_gcl_{t}") for t in GCL_TYPES}
    lm_run = start_entry(ws, "train_kge", kge_lm + cut + [
        "model.fuse_method=attention", f"steps={P11_KGE_STEPS}",
        f"ckpt_dir={ws}/ckpt_lm"], f"{ws}/log_kge_lm")

    # (e) beside them: the fused steps' kernels against the plain versions
    gcl_compare_step(gcl_module.GGDModule, ggd_sd, table, dev, batches[0],
                     0, hp=GCL_FUSED, what="GGD + attention")
    grace = grace_redaf_steps(dev, table, batches)
    total = {k: total[k] + grace[k] for k in total}
    del batches, table, gene
    torch.cuda.empty_cache()

    ckpts = {t: finish_train_gcl(gcl_runs[t], t, t0) for t in GCL_TYPES}
    # (b) GCLEncode from those checkpoints, on the card
    encode_launches = gcl_encode_phase(ws, dev)
    total = {k: total[k] + encode_launches[k] for k in total}

    # (c) scripts/kge.sh with NODE_INIT_METHOD=gcl, then rank_eval and the
    # serve loop on its checkpoint, through the config layer
    t1 = time.perf_counter()
    gcl_run = start_entry(ws, "train_kge", kge_gcl + [
        "epochs=2", "val_every_epoch=1", f"steps={P11_KGE_STEPS}",
        f"ckpt_dir={ws}/ckpt"], f"{ws}/log_kge_gcl")
    # (e) at scripts/kge.sh's shapes, in a process of its own, beside it
    shapes = kge_sh_shapes(ws)
    stage_c, k1_records = finish_kge_sh_shapes(shapes, t1)
    total = {k: total[k] + stage_c.get(k, 0) for k in total}

    lm_ckpt = finish_train_kge(lm_run, "scripts/kge.sh lm + attention",
                               dm.graph, t0)
    check("features (2, 768) (lm)" in lm_run.out
          and "_lm" in os.path.basename(os.path.dirname(lm_ckpt)),
          "train_kge lm + attention: not on LM features")
    lm = load_kge_module(lm_ckpt, device="cpu")
    check(lm.hparams["fuse_method"] == "attention" and lm.fusion is not None,
          "train_kge lm + attention: no fuser in the checkpoint")
    ckpt = finish_train_kge(gcl_run, "scripts/kge.sh gcl", dm.graph, t1,
                            epochs=2)
    check(f"features (1, {GCL_EMBED}) (gcl)" in gcl_run.out
          and "_gcl_ggd_attention" in ckpt,
          "train_kge gcl: not on the GCL cache's features")
    t2 = time.perf_counter()
    rank = start_entry(ws, "rank_eval", kge_gcl + [
        f"pretrained_path={ckpt}"], f"{ws}/log_rank")
    root = os.path.dirname(os.path.abspath(__file__))
    served = subprocess.run(
        [sys.executable, "-m", "biomedkg_tpu_torch.serve", *kge_gcl,
         f"pretrained_path={ckpt}"], input=P11_SERVE, cwd=ws,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=600)
    print(f"serve on the GCL-initialised checkpoint "
          f"({time.perf_counter() - t2:.1f} s, rc {served.returncode}): "
          + served.stdout.strip().replace("\n", " | "))
    check(served.returncode == 0, f"serve failed: {served.stderr[-3000:]}")
    lines = served.stdout.strip().splitlines()
    check(len(lines) == 5 and lines[0].startswith("ready.")
          and 0.0 < float(lines[1]) < 1.0
          and all(line.split()[1].startswith("drug_") for line in lines[2:]),
          f"serve: answers {lines}")
    out = finish_entry(rank, "rank_eval on the GCL-initialised checkpoint",
                       t2)
    ranked = printed_metrics(out, "filtered-ranking metrics:")
    print(f"rank_eval: {json.dumps(ranked)}")
    check(all(np.isfinite(v) for v in ranked.values())
          and 0.0 < ranked["mrr"] <= 1.0, f"rank_eval: metrics {ranked}")
    print(f"phase 11: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{({k: v for k, v in total.items() if v})}; GCL checkpoints "
          f"{sorted(os.path.relpath(c, ws) for c in ckpts.values())}")
    return total, k1_records


# -- phase 12: DPI fine-tuning and the on-ramps ------------------------------
P12_STEPS = 3                     # train_dpi steps an epoch (the script: 100
#                                   epochs of the data module's 1000)
P12_EPOCHS = 2
P12_STEPS_TIMED = (2, 4)          # DPI steps in dpi-shapes: warm-up, timed
DRUG_PROTEIN = train_dpi.DRUG_PROTEIN
# the RGAT warm start's leaves whose bf16 gradient, kernels against plain
# versions, lies 0.036-0.081 of its max apart at DPI's small dense batch:
# there each version's bf16 gradient is 0.03-0.12 of its max from the
# float32 one (every RGAT leaf is 0.02-0.3 from it on an H100; PERF.md,
# DPI), so compare_step holds these to the plain float32 gradient in bf16
RGAT_DPI_CANCELLING = tuple(f"model.encoder.layers.{leaf}" for leaf in (
    "1.b", "2.att_dst", "3.w_rel", "3.att_dst", "3.b"))
# the PrimeKG++-scale synthetic graph as a csv (data/primekg.py's sizes)
KG_CSV_SIZES = dict(num_gene=27000, num_drug=8000, num_disease=17000,
                    num_edges=1_300_000, seed=42)
# the DrugBank DTI stand-in at PrimeKG++'s drug and gene counts, with the
# drug-protein share of its edges (0.06 x 1.3 M, PRIMEKG_RELATIONS)
DPI_CSV_SIZES = dict(num_drug=8000, num_gene=27000, num_edges=78_000,
                     seed=43)
# rows of that csv given an NA token (column, token): dropna drops them
DPI_CSV_NA = [("x_name", ""), ("y_name", "NA"), ("relation", "null"),
              ("source", "N/A"), ("y_type", "NaN"), ("x_type", "None"),
              ("source", "#N/A"), ("y_name", "<NA>")]
DPI_SHAPES = "dpi-shapes"
DPI_SHAPES_RESULT = "dpi shapes result: "
LIGHTNING_PARSING = "lightning.pytorch.utilities.parsing"


def lightning_attribute_dict():
    """A stand-in for Lightning's ``AttributeDict`` under its real import
    path, so that a save names it as a Lightning save does."""
    parts = LIGHTNING_PARSING.split(".")
    for i in range(1, len(parts) + 1):
        sys.modules.setdefault(".".join(parts[:i]),
                               type(sys)(".".join(parts[:i])))
    parsing = sys.modules[LIGHTNING_PARSING]
    if not hasattr(parsing, "AttributeDict"):
        parsing.AttributeDict = type("AttributeDict", (dict,),
                                     {"__module__": LIGHTNING_PARSING})
    return parsing.AttributeDict


def write_lightning_kge(path: str, module: KGEModule, step: int = 4242):
    """``module`` (an RGCN KGE model) as the reference's Lightning module
    saves it: ``torch.save`` of the ``state_dict`` in its key vocabulary
    (PyG ``RGCNConv`` ``weight`` / ``root`` / ``bias`` under
    ``model.encoder.graph_layers.{i}``, ``model.decoder.rel_emb``), the
    ``hyper_parameters`` as an ``AttributeDict`` and ``global_step``."""
    sd = {}
    for i, layer in enumerate(module.model.encoder.layers):
        prefix = f"model.encoder.graph_layers.{i}"
        sd[prefix + ".weight"] = layer.w_rel.detach().cpu().clone()
        sd[prefix + ".root"] = layer.w_root.detach().cpu().clone()
        sd[prefix + ".bias"] = layer.b.detach().cpu().clone()
    sd["model.decoder.rel_emb"] = \
        module.model.decoder.rel_emb.detach().cpu().clone()
    hp = {k: module.hparams[k] for k in (
        "encoder_name", "decoder_name", "in_dim", "hidden_dim", "out_dim",
        "num_hidden_layers", "num_relation", "num_heads", "scheduler_type",
        "learning_rate", "warm_up_ratio", "fuse_method", "neg_ratio",
        "node_init_method")}
    torch.save({"state_dict": sd,
                "hyper_parameters": lightning_attribute_dict()(hp),
                "global_step": step, "epoch": 3,
                "pytorch-lightning_version": "2.2.0"}, path)


def kg_csv_onramp(tmp: str, dm):
    """Phase 12a: the PrimeKG++-scale synthetic columns written as a csv,
    read back through BIOMEDKG_KG_CSV with its SHA-256 checked: the node
    list, edge arrays and edge map equal the in-memory build's; a wrong
    checksum raises; the read's rows per second."""
    columns = synthetic_triplets(**KG_CSV_SIZES)
    columns["display_relation"] = columns["relation"]
    path = os.path.join(tmp, "kg.csv")
    t0 = time.perf_counter()
    write_csv_columns(path, columns)
    write_s = time.perf_counter() - t0
    digest = csv_columns.sha256(path)
    rows = len(columns["x_type"])
    env = {"BIOMEDKG_KG_CSV": path, "BIOMEDKG_KG_CSV_SHA256": digest}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        csv_columns.read_csv_columns(path, COLUMNS)
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        kg = PrimeKG(data_dir=os.path.join(tmp, "no_kg_dir"),
                     node_type=PRIMEKG_DATA["node_type"])
        build_s = time.perf_counter() - t0
        os.environ["BIOMEDKG_KG_CSV_SHA256"] = "0" * 64
        try:
            PrimeKG(data_dir=tmp, node_type=PRIMEKG_DATA["node_type"])
        except ValueError as e:
            refused = "checksum mismatch" in str(e)
        else:
            refused = False
    finally:
        for key in env:
            os.environ.pop(key, None)
    mem = dm.data
    same = (kg.node_list == mem.node_list
            and kg.edge_map_index == mem.edge_map_index
            and np.array_equal(kg.graph.edge_index, mem.graph.edge_index)
            and np.array_equal(kg.graph.edge_type, mem.graph.edge_type)
            and kg.node_to_global == mem.node_to_global)
    print(f"kg.csv on-ramp: {rows} rows, {os.path.getsize(path) / 1e6:.1f} "
          f"MB written in {write_s:.2f} s; BIOMEDKG_KG_CSV read in "
          f"{read_s:.2f} s ({rows / read_s:,.0f} rows/s, host), the PrimeKG "
          f"graph built from it in {build_s:.2f} s: {kg.graph.num_nodes} "
          f"nodes, {kg.graph.num_edges} edges, equal to the in-memory "
          f"build: {same}; a wrong BIOMEDKG_KG_CSV_SHA256 refused: "
          f"{refused}; {card_line()}")
    check(same, "kg.csv on-ramp: the csv graph differs from the in-memory "
                "build")
    check(refused, "kg.csv on-ramp: a wrong checksum did not raise")
    os.remove(path)


def lightning_import(dm, dev, native: str, lightning: str):
    """Phase 12b: the Lightning file served by ``KGEScorer`` (its
    ``load_kge_module``, the full-graph encode on the card, launches
    counted); z against the encode of the native checkpoint's same
    weights; requests answered. Returns the launches."""
    ckpt = load_checkpoint(lightning)
    check(ckpt["step"] == 4242 and ckpt["hparams"]["num_relation"]
          == HPARAMS["num_relation"], f"Lightning import: {ckpt['hparams']}")
    reset_launch_counts()
    t0 = time.perf_counter()
    scorer = KGEScorer(lightning, dm, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    launches = launch_counts()
    check(launches == expected_launches(SEGSUM_PER_ENCODE, None, 0),
          f"Lightning import: launches {launches}")
    native_module = load_kge_module(native, dev)
    batch = FullGraphLoader(dm.graph, edge_layout="dst").batch()
    z_native = native_module.encode(batch_to_device(batch, dev))
    n = dm.graph.num_nodes
    err = float((scorer.z - z_native[:n]).abs().max())
    scale = float(z_native[:n].abs().max())
    p = scorer.score("gene_000000", "protein_protein", "gene_000001")
    top = scorer.topk_tails("drug_000001", "drug_protein", 5)
    print(f"Lightning .ckpt (reference key vocabulary, AttributeDict "
          f"hparams, RGCN 768→256×4 + DistMult, 8 relations): KGEScorer "
          f"init {init_s:.2f} s (data build + load + encode), launches "
          f"{({k: v for k, v in launches.items() if v})}; z vs the native "
          f"checkpoint's encode max_abs_err={err:.3g} (tol {Z_RTOL:g}·max|z|"
          f" = {Z_RTOL * scale:.3g}); score {p:.6f}; top-5 tails "
          f"{[name for name, _ in top]}")
    check(bool(torch.isfinite(scorer.z).all()), "Lightning import: z not "
                                                "finite")
    check(err <= Z_RTOL * scale, "Lightning import: z differs from the "
                                 "native checkpoint's")
    check(0.0 < p < 1.0 and len(top) == 5
          and all(name.startswith("gene_") for name, _ in top),
          f"Lightning import: answers {p}, {top}")
    for name, count in launches.items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + count
    del scorer, native_module
    return launches


def dpi_workspace(tmp: str) -> str:
    root = os.path.dirname(os.path.abspath(__file__))
    ws = tempfile.mkdtemp(dir=tmp)
    os.symlink(os.path.join(root, "configs"), os.path.join(ws, "configs"))
    return ws


def start_train_dpi(ws: str, label: str, extra, env=None, **variables):
    """scripts/dpi.sh's ``train_dpi`` (``variables`` set in the script),
    its 100 epochs cut to P12_EPOCHS of P12_STEPS steps, validated every
    epoch, in ``ws``."""
    args = script_args("dpi.sh", **variables) + [
        f"epochs={P12_EPOCHS}", "val_every_epoch=1", f"steps={P12_STEPS}",
        f"ckpt_dir={ws}/ckpt_{label}", *extra]
    return start_entry(ws, "train_dpi", args, f"{ws}/log_{label}", env=env)


def finish_train_dpi(proc, what: str, t0: float, epochs=P12_EPOCHS):
    """Wait for a train_dpi run and check it: the reference's flow (top 3
    and last, the test on the best), ``epochs`` validations, finite
    ``test_*`` metrics with the DPI relation's precision; returns (the
    tested checkpoint, its output)."""
    out, errs = proc.communicate(timeout=900)
    print(f"train_dpi {what} ({time.perf_counter() - t0:.1f} s, rc "
          f"{proc.returncode}):", out.strip().replace("\n", " | "))
    check(proc.returncode == 0, f"train_dpi {what} failed: {errs[-3000:]}")
    check(out.startswith("train_dpi: "), f"train_dpi {what}: {out[:200]}")
    proc.errs = errs
    ckpt = os.path.normpath(os.path.join(
        proc.cwd, out.split("checkpoint: ")[-1].strip()))
    check_reference_flow(proc, ckpt, f"train_dpi {what}", 3, True, "dpi")
    check(out.count("] val_loss=") == epochs,
          f"train_dpi {what}: {out.count('] val_loss=')} validations")
    metrics = printed_metrics(out, "test metrics:")
    check(all(np.isfinite(v) for v in metrics.values())
          and 0.0 <= metrics["test_AUROC"] <= 1.0
          and "drug_protein_interaction_pre" in metrics,
          f"train_dpi {what}: test metrics {metrics}")
    return ckpt, out


def l2_only_rows(before: np.ndarray, ckpt: str, hp: dict, what: str):
    """A warm start pins every slot to DRUG_PROTEIN: only the L2 term's
    gradient (2·1e-2·p / numel, the sign of p) reaches the other relation
    rows, so Adam moves each of their entries towards 0 (those too small
    to cross it in the run's steps are left out); row DRUG_PROTEIN
    learns."""
    after = load_checkpoint(ckpt)["params"]["model"]["decoder"]["rel_emb"]
    delta = after - before
    others = np.arange(len(before)) != DRUG_PROTEIN
    steps = P12_EPOCHS * P12_STEPS
    big = np.abs(before) > 10 * hp["learning_rate"] * steps
    sel = others[:, None] & big
    toward = bool(np.all(delta[sel] * before[sel] <= 0))
    moved = float(np.abs(delta[DRUG_PROTEIN]).max())
    rest = float(np.abs(delta[others]).max())
    print(f"train_dpi {what}: relation rows other than {DRUG_PROTEIN}: "
          f"{int(sel.sum())} entries checked, all moved towards 0 (the L2 "
          f"term alone): {toward}; max |change| {rest:.3g}; row "
          f"{DRUG_PROTEIN} max |change| {moved:.3g}")
    check(toward and sel.any(), f"train_dpi {what}: a relation row other "
                                f"than {DRUG_PROTEIN} moved with the data")
    check(moved > 0.0, f"train_dpi {what}: row {DRUG_PROTEIN} did not train")


def dpi_csv(tmp: str):
    """Phase 12f's csv: synthetic_dpi at DPI_CSV_SIZES with a ``source``
    column, DPI_CSV_NA's rows given NA tokens; the DPI graph read through
    BIOMEDKG_DPI_CSV dropped exactly those rows. Returns (its path, the
    graph's node count)."""
    columns = synthetic_dpi(**DPI_CSV_SIZES)
    rows = len(columns["x_type"])
    columns["source"] = np.full(rows, "DrugBank")
    rng = np.random.default_rng(SEED)
    na_rows = np.sort(rng.choice(rows, len(DPI_CSV_NA), replace=False))
    clean = np.setdiff1d(np.arange(rows), na_rows)
    kept = {c: v[clean] for c, v in columns.items() if c in COLUMNS}
    for row, (col, token) in zip(na_rows, DPI_CSV_NA):
        columns[col] = columns[col].astype(object)
        columns[col][row] = token
    path = os.path.join(tmp, "dpi_benchmark.csv")
    write_csv_columns(path, {c: np.asarray(v) for c, v in columns.items()})
    os.environ["BIOMEDKG_DPI_CSV"] = path
    try:
        t0 = time.perf_counter()
        dpi = DPI(data_dir=os.path.join(tmp, "absent.csv"))
        build_s = time.perf_counter() - t0
    finally:
        os.environ.pop("BIOMEDKG_DPI_CSV")
    want = TripletGraph(kept)
    same = (dpi.node_list == want.node_list
            and np.array_equal(dpi.graph.edge_index, want.graph.edge_index)
            and np.array_equal(dpi.graph.edge_type, want.graph.edge_type))
    print(f"BIOMEDKG_DPI_CSV: {rows} rows ({DPI_CSV_SIZES['num_drug']} "
          f"drugs x {DPI_CSV_SIZES['num_gene']} genes drawn), NA tokens on "
          f"rows {na_rows.tolist()}; the DPI graph ({dpi.graph.num_nodes} "
          f"nodes, {dpi.graph.num_edges} edges) built in {build_s:.2f} s "
          f"dropped rows {dpi.dropped_rows.tolist()}, equal to the graph "
          f"of the other rows: {same}")
    check(np.array_equal(dpi.dropped_rows, na_rows) and same,
          "BIOMEDKG_DPI_CSV: the DPI graph did not drop exactly the NA rows")
    return path, dpi.graph.num_nodes


def dpi_config(ws: str):
    """configs/dpi.yaml composed with scripts/dpi.sh's arguments, on the
    card, in ``ws``."""
    with working_dir(ws):
        return load_config(CONFIG_DIR, "dpi", cli_overrides(
            script_args("dpi.sh") + ["device=cuda"]))


def pinned_rel_grad_zero(z, negatives, rel_emb, ds, fix: int, what: str):
    """The negscore owner backward with every slot on relation ``fix``:
    the relation gradient's other rows exactly 0, in bf16 and float32."""
    bwd = negscore.KERNELS["distmult_neg_scores_bwd"]
    ns, nd, rel = negatives
    for dtype in (torch.bfloat16, torch.float32):
        re = negscore.relation_table("distmult", rel_emb, dtype).contiguous()
        _, dre = bwd(z.to(dtype).contiguous(), ns, nd, rel, re, ds)
        torch.cuda.synchronize()
        others = torch.arange(dre.shape[0], device=dre.device) != fix
        rest = float(dre[others].abs().max()) if others.any() else 0.0
        print(f"{what} {str(dtype)[6:]}: d(rel_emb) rows other than {fix} "
              f"max |value| {rest} (must be 0), row {fix} max "
              f"{float(dre[fix].abs().max()):.4g}")
        check(rest == 0.0, f"{what} {dtype}: d(rel) rows other than {fix} "
                           "are not 0")


def dpi_timed_steps(hp, dev, table, batches, gen, fix, what, relmm_n=(0, 0),
                    segsum_n=SEGSUM_PER_STEP):
    """P12_STEPS_TIMED steps of a DPI module (K = 1), launches counted."""
    warm, steps = P12_STEPS_TIMED
    module = KGEModule(**hp).to(dev)
    module.neg_ratio = 1
    module.fix_edge_id = fix
    module.edge_layout = module.default_layout
    module.feature_table = table
    module.configure_optimizers(num_training_steps=100)
    state = module.init_state(torch.Generator().manual_seed(SEED))
    state, _ = module.train_steps(state, batches[:warm], gen)
    torch.cuda.synchronize()
    _, launches, ms = timed_steps(
        module, state, batches[warm:warm + steps], gen, what,
        work=lambda b: (sum(int(x.edge_mask.sum()) for x in b) * 2,
                        "triplets/s (real edges x (1 + K))"))
    check(launches == step_launches(hp, steps, "distmult_neg_scores",
                                    module.compute_dtype, segsum_n, relmm_n),
          f"{what}: launches {launches}")
    return launches, ms


def dpi_shapes_main(dev, ws: str) -> int:
    """Phase 12e in a process of its own, so that its SAINT batches
    (scripts/dpi.sh: 64 roots over the DPI graph, K = 1) are the first the
    negscore kernels and the bucket build see: the DPI step from scratch
    (R = 1) and warm-started (phase 2's R = 8 model, fix_edge_id 1),
    bf16 and float32, kernels against plain versions; the negscore pair
    (with d(rel)'s other rows exactly 0 when pinned), the bucket build and
    the segsum (its count table at R = 1 and pinned) at that shape, timed;
    an RGAT warm start's step (relmm 8 + 6, every block on relation 1) and
    relmm at its shape; timed steps with their launches. Prints
    DPI_SHAPES_RESULT and a JSON object: the launches and the records."""
    for lib in (segsum.LIBRARY, negscore.LIBRARY, relmm.LIBRARY):
        lib.lib()
    check(native.get_lib() is not None, "the host sampler did not build")
    cfg = dpi_config(ws)
    with working_dir(ws):
        dm = train_kge.data_module(cfg)
    dm.device_features = True
    dm.edge_layout = "dst"
    loader = dm.train_dataloader(loader_type="saint")
    warm, steps = P12_STEPS_TIMED
    batches = [batch_to_device(loader.sample()[0], dev)
               for _ in range(warm + steps)]
    batch = batches[0]
    n = batch.node_mask.shape[0]
    table = torch.as_tensor(dm.graph.x, dtype=torch.float32).to(dev)
    scratch = kge_sh_hparams(cfg, dm.data.num_edge_types)
    pinned = dict(HPARAMS, neg_ratio=1)
    print(f"scripts/dpi.sh in-process: DPI graph {dm.graph.num_nodes} nodes, "
          f"{dm.graph.num_edges} edges, {dm.data.num_edge_types} relation; "
          f"SAINT envelope {loader.node_budget} node x {loader.edge_budget} "
          f"edge slots (batch {cfg.data.batch_size}, K = {cfg.neg_ratio}); "
          f"features {tuple(table.shape)}")
    check(cfg.neg_ratio == 1 and cfg.data.batch_size == 64
          and dm.data.num_edge_types == 1,
          f"not scripts/dpi.sh's shapes: K = {cfg.neg_ratio}, batch "
          f"{cfg.data.batch_size}, {dm.data.num_edge_types} relations")
    check(all(k.launches == 0 for k in negscore.KERNELS.values())
          and negscore.BUCKETS.launches == 0,
          "a negscore kernel ran before scripts/dpi.sh's shapes")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    records, total = {}, None
    for label, hp, fix in (("r1", scratch, None),
                           ("pinned", pinned, DRUG_PROTEIN)):
        module = KGEModule(**hp)
        module.init(torch.Generator().manual_seed(SEED))
        sd = {k: t.detach().clone() for k, t in module.state_dict().items()}
        what = (f"DPI step from scratch (R = {hp['num_relation']})"
                if fix is None else
                f"DPI step warm-started (R = {hp['num_relation']}, "
                f"fix_edge_id {fix})")
        compare_step(sd, table, dev, batch, "distmult_neg_scores", what,
                     fix=fix, **hp)
        # the negscore pair and d(rel) at this shape, the relation column
        # as the step makes it
        module.to(dev)
        module.fix_edge_id = fix
        module.edge_layout = "dst"
        module.feature_table = table
        etype, _ = module._effective_types(batch)
        negatives = path_negatives(batch._replace(edge_type=etype), gen,
                                   False, k=1)
        z = encoded(module, batch._replace(edge_type=etype))
        ds = torch.randn(negatives[0].shape[0], generator=gen, device=dev)
        rel_emb = module.model.decoder.rel_emb.detach()
        if fix is not None:
            pinned_rel_grad_zero(z, negatives, rel_emb, ds, fix, what)
        launches, step_ms = dpi_timed_steps(
            dict(hp, compute_dtype="float32"), dev, table, batches, gen, fix,
            f"{what} float32 train step (K = 1)")
        total = launches if total is None else {
            k: total[k] + launches[k] for k in total}
        records[label] = negscore_records("distmult", False, z, negatives,
                                          rel_emb, ds, launches)
        records[label + "_step_ms"] = step_ms
        segsum_times(count_table(etype, batch.edge_mask,
                                 hp["num_relation"]),
                     batch.edge_index[1].int(), n,
                     f"DPI count table (R = {hp['num_relation']})",
                     exact=True)
        if fix is not None:
            records["buckets"] = bucket_checks(dev, negatives, n)
        del module
    dst = batch.edge_index[1].int()
    conv = torch.randn(dst.shape[0], HPARAMS["hidden_dim"], device=dev,
                       generator=gen)
    records["segsum"] = segsum_times(conv, dst, n, "DPI conv")

    # an RGAT warm start: relation-layout batches, every block on relation 1
    dm.edge_layout = "relation"
    rel_loader = dm.train_dataloader(loader_type="saint")
    rel_batches = [batch_to_device(rel_loader.sample()[0], dev)
                   for _ in range(warm + steps)]
    rgat = dict(HPARAMS, encoder_name="rgat", neg_ratio=1)
    module = KGEModule(**rgat)
    module.init(torch.Generator().manual_seed(SEED))
    sd = {k: t.detach().clone() for k, t in module.state_dict().items()}
    del module
    compare_step(sd, table, dev, rel_batches[0], "distmult_neg_scores",
                 f"DPI RGAT step warm-started (fix_edge_id {DRUG_PROTEIN})",
                 segsum_n=0, relmm_n=RELMM_PER_STEP, fix=DRUG_PROTEIN,
                 cancelling=RGAT_DPI_CANCELLING, **rgat)
    launches, _ = dpi_timed_steps(
        dict(rgat, compute_dtype="bfloat16"), dev, table, rel_batches, gen,
        DRUG_PROTEIN, "DPI RGAT bf16 train step (K = 1, pinned)",
        relmm_n=RELMM_PER_STEP, segsum_n=0)
    total = {k: total[k] + launches[k] for k in total}
    rb = rel_batches[0]
    block_rel = torch.full_like(rb.block_rel, DRUG_PROTEIN)
    msg = torch.randn(rb.edge_type.shape[0], HPARAMS["in_dim"], device=dev,
                      generator=gen).bfloat16()
    w = (0.05 * torch.randn(HPARAMS["num_relation"], HPARAMS["in_dim"],
                            HPARAMS["num_heads"] * HPARAMS["hidden_dim"],
                            device=dev, generator=gen)).bfloat16()
    errs = {}
    picked, g = relmm_check("DPI pinned (every block on relation "
                            f"{DRUG_PROTEIN})", msg, w, block_rel, gen, errs)
    check(picked == [relmm.FAST[torch.bfloat16]] * 2,
          f"relmm at the DPI shape picked {picked}")
    t = relmm_times(msg, w, block_rel, g)
    fast = relmm.FAST[torch.bfloat16]
    records["relmm"] = {d: {"ms": t[d], "plain_ms": t[f"plain_{d}"],
                            "bound_ms": t[f"bound_{d}"][0],
                            "max_abs_err": errs[(fast, d == "bwd")]}
                        for d in ("fwd", "bwd")}
    print(f"relmm at the DPI RGAT shape ({tuple(msg.shape)} bf16 -> "
          f"{w.shape[2]}, {block_rel.shape[0]} blocks on relation "
          f"{DRUG_PROTEIN}): {fast} forward {t['fwd']:.4f} ms, d_msg "
          f"{t['bwd']:.4f} ms (general {t['general_fwd']:.4f} / "
          f"{t['general_bwd']:.4f}), plain {t['plain_fwd']:.4f} / "
          f"{t['plain_bwd']:.4f}, bound {t['bound_fwd'][0]:.4f} / "
          f"{t['bound_bwd'][0]:.4f}")
    print(DPI_SHAPES_RESULT + json.dumps({"launches": total,
                                          "records": records}))
    return 0


def dpi_shapes(ws: str):
    """``python3 chip_smoke.py DPI_SHAPES ws`` started (dpi_shapes_main)."""
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), DPI_SHAPES, ws],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_dpi_shapes(proc, t0: float):
    """(the launches, the records) of a dpi_shapes run, its launches added
    into PATH_LAUNCHES."""
    out, errs = proc.communicate(timeout=900)
    body = "\n".join(line for line in out.strip().splitlines()
                     if not line.startswith(DPI_SHAPES_RESULT))
    print(f"scripts/dpi.sh's shapes in their own process "
          f"({time.perf_counter() - t0:.1f} s, rc {proc.returncode}):\n"
          f"{body}")
    check(proc.returncode == 0, f"scripts/dpi.sh's shapes failed: "
                                f"{errs[-3000:]}")
    result = json.loads(next(line for line in out.splitlines()
                             if line.startswith(DPI_SHAPES_RESULT))
                        [len(DPI_SHAPES_RESULT):])
    for name, count in result["launches"].items():
        PATH_LAUNCHES[name] = PATH_LAUNCHES.get(name, 0) + count
    return result["launches"], result["records"]


def dpi_phase(dm, dev, tmp):
    """Phase 12; returns every kernel's launches over its counted paths
    and the DPI-shape records."""
    t_phase = time.perf_counter()
    ws = dpi_workspace(tmp)
    # phase 2's model, saved natively and as the reference's Lightning file
    module = KGEModule(**HPARAMS)
    module.init(torch.Generator().manual_seed(SEED))
    native_ckpt = os.path.join(ws, "kge.ckpt")
    save_checkpoint(native_ckpt, "kge", module.hparams,
                    to_jax_params(module.model))
    lightning = os.path.join(ws, "reference.ckpt")
    write_lightning_kge(lightning, module)
    rel_before = module.model.decoder.rel_emb.detach().numpy().copy()
    print(f"scripts/dpi.sh: {' '.join(script_args('dpi.sh'))}")
    csv_path, csv_nodes = dpi_csv(tmp)

    # (c) and (f) started together, (e) beside them
    t0 = time.perf_counter()
    runs = {
        "from scratch": start_train_dpi(ws, "scratch", []),
        "warm-started from the Lightning .ckpt": start_train_dpi(
            ws, "lightning", ["data.unseen_node_ratio=0.1",
                              "data.unseen_node_types=[drug]"],
            PRETRAINED_PATH=lightning),
        "warm-started from the native .ckpt": start_train_dpi(
            ws, "native", [], PRETRAINED_PATH=native_ckpt),
        "on BIOMEDKG_DPI_CSV": start_train_dpi(
            ws, "csv", ["epochs=1"],
            env={"BIOMEDKG_DPI_CSV": csv_path})}
    shapes = dpi_shapes(ws)
    # (a) and (b) in this process meanwhile
    kg_csv_onramp(tmp, dm)
    launches = lightning_import(dm, dev, native_ckpt, lightning)

    ckpts = {}
    for what, proc in runs.items():
        ckpt, out = finish_train_dpi(
            proc, what, t0, epochs=1 if what.startswith("on ") else
            P12_EPOCHS)
        ckpts[what] = ckpt
        warm = what.startswith("warm")
        check(("warm-started from" in out and "(fix_edge_id 1)" in out)
              == warm, f"train_dpi {what}: warm start not as asked")
        if warm:
            l2_only_rows(rel_before, ckpt, HPARAMS, what)
        if "Lightning" in what:
            check_unseen(printed_metrics(
                out, "unseen-node (inductive) metrics:"), f"train_dpi {what}")
        if what.startswith("on "):
            check(f"train_dpi: {csv_nodes} nodes" in out
                  and "DPI csv from BIOMEDKG_DPI_CSV" in proc.errs,
                  f"train_dpi {what}: not on the csv's graph")
        elif not warm:
            check("falling back to the synthetic DTI graph" in proc.errs,
                  f"train_dpi {what}: not on synthetic_dpi(seed=43)")

    # (d) scripts/test_dpi.sh on the from-scratch run's best checkpoint
    t1 = time.perf_counter()
    args = script_args("test_dpi.sh",
                       PRETRAINED_PATH=ckpts["from scratch"]) + [
        "filter_neg=true", f"steps={10 * P12_STEPS}"]
    out = finish_entry(start_entry(ws, "test_dpi", args, f"{ws}/log_test"),
                       "test_dpi scripts/test_dpi.sh", t1)
    metrics = printed_metrics(out, "test metrics:")
    print(f"test_dpi: {json.dumps(metrics)}")
    check("Neg Ratio: 3" in out and all(np.isfinite(v)
                                        for v in metrics.values())
          and 0.0 <= metrics["test_AUROC"] <= 1.0,
          f"test_dpi: metrics {metrics}")

    shape_launches, records = finish_dpi_shapes(shapes, t0)
    total = {k: launches.get(k, 0) + shape_launches.get(k, 0)
             for k in set(launches) | set(shape_launches)}
    print(f"phase 12: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{({k: v for k, v in total.items() if v})}")
    return total, records



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    check_full_fp32()
    dev = torch.device("cuda")
    if sys.argv[1:] == [TRAINER_VS_SERIAL]:
        return trainer_vs_serial_main(dev)
    if sys.argv[1:2] == [KGE_SH_SHAPES]:
        return kge_sh_shapes_main(dev, sys.argv[2])
    if sys.argv[1:2] == [DPI_SHAPES]:
        return dpi_shapes_main(dev, sys.argv[2])
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
        segsum.KERNEL.reset()
        t0 = time.perf_counter()
        scorer = KGEScorer(ckpt, dm, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        lat = serve_requests(scorer, np.random.default_rng(SEED))
        torch.cuda.synchronize()
        launches = {"sorted_segment_sum": segsum.KERNEL.launches,
                    **{relmm_key(segsum.KERNEL, inst): c for inst, c
                       in segsum.KERNEL.by_instance.items()}}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        g = dm.graph
        print(f"main path: graph {g.num_nodes} nodes, {g.num_edges} edges, "
              f"{g.num_relations} relations; KGEScorer init {t_init:.2f} s "
              f"(data build + encode); requests {json.dumps(lat)}; "
              f"peak device memory {peak_gb:.2f} GB; launches {launches}")
        check(g.num_nodes > 50_000 and g.num_edges > 1_000_000,
              "not the PrimeKG++-scale graph")
        check(launches["sorted_segment_sum"] == SEGSUM_PER_ENCODE
              and launches[relmm_key(segsum.KERNEL, "packed")]
              == SEGSUM_PER_ENCODE,
              f"segsum launches on the main path: {launches}")

        # -- 10. filtered ranking, test_kge, the unseen-node protocol -----
        # (run here, on phase 2's checkpoint, before any torch.profiler
        # session: one slows every later host step of its process)
        ranked = ranking_phase(scorer.dm, dev, tmp, ckpt)

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
    counts = count_table(etype, emask, HPARAMS["num_relation"])
    perm = torch.randperm(m, device=dev, generator=cuda_gen)
    pads = dst.clone()
    pads[torch.randperm(m, device=dev, generator=cuda_gen)[: m // 100]] = -1
    pads[~emask] = -1
    # one hub segment over a tenth of the slots, still ascending
    hub = dst.clone()
    hub[m // 3: m // 3 + m // 10] = hub[m // 3]
    hub = torch.sort(hub).values
    cases = [
        ("conv f32", conv, dst),
        ("count table f32", counts, dst),
        ("conv bf16", conv.bfloat16(), dst),
        ("count table bf16", counts.bfloat16(), dst),
        ("conv f32 unsorted", conv[perm].contiguous(), dst[perm].contiguous()),
        ("conv f32 -1 pads", conv, pads),
        ("conv bf16 -1 pads", conv.bfloat16(), pads),
        ("conv f32 hub", conv, hub),
        ("conv bf16 hub", conv.bfloat16(), hub),
    ] + [(f"d={d} {name}", torch.randn(m, d, device=dev, generator=cuda_gen)
          .to(dtype), dst)
         for d in SEGSUM_ODD_WIDTHS
         for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))]
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
        instance = segsum.segsum_instance(
            data_t.dtype, data_t.shape[1], data_t.data_ptr(), ids.data_ptr(),
            got.data_ptr())
        print(f"segsum {name} ({instance}): data {tuple(data_t.shape)} "
              f"{str(data_t.dtype)[6:]}, {num_nodes} segments: "
              f"max_abs_err={max_err:.3g}, tol {tol:g}·Σ|x| per segment, "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"segsum kernel disagrees with its plain version ({name})")
        results[name] = max_err
    del cases
    timed = {"conv f32": segsum_times(conv, dst, num_nodes, "serving conv"),
             "count table f32": segsum_times(counts, dst, num_nodes,
                                             "serving count table",
                                             exact=True)}

    # -- 4. the encode: time, launches, kernels vs plain versions ---------
    dev_batch = batch_to_device(batch, dev)
    segsum.KERNEL.reset()
    enc_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        z = scorer.module.encode(dev_batch)
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t0) * 1e3)
    check(segsum.KERNEL.launches == 3 * SEGSUM_PER_ENCODE
          and segsum.KERNEL.by_instance["packed"] == 3 * SEGSUM_PER_ENCODE,
          f"segsum launches per encode: {segsum.KERNEL.launches / 3}, by "
          f"instance {segsum.KERNEL.by_instance}")
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
    # device-busy time of one encode, in turns with the first-design segsum
    for design in ("owner", "first", "first", "owner"):
        with first_design_segsum() if design == "first" \
                else contextlib.nullcontext():
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                scorer.module.encode(dev_batch)
                torch.cuda.synchronize()
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        print(f"encode device kernels (torch.profiler, {design}-design "
              f"segsum): {busy:.3f} ms busy; "
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
        # -- 9. held-out evaluation and the Trainer -------------------------
        torch.cuda.empty_cache()
        eval_segsum = eval_phase(scorer.dm, dev, tmp)
        # -- 11. the config layer and Stage B's multimodal remainder -------
        torch.cuda.empty_cache()
        multimodal, k1_records = multimodal_phase(scorer.dm, dev, tmp)
        # -- 12. DPI fine-tuning and the on-ramps -------------------------
        torch.cuda.empty_cache()
        dpi, dpi_records = dpi_phase(scorer.dm, dev, tmp)
    # -- 9b. the Trainer against the serial loop, in a fresh process -----
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.abspath(__file__), TRAINER_VS_SERIAL],
        capture_output=True, text=True, timeout=600)
    print(f"phase 9b in its own process ({time.perf_counter() - t0:.1f} s, "
          f"rc {run.returncode}):\n{run.stdout.strip()}")
    check(run.returncode == 0, f"phase 9b failed: {run.stderr[-3000:]}")

    k1 = {r["name"]: r for r in k1_records}
    # phase 12: every kernel of the DPI path launched in its counted runs;
    # its DPI-shape numbers as dpi_* keys (dpi_pinned_*: fix_edge_id 1)
    fast = relmm.FAST[torch.bfloat16]
    dpi_path = ["sorted_segment_sum", "distmult_neg_scores",
                "distmult_neg_scores_bwd", negscore.BUCKETS_NAME,
                relmm_key(relmm.FORWARD, fast),
                relmm_key(relmm.BACKWARD, fast)]
    check(all(dpi.get(name, 0) > 0 for name in dpi_path),
          f"phase 12: a DPI-path kernel was not launched: {dpi}")
    keys = ("ms", "plain_ms", "bound_ms", "max_abs_err")
    dpi_keys = {r["name"]: {f"dpi_{k}": r[k] for k in keys}
                for r in dpi_records["r1"]}
    for r in dpi_records["pinned"]:
        dpi_keys[r["name"]].update({f"dpi_pinned_{k}": r[k] for k in keys})
    dpi_keys[negscore.BUCKETS_NAME] = {
        f"dpi_{k}": dpi_records["buckets"][k] for k in keys}
    for d, kernel in (("fwd", relmm.FORWARD), ("bwd", relmm.BACKWARD)):
        dpi_keys[relmm_key(kernel, fast)] = {
            f"dpi_{k}": dpi_records["relmm"][d][k] for k in keys}
    for record in neg_records:
        if record["name"] == negscore.BUCKETS_NAME:
            record["launches"] = PATH_LAUNCHES[negscore.BUCKETS_NAME]
        else:                            # phase 10's (d) and (e), phase 11
            record["launches"] += (ranked[record["name"]]
                                   + multimodal[record["name"]]
                                   + dpi.get(record["name"], 0))
        if record["name"] in k1:         # phase 11: K = 1 at its shapes
            record.update({f"k1_{key}": k1[record["name"]][key] for key in
                           ("ms", "plain_ms", "bound_ms", "max_abs_err")})
        record.update(dpi_keys.get(record["name"], {}))
    for record in relmm_records:
        record["launches"] += dpi.get(record["name"], 0)
        record.update(dpi_keys.get(record["name"], {}))
    for record in flash_records:         # phase 11's GRACE + ReDAF steps
        name = record["name"]
        record["launches"] += multimodal[
            name if "[" in name else relmm_key(
                flashnce.KERNELS[name], flashnce.PATH[torch.float32])]
    serving = timed["conv f32"]
    print(json.dumps({"kernels": [{
        "name": "sorted_segment_sum", "route": "cuda",
        "source": "biomedkg_tpu_torch/csrc/segsum.cu",
        "replaces": "biomedkg_tpu/ops/pallas/segsum.py:74",
        "design": "owner", "instance": "packed",
        "launches": launches["sorted_segment_sum"] + train_segsum
        + gcl_segsum + eval_segsum + ranked["sorted_segment_sum"]
        + multimodal["sorted_segment_sum"] + dpi["sorted_segment_sum"],
        "max_abs_err": max(results.values()),
        "ms": serving["ms"], "first_design_ms": serving["first_ms"],
        "plain_ms": serving["plain_ms"], "bound_ms": serving["bound_ms"],
        "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
        **{f"dpi_{k}": dpi_records["segsum"][k] for k in keys}}]
        + neg_records
        + relmm_records + flash_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
