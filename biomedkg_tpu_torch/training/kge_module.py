"""KGE module (counterpart of biomedkg_tpu/training/kge_module.py): the
hyper-parameters, the GAE model, the training loss and the deterministic
full-graph encode.

Training (``_forward_loss`` with ``training=True``, stepped by
training/stepping.py): encode → positive scores of the decoder (DistMult,
ComplEx, TransE or RotatE) → K = neg_ratio negatives per edge → masked BCE
+ 1e-2·L2, as the reference computes it:

* "sorted" negatives (the default): sources are a sorted uniform draw over
  the batch's real nodes, destinations iid uniform, and slot (k, s) pairs
  with edge σ((s + off_k) mod E) for fresh offsets ``off`` and the fixed
  stride-transpose σ of ``_mix_factor``; scored by the decoder's
  ``score_neg_sorted`` (the CUDA negscore kernels on the card);
* "sorted2" negatives: the same sources, with each chunk of ``BLOCK``
  destinations drawn iid inside a randomly placed narrow band; scored by
  the dual-sorted kernels (``score_neg_sorted(..., dst_sorted=True)``);
* "iid" negatives (and every eval batch): (K, E) iid endpoint sets.

Held-out evaluation (``eval_step``, stepping.py) scores iid negatives, as
the reference's does, and ``eval_impl`` picks how an epoch's metrics are
formed: "histogram" (the default) reduces each batch on the device to a
(2, 32,768) score histogram, the exact (tp, fp, fn) at logit 0 and the
per-relation counts (``_reduce_eval_aux``), summed over the epoch in
float64; "exact" keeps the predictions (``BootstrappedBinaryMetrics``).
``edge_mapping`` names the relations of the per-relation precision.

``compute_dtype`` "bfloat16" runs the encoder in bf16 with float32 master
weights; the positive path and the L2 term read float32 z, the negative
path z rounded to bf16, as in the reference. Random numbers come from a
``torch.Generator`` on the module's device; ``negatives``,
``dropout_masks``, ``cold_keep`` and ``filter_draws`` let the tests pass in
the reference's draws.

``cold_start_dropout`` p > 0 (the unseen-node protocol,
data/inductive.py): each training step draws a per-node keep mask
(uniform ≥ p) and the encoder sees only the edges whose endpoints are both
kept, through the edge mask it already takes (the CUDA segsum and relmm
paths included), while every edge is still scored. ``filter_negatives``
(PyG ``negative_sampling``'s exclusion): iid negatives that hit a real
batch edge are redrawn, 3 rounds, found by a search over the batch's
sorted (src·N_pad + dst) keys; it makes training take the iid path, as in
the reference. ``fix_edge_id`` (the DPI transfer, train_dpi.py) pins every
edge's relation to one id wherever the batch's relations are read: the
encoder's count table, convs and RGAT's ``block_rel`` for the grouped GEMM,
the positive decode, the negatives' relation column, the eval step's
per-relation counts and ``encode`` (``_effective_types``). Encoding runs
in float32 whatever ``compute_dtype`` training used, as the reference's
``encode`` does.

``dst_bwd`` "perm" or "agg" (the RGCN's opt-in variants,
models/encoders.py) hands the encoder the dst batch's src-sorted copy
(``src_edges``, with ``fix_edge_id``'s relation and the cold-start keep
mask applied as in the primary order, and ``src_pos``); with "perm" the
positive head gather's backward also runs on the segsum. ``remat``
recomputes each RGCN conv in the backward.

Node features may be (N, d) (random), (N, 2, d) (``node_init_method``
"lm": the LM cache's two modalities) or (N, 1, d) ("gcl": the GCL cache's
rows). ``fusion_fn`` makes them (N, d) in float32 before the encoder's
cast, in the train step, the eval step and ``encode`` alike (serving,
ranking and the unseen-node eval read features only through ``encode``):
with ``node_init_method="lm"`` and ``fuse_method`` attention or redaf the
module's ``fusion`` (models/fusion.py, trained with the model, in the
checkpoint's ``fusion`` subtree), otherwise the mean over the modality
axis. ReDAF's dropout keep mask is the ``fusion_keep`` draw.

``_forward_loss(..., tp=...)`` is the same loss in a dp × tp step
(parallel/dp.py): the module's parameters are then the tp rank's columns
(parallel/sharding.py), the encoder and the decoder compute their columns
and sum their partial scores over tp (models/encoders.py,
models/decoders.py), and the L2 terms are sums over tp. Every other step
(the draws, the fuser, the cold-start mask, the filter, ``fix_edge_id``,
the ``dst_bwd`` copy) is the single-device path's, alike on every rank.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional

import torch
from torch import nn

from ..device import resolve_device
from ..interop.jax_params import load_jax_params
from ..models.factory import FusionFactory, KGEModelFactory
from ..nn import sigmoid_binary_cross_entropy
from ..ops.negscore import BLOCK
from ..sampling.batch import GraphBatch
from .checkpoint import load_checkpoint
from .metrics import (BootstrappedBinaryMetrics, EdgeWisePrecision,
                      HistogramBinaryMetrics)
from .optim import make_optimizer
from .stepping import StepsMixin, TrainState, mean_loss  # noqa: F401


def _mix_factor(e: int, bound: Optional[int] = None) -> int:
    """Largest divisor of ``e`` that is ≤ bound (default √e): the stride of
    the transpose permutation that decorrelates relation runs from the
    sorted source sample."""
    if bound is None:
        bound = int(math.isqrt(e))
    best = 1
    for d in range(1, bound + 1):
        if e % d == 0:
            best = d
    if best == 1 and e > 4:
        warnings.warn(
            f"edge budget {e} has no divisor in [2, {bound}]: the "
            "stride-transpose negative pairing degrades to identity, "
            "re-coupling relation runs with narrow source bands (slower "
            "convergence). Pad the edge budget to a composite size.",
            stacklevel=2)
    return best


def _sorted_uniform_sample(generator: torch.Generator, ke: int,
                           num_real_nodes: torch.Tensor) -> torch.Tensor:
    """(ke,) int32 ascending uniform draw over [0, num_real_nodes) by the
    exponential-spacing construction (no sort)."""
    u = torch.rand(ke + 1, generator=generator, device=generator.device)
    cum = torch.cumsum(-torch.log(u.clamp_(min=1e-12)), 0)
    # clamp: the last ratios can round to exactly 1.0 and would emit the
    # pad row num_real_nodes
    ids = (cum[:-1] / cum[-1] * num_real_nodes).to(torch.int32)
    return torch.minimum(ids, (num_real_nodes - 1).to(torch.int32))


def sample_negatives_sorted(generator: torch.Generator, ratio: int,
                            num_edges: int, num_real_nodes: torch.Tensor,
                            dual: bool = False):
    """Stratified-sorted negatives: (neg_src ascending (K·E,) int32,
    neg_dst (K·E,) int32, off (K,) int64). Slot (k, e) pairs with edge
    σ((e + off[k]) mod E) (``rolled_index``), so every slot's source
    marginal is exactly uniform.

    ``dual=False`` ("sorted"): neg_dst iid uniform. ``dual=True``
    ("sorted2"): slot j of chunk c of ``BLOCK`` slots gets
    min(floor(N·frac(δ_c + U_{c,j}/nc)), N − 1), with nc = K·E / BLOCK
    chunks when BLOCK divides K·E and one chunk (iid over the whole range)
    otherwise: iid draws inside a band of N/nc ids at a uniform random
    place, so every slot's marginal stays uniform and independent of its
    source."""
    ke = ratio * num_edges
    neg_src = _sorted_uniform_sample(generator, ke, num_real_nodes)
    if dual:
        nc = ke // BLOCK if ke % BLOCK == 0 else 1
        u = torch.rand(nc, ke // nc, generator=generator,
                       device=generator.device)
        delta = torch.rand(nc, 1, generator=generator,
                           device=generator.device)
        v = torch.remainder(delta + u / nc, 1.0)
        neg_dst = torch.minimum((v * num_real_nodes).to(torch.int32),
                                (num_real_nodes - 1).to(torch.int32))
        neg_dst = neg_dst.reshape(-1)
    else:
        neg_dst = (torch.rand(ke, generator=generator,
                              device=generator.device)
                   * num_real_nodes).to(torch.int32)
    off = torch.randint(0, num_edges, (ratio,), generator=generator,
                        device=generator.device)
    return neg_src, neg_dst, off


def rolled_index(off: torch.Tensor, num_edges: int,
                 a_dim: int) -> torch.Tensor:
    """(K·E,) batch-edge index of each negative slot: slot (k, j) takes
    edge (off[k] + (j mod a)·(E/a) + j div a) mod E, the reference's
    cyclic shift followed by an (a, E/a) transpose."""
    j = torch.arange(num_edges, device=off.device)
    perm = (j % a_dim) * (num_edges // a_dim) + j // a_dim
    return ((perm[None, :] + off[:, None]) % num_edges).reshape(-1)


def _parse_neg_ratio(neg_ratio) -> Optional[int]:
    """The reference's ``neg_ratio: none`` YAML-string quirk."""
    if neg_ratio is None:
        return None
    if isinstance(neg_ratio, str):
        return None if neg_ratio.lower() in ("none", "null", "") \
            else int(neg_ratio)
    return int(neg_ratio) or None


class KGEModule(StepsMixin, nn.Module):
    kind = "kge"

    def __init__(self, encoder_name: str, decoder_name: str, in_dim: int,
                 hidden_dim: int, out_dim: int, num_hidden_layers: int,
                 num_relation: int, num_heads: int, scheduler_type: str,
                 learning_rate: float, warm_up_ratio: float,
                 fuse_method: str, neg_ratio, node_init_method: str,
                 seed: int = 42, compute_dtype: str = "float32",
                 remat: bool = False, neg_sampler: str = "sorted",
                 cold_start_dropout: float = 0.0):
        super().__init__()
        if neg_sampler not in ("sorted", "sorted2", "iid"):
            raise ValueError(f"unknown neg_sampler {neg_sampler!r}")
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.hparams = dict(
            encoder_name=encoder_name, decoder_name=decoder_name,
            in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim,
            num_hidden_layers=num_hidden_layers, num_relation=num_relation,
            num_heads=num_heads, scheduler_type=scheduler_type,
            learning_rate=learning_rate, warm_up_ratio=warm_up_ratio,
            fuse_method=fuse_method, neg_ratio=neg_ratio,
            node_init_method=node_init_method, seed=seed,
            compute_dtype=compute_dtype, remat=remat,
            neg_sampler=neg_sampler, cold_start_dropout=cold_start_dropout)
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)
        self.neg_ratio = _parse_neg_ratio(neg_ratio)
        self.neg_sampler = neg_sampler
        self.cold_start_dropout = float(cold_start_dropout or 0.0)
        self.seed = seed
        self.model = KGEModelFactory.get_model(
            encoder_name=encoder_name, decoder_name=decoder_name,
            in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim,
            num_hidden_layers=num_hidden_layers, num_relation=num_relation,
            num_heads=num_heads)
        if hasattr(self.model.encoder, "remat"):
            self.model.encoder.remat = bool(remat)
        # the reference fuses LM features only
        self.fusion = (FusionFactory.create_fuser(method=fuse_method,
                                                  embed_dim=in_dim)
                       if node_init_method == "lm" else None)
        self.valid_metrics = BootstrappedBinaryMetrics(prefix="val_")
        self.test_metrics = BootstrappedBinaryMetrics(prefix="test_")
        self.edge_mapping = {}
        self.eval_impl = "histogram"
        self._filter_negatives = False
        self._fix_edge_id: Optional[int] = None

    @property
    def eval_impl(self) -> str:
        return self._eval_impl

    @eval_impl.setter
    def eval_impl(self, value: str):
        """"histogram" (each eval batch reduced on the device) or "exact"
        (the predictions kept for the exact bootstrap)."""
        if value not in ("histogram", "exact"):
            raise ValueError(f"unknown eval_impl {value!r}")
        self._eval_impl = value

    @property
    def edge_mapping(self) -> Dict[int, str]:
        return self._edge_index_map

    @edge_mapping.setter
    def edge_mapping(self, mapping: Dict[int, str]):
        """Relation id → name (the data module's ``edge_map_index``): one
        ``<name>_pre`` metric each."""
        self._edge_index_map = mapping
        self.edge_wise_pre_valid = EdgeWisePrecision(class_mapping=mapping)
        self.edge_wise_pre_test = EdgeWisePrecision(class_mapping=mapping)

    def init(self, generator: torch.Generator):
        """Fresh weights from ``generator`` (reference init rules)."""
        self.model.init(generator)
        if self.fusion is not None:
            self.fusion.init(generator)

    def configure_optimizers(self, num_training_steps: int,
                             grad_clip: float = 1.0):
        hp = self.hparams
        self.tx = make_optimizer(hp["learning_rate"], hp["scheduler_type"],
                                 num_training_steps, hp["warm_up_ratio"],
                                 grad_clip)

    @property
    def default_layout(self) -> str:
        """The batch layout the reference trains and serves the encoder in
        (train_kge.py): "dst" for RGCN, "relation" otherwise."""
        return "dst" if self.hparams["encoder_name"] == "rgcn" else "relation"

    @property
    def edge_layout(self) -> str:
        return self.model.encoder.edge_layout

    @edge_layout.setter
    def edge_layout(self, value: str):
        """"relation" or "dst"; must match the batches' layout (RGAT refuses
        "dst")."""
        if value not in ("relation", "dst"):
            raise ValueError(f"unknown edge_layout {value!r}")
        self.model.encoder.edge_layout = value

    @property
    def dst_bwd(self) -> str:
        return getattr(self.model.encoder, "dst_bwd", "scatter")

    @dst_bwd.setter
    def dst_bwd(self, value: str):
        """Where the dst layout's gradients are summed (the RGCN's opt-in
        variants, models/encoders.py): "scatter" (the default), "perm"
        or "agg". An encoder without them (RGAT) takes only "scatter"."""
        if value not in ("scatter", "perm", "agg"):
            raise ValueError(f"unknown dst_bwd {value!r}")
        supported = hasattr(self.model.encoder, "dst_bwd")
        if value != "scatter" and not supported:
            raise ValueError(
                f"{type(self.model.encoder).__name__} has no dst-layout "
                f"backward variants (dst_bwd must stay 'scatter')")
        if supported:
            self.model.encoder.dst_bwd = value

    @property
    def filter_negatives(self) -> bool:
        return self._filter_negatives

    @filter_negatives.setter
    def filter_negatives(self, value: bool):
        """Redraw sampled negatives that hit a real batch edge (3 rounds;
        the reference's kge_module.py:306-320). Off by default."""
        self._filter_negatives = bool(value)

    @property
    def fix_edge_id(self) -> Optional[int]:
        return self._fix_edge_id

    @fix_edge_id.setter
    def fix_edge_id(self, edge_id: Optional[int]):
        """Pin every edge's relation to ``edge_id`` (None: the batch's own
        relations). An id past the model's relation table raises: JAX's
        clamped gathers would read another row."""
        if edge_id is not None:
            edge_id = int(edge_id)
            if not 0 <= edge_id < self.hparams["num_relation"]:
                raise ValueError(
                    f"fix_edge_id {edge_id} is outside the model's "
                    f"{self.hparams['num_relation']} relations")
        self._fix_edge_id = edge_id

    def _effective_types(self, batch: GraphBatch):
        """(edge types, block relations) the model reads: the batch's, or
        ``fix_edge_id`` in every slot."""
        etype, block_rel = batch.edge_type, batch.block_rel
        if self._fix_edge_id is not None:
            etype = torch.full_like(etype, self._fix_edge_id)
            block_rel = torch.full_like(block_rel, self._fix_edge_id)
        return etype, block_rel

    def _forward_loss(self, batch: GraphBatch, training: bool,
                      generator: Optional[torch.Generator] = None,
                      negatives=None, dropout_masks=None, cold_keep=None,
                      filter_draws=None, fusion_keep=None, tp=None):
        """(loss, aux) of a device batch (sampling/batch.py
        ``batch_to_device``). Draws come from ``generator`` unless passed
        in: ``negatives`` is (neg_src, neg_dst, off) for the sorted samplers
        and (neg_src, neg_dst) (K, E) for the iid one; ``dropout_masks``
        one bool keep mask per hidden layer; ``cold_keep`` the (N_pad,)
        bool cold-start keep mask; ``filter_draws`` the 3 rounds' (K, E)
        uniform pairs (src, dst) of ``filter_negatives``; ``fusion_keep``
        ReDAF's dropout keep mask. ``tp`` (a parallel/collectives.py
        ``TensorParallel``): the parameters are the tp rank's columns and
        the draws the whole-width ones every rank of the dp row takes."""
        cold = training and self.cold_start_dropout > 0.0
        use_sorted = (training and self.neg_sampler in ("sorted", "sorted2")
                      and not self._filter_negatives)
        wanted = [negatives, dropout_masks if training else 0,
                  cold_keep if cold else 0,
                  filter_draws if self._filter_negatives
                  and not use_sorted else 0]
        if generator is None and any(d is None for d in wanted):
            raise ValueError("pass a torch.Generator or the draws "
                             "(negatives, dropout_masks, cold_keep, "
                             "filter_draws)")
        x = self._batch_features(batch)
        if (self.fusion is not None and fusion_keep is None and training
                and generator is not None):
            fusion_keep = self.fusion.draw_keep(x, generator, training)
        x = self.fusion_fn(x, fusion_keep, training)
        etype, block_rel = self._effective_types(batch)
        emask = batch.edge_mask
        src, dst = batch.edge_index[0], batch.edge_index[1]
        conv_mask = emask
        if cold:
            # the encoder alone loses the edges of dropped nodes; every
            # edge is still scored below
            if cold_keep is None:
                cold_keep = torch.rand(
                    batch.node_mask.shape[0], generator=generator,
                    device=generator.device) >= self.cold_start_dropout
            conv_mask = emask & cold_keep[src] & cold_keep[dst]
        enc_kwargs = {}
        if (self.edge_layout == "dst" and self.dst_bwd != "scatter"
                and batch.src_edges.numel()):
            # the variants read the src-sorted copy, which mirrors what the
            # primary order sees: fix_edge_id's relation and the cold-start
            # keep mask
            se = batch.src_edges
            if self._fix_edge_id is not None:
                se = torch.stack([se[0], se[1],
                                  torch.full_like(se[2], self._fix_edge_id),
                                  se[3]])
            if cold:
                se = torch.stack([se[0], se[1], se[2], se[3] * (
                    cold_keep[se[0]] & cold_keep[se[1]])])
            enc_kwargs = dict(src_edges=se, src_pos=batch.src_pos)
        z = self.model.encoder(
            x, batch.edge_index, etype, conv_mask, block_rel,
            training=training, compute_dtype=self.compute_dtype,
            generator=generator, dropout_masks=dropout_masks, tp=tp,
            **enc_kwargs).float()
        decoder = self.model.decoder
        head_perm = None
        if enc_kwargs and self.dst_bwd == "perm":
            # the positive head gather's backward on the segsum too
            head_perm = (batch.src_pos,
                         enc_kwargs["src_edges"][0].to(torch.int32))
        pos_pred = decoder.score(z, src, dst, etype,
                                 tail_sorted=self.edge_layout == "dst",
                                 head_perm=head_perm, tp=tp)

        ratio = self.neg_ratio or 1
        num_edges = etype.shape[0]
        num_real_nodes = batch.node_mask.sum().clamp(min=1)
        z_neg = z.to(self.compute_dtype)
        if use_sorted:
            dual = self.neg_sampler == "sorted2"
            neg_src, neg_dst, off = (
                negatives if negatives is not None else
                sample_negatives_sorted(generator, ratio, num_edges,
                                        num_real_nodes, dual=dual))
            idx = rolled_index(off, num_edges, _mix_factor(num_edges))
            neg_pred = decoder.score_neg_sorted(
                z_neg, neg_src, neg_dst, etype[idx].to(torch.int32),
                dst_sorted=dual, tp=tp)
            neg_mask = emask[idx]
        else:
            def uniform():
                return torch.rand(ratio, num_edges, generator=generator,
                                  device=generator.device)

            if negatives is None:
                negatives = ((uniform() * num_real_nodes).long(),
                             (uniform() * num_real_nodes).long())
            neg_src, neg_dst = negatives
            if self._filter_negatives:
                neg_src, neg_dst = self._redraw_observed(
                    batch, neg_src, neg_dst, num_real_nodes,
                    filter_draws or [(uniform(), uniform())
                                     for _ in range(3)])
            neg_pred = decoder.score_neg(z_neg, neg_src, neg_dst, etype,
                                         tp).reshape(-1)
            neg_mask = emask.expand(ratio, num_edges).reshape(-1)

        pred = torch.cat([pos_pred, neg_pred])
        gt = torch.cat([torch.ones_like(pos_pred),
                        torch.zeros_like(neg_pred)])
        weights = torch.cat([emask, neg_mask]).to(pred.dtype)
        loss = self._finish_loss(z, batch.node_mask, pred, gt, weights, tp)
        aux = {"pred": pred, "gt": gt, "weights": weights,
               "pos_pred": pos_pred, "edge_type": etype, "edge_mask": emask,
               "loss": loss}
        return loss, aux

    @staticmethod
    def _redraw_observed(batch, neg_src, neg_dst, num_real_nodes, rounds):
        """``filter_negatives``: each round, the (K, E) candidates equal to
        a real batch edge take the round's fresh uniforms (the reference's
        bounded retry, 3 rounds); membership by a search over the sorted
        src·N_pad + dst keys of the real edges. The reference packs the
        keys in int32, so it refuses N_pad > 46340; that bound is kept."""
        n_pad = batch.node_mask.shape[0]
        if n_pad > 46340:
            raise ValueError(
                f"filter_negatives packs (src, dst) into int32 keys; node "
                f"budget {n_pad} overflows — shrink the batch envelope")
        src, dst = batch.edge_index[0], batch.edge_index[1]
        big = torch.iinfo(torch.int32).max
        keys = torch.sort(torch.where(batch.edge_mask, src * n_pad + dst,
                                      big)).values
        for u_src, u_dst in rounds:
            cand = neg_src * n_pad + neg_dst
            pos = torch.searchsorted(keys, cand)
            found = keys[pos.clamp(max=keys.shape[0] - 1)]
            hit = (pos < keys.shape[0]) & (found == cand)
            neg_src = torch.where(hit, (u_src * num_real_nodes).long(),
                                  neg_src)
            neg_dst = torch.where(hit, (u_dst * num_real_nodes).long(),
                                  neg_dst)
        return neg_src, neg_dst

    def _finish_loss(self, z, node_mask, pred, gt, weights, tp=None):
        """Masked BCE + 1e-2·L2 over the real nodes' z and the decoder's
        parameter (rel_emb; RotatE's (R, d/2) phases); under ``tp`` the
        squares summed over the ranks' columns."""
        bce = sigmoid_binary_cross_entropy(pred, gt, weights)
        nmask = node_mask.to(z.dtype)
        if tp is None:
            reg_z = torch.sum(z ** 2 * nmask[:, None]) / (
                nmask.sum().clamp(min=1.0) * z.shape[-1])
            reg_rel = sum(torch.mean(p ** 2)
                          for p in self.model.decoder.parameters())
        else:
            reg_z = tp.sum(torch.sum(z ** 2 * nmask[:, None])) / (
                nmask.sum().clamp(min=1.0) * z.shape[-1] * tp.size)
            reg_rel = sum(tp.sum(torch.sum(p ** 2)) / (p.numel() * tp.size)
                          for p in self.model.decoder.parameters())
        return bce + 1e-2 * (reg_z + reg_rel)

    def _reduce_eval_aux(self, aux) -> Dict[str, torch.Tensor]:
        """An eval batch's metric state, on the device: the (2, NUM_BINS)
        histogram of positives' and negatives' weights by sigmoid bin, the
        exact (tp, fp, fn) with the logit > 0 threshold, the per-relation
        count of real edges and of those whose raw score is above 0.5 (the
        reference's threshold, hazard H5), and the loss. Every count is a
        float32 sum of 0/1 weights over at most 2^24 slots, so exact."""
        nbins = HistogramBinaryMetrics.NUM_BINS
        pred, gt, w = aux["pred"], aux["gt"], aux["weights"]
        t = gt > 0.5
        zero = torch.zeros_like(w)
        bins = (torch.sigmoid(pred) * nbins).long().clamp_(max=nbins - 1)
        hist = torch.zeros(2, nbins, dtype=torch.float32, device=pred.device)
        hist[0].index_add_(0, bins, torch.where(t, w, zero))
        hist[1].index_add_(0, bins, torch.where(t, zero, w))
        pred_pos = pred > 0.0
        f1_counts = torch.stack([
            torch.where(pred_pos & t, w, zero).sum(),
            torch.where(pred_pos & ~t, w, zero).sum(),
            torch.where(~pred_pos & t, w, zero).sum()])
        num_rel = self.hparams["num_relation"]
        em = aux["edge_mask"].float()
        et = aux["edge_type"]
        above = em * (aux["pos_pred"] > 0.5)
        counts = torch.zeros(2, num_rel, dtype=torch.float32,
                             device=pred.device)
        counts[0].index_add_(0, et, em)
        counts[1].index_add_(0, et, above)
        return {"hist": hist, "f1_counts": f1_counts,
                "edge_counts": counts[0], "edge_above": counts[1],
                "loss": aux["loss"]}

    def _eval_epoch_from_states(self, outputs: List[Dict], split: str):
        """The metrics of an epoch of reduced states. The states stay on
        the device until here; each is summed over the epoch in float64
        (one copy to the host), where the float32 sum would round once a
        bin passes 2^24."""
        def total(key):
            return torch.stack([o[key] for o in outputs]).double().sum(
                0).cpu().numpy()

        hm = HistogramBinaryMetrics(prefix=f"{split}_")
        hm.merge_state(total("hist"), total("f1_counts"))
        cnt, above = total("edge_counts"), total("edge_above")
        out = hm.compute()
        for idx, name in self._edge_index_map.items():
            key = str(name) + "_pre"
            out[key] = float(above[idx] / cnt[idx]) if cnt[idx] > 0 else 0.0
        out[f"{split}_loss"] = mean_loss(outputs)
        return out

    def eval_epoch(self, outputs: List[Dict], split: str) -> Dict[str, float]:
        """The epoch's metrics from ``eval_step`` outputs (reduced states
        or raw aux dicts): ``{split}_AUROC`` / ``_AveragePrecision`` /
        ``_F1`` with their bootstrap ``_mean`` and ``_std``, one
        ``<relation>_pre`` per relation of ``edge_mapping``, and
        ``{split}_loss``."""
        if outputs and "hist" in outputs[0]:
            return self._eval_epoch_from_states(outputs, split)
        metrics = self.valid_metrics if split == "val" else self.test_metrics
        metrics.reset()
        edgewise = (self.edge_wise_pre_valid if split == "val"
                    else self.edge_wise_pre_test)
        edgewise.reset()
        for aux in outputs:
            a = {k: v.cpu().numpy() for k, v in aux.items() if k != "loss"}
            w = a["weights"] > 0
            metrics.update(a["pred"][w], a["gt"][w])
            edgewise.update(a["pos_pred"], a["edge_type"],
                            mask=a["edge_mask"])
        out = metrics.compute()
        out.update(edgewise.compute())
        out[f"{split}_loss"] = mean_loss(outputs)
        return out

    @torch.inference_mode()
    def encode(self, batch: GraphBatch) -> torch.Tensor:
        """Deterministic full forward of the fused features over a device
        batch (sampling/batch.py::batch_to_device) → (N_pad, out_dim)."""
        etype, block_rel = self._effective_types(batch)
        return self.model.encode(self.fusion_fn(self._batch_features(batch)),
                                 batch.edge_index, etype, batch.edge_mask,
                                 block_rel, training=False)


def load_kge_module(ckpt_path: str,
                    device: Optional[torch.device] = None) -> KGEModule:
    """A KGE checkpoint (written by either package) as a module on
    ``device``."""
    ckpt = load_checkpoint(ckpt_path)
    if ckpt["kind"] != "kge":
        raise ValueError(f"not a KGE checkpoint: {ckpt_path}")
    module = KGEModule(**ckpt["hparams"])
    load_jax_params(module.model, ckpt["params"], module.fusion)
    return module.to(resolve_device(device))
