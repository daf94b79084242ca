"""GCL pretraining modules (counterpart of
biomedkg_tpu/training/gcl_module.py): DGI, GRACE and GGD with their
contrastive losses, masked over pad nodes, on the GCN encoder.

* ``DGIModule``: PyGCL's SingleBranchContrast(JSD, "G2L") over (z, summary,
  zn), ``jsd_g2l_loss``;
* ``GRACEModule``: DualBranchContrast(InfoNCE(τ = 0.2), "L2L",
  intraview_negs=True) over the two projected views, cosine similarities,
  both directions, ``infonce_intraview_loss``. Its denominator is
  ops/flashnce.py's ``flash_denom``: on a CUDA tensor the CUDA kernels for
  every N; on the CPU the dense form below 2,048 nodes, as the reference
  picks ``block = 0`` there, and otherwise the plain flash Function over
  row tiles of the largest divisor of N up to 1,024 that is a multiple of 8
  (dense when N has none);
* ``GGDModule``: BCE-with-logits over the summed projections,
  ``ggd_bce_loss``.

``eval_epoch`` reports the mean held-out loss, as the reference's does.

``compute_dtype`` "bfloat16" is the reference's policy: the features and
every model parameter rounded to bf16 at use (float32 masters keep the
gradients), the logsumexps and the means in float32. Random numbers come
from a ``torch.Generator`` on the module's device, or the caller passes the
model's ``draws`` (models/gcl.py). ``encode`` (embedding export) runs the
fused features through the clean encoder in float32.

Modality fusion (``fusion_fn``): with ``fuse_method`` attention or redaf
the module's ``fusion`` (models/fusion.py, ``embed_dim = in_dim``) turns
(N, M, d) features into (N, d), computed in float32 before the
``compute_dtype`` cast, as the JAX package does; without a fuser (N, M, d)
features take the mean over the modality axis and (N, d) features pass
through. The fuser's parameters train with the model's (they are in the
Adam state and the checkpoint's ``fusion`` subtree). ReDAF's dropout keep
mask is the ``draws`` entry ``fusion_keep``.

``_forward_loss(..., tp=...)`` is the same loss in a dp × tp step
(parallel/dp.py): the parameters are the tp rank's columns
(parallel/sharding.py) and the models compute their columns
(models/gcl.py). DGI's discriminator scores are sums over tp of the
ranks' parts; GRACE's projections are gathered whole over tp and the
InfoNCE (the flash denominator on the card) runs at full width on every
rank, entering the gradient once (each rank keeps its columns' part).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..interop.jax_params import load_jax_params
from ..models.encoders import GCNEncoder
from ..models.factory import FusionFactory
from ..models.gcl import DGI, GGD, GRACE
from ..ops.flashnce import NEG, PLAIN_BLOCK, flash_denom
from ..sampling.batch import GraphBatch
from .checkpoint import load_checkpoint
from .optim import make_optimizer
from .stepping import StepsMixin, mean_loss

LOG2 = math.log(2.0)
TAU = 0.2
DENSE_BELOW = 2048   # the CPU route's dense / blocked switch (reference)


def _masked_mean(values, mask):
    m = mask.to(values.dtype)
    return (values * m).sum() / m.sum().clamp(min=1.0)


def _softplus(x):
    """jax.nn.softplus: log(1 + e^x), exact for every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def jsd_g2l_loss(z, g, zn, node_mask, tp=None):
    """SingleBranchContrast(JSD, "G2L") for the DGI triple: each real node
    against the graph summary (under ``tp`` the columns' parts summed)."""
    wide = torch.promote_types(z.dtype, g.dtype)
    g = g.to(wide)
    d_pos = (z.to(wide) @ g.T).squeeze(-1).float()
    d_neg = (zn.to(wide) @ g.T).squeeze(-1).float()
    if tp is not None:
        d_pos, d_neg = tp.sum(d_pos), tp.sum(d_neg)
    e_pos = _masked_mean(LOG2 - _softplus(-d_pos), node_mask)
    e_neg = _masked_mean(_softplus(-d_neg) + d_neg - LOG2, node_mask)
    return e_neg - e_pos


def l2_normalize(h):
    return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True).clamp(
        min=1e-12)


def plain_block(n: int) -> int:
    """The CPU route's row tile: 0 (dense) below DENSE_BELOW, else the
    largest multiple-of-8 divisor of n up to 1,024 (0 if none)."""
    if n < DENSE_BELOW:
        return 0
    return max((b for b in range(8, 1025, 8) if n % b == 0), default=0)


def _direction_dense(an, bn, col, tau):
    """(pos, denom) from the materialised (N, N) logits."""
    inter = ((an @ bn.T) / tau).float() + col[None, :]
    intra = ((an @ an.T) / tau).float()
    eye = torch.eye(an.shape[0], dtype=torch.bool, device=an.device)
    intra = torch.where(eye, NEG, intra + col[None, :])
    denom = torch.logaddexp(torch.logsumexp(inter, 1),
                            torch.logsumexp(intra, 1))
    return torch.diagonal(inter), denom


def infonce_intraview_loss(h1, h2, node_mask, tau: float = TAU):
    """DualBranchContrast(InfoNCE(τ), "L2L", intraview_negs=True): cosine
    similarities, the positive on the inter-view diagonal, every inter-view
    pair and every other intra-view pair as negatives; both directions
    averaged. Logsumexps in float32 whatever the inputs' type."""
    col = torch.where(node_mask, 0.0, NEG).float()
    block = plain_block(h1.shape[0])
    dense = block == 0 and h1.device.type == "cpu"

    def direction(a, b):
        an, bn = l2_normalize(a), l2_normalize(b)
        if dense:
            pos, denom = _direction_dense(an, bn, col, tau)
        else:
            # the positive is the inter diagonal: a rowwise dot, outside
            # the flash Function (whose row tile only the CPU reads)
            pos = ((an * bn).sum(1) / tau).float() + col
            denom = flash_denom(an, bn, col, tau, block or PLAIN_BLOCK)
        return _masked_mean(-(pos - denom), node_mask)

    return 0.5 * (direction(h1, h2) + direction(h2, h1))


def ggd_bce_loss(pos_h, neg_h, node_mask):
    """BCE-with-logits over the summed projections, masked."""
    pred = torch.cat([pos_h, neg_h]).float()
    gt = torch.cat([torch.ones_like(pos_h), torch.zeros_like(neg_h)])
    w = torch.cat([node_mask, node_mask]).to(pred.dtype)
    loss = -(gt * F.logsigmoid(pred) + (1 - gt) * F.logsigmoid(-pred))
    return (loss * w).sum() / w.sum().clamp(min=1.0)


class BaseGCL(StepsMixin, nn.Module):
    kind = "gcl"
    model_name = "base"

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_hidden_layers: int, scheduler_type: str = "cosine",
                 learning_rate: float = 2e-4, warm_up_ratio: float = 0.03,
                 fuse_method: Optional[str] = None, seed: int = 42,
                 compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}")
        self.hparams = dict(
            in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim,
            num_hidden_layers=num_hidden_layers,
            scheduler_type=scheduler_type, learning_rate=learning_rate,
            warm_up_ratio=warm_up_ratio, fuse_method=fuse_method, seed=seed,
            compute_dtype=compute_dtype)
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)
        self.model = self._build_model(GCNEncoder(
            in_dim=in_dim, hidden_dim=hidden_dim, out_dim=out_dim,
            num_hidden_layers=num_hidden_layers))
        self.fusion = FusionFactory.create_fuser(method=fuse_method,
                                                 embed_dim=in_dim)

    def _build_model(self, encoder: GCNEncoder) -> nn.Module:
        raise NotImplementedError

    def calculate_loss(self, x, batch: GraphBatch, draws: Dict,
                       training: bool, tp=None) -> torch.Tensor:
        raise NotImplementedError

    def init(self, generator: torch.Generator):
        """Fresh weights from ``generator`` (the reference's init rules)."""
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
    def edge_layout(self) -> str:
        return self.model.encoder.edge_layout

    @edge_layout.setter
    def edge_layout(self, value: str):
        """"dst" (destination-sorted batches, the CUDA segment-sum) or
        "relation"; must match the loaders'."""
        if value not in ("relation", "dst"):
            raise ValueError(f"unknown edge_layout {value!r}")
        self.model.encoder.edge_layout = value

    def _forward_loss(self, batch: GraphBatch, training: bool,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict] = None, tp=None):
        """(loss, aux) of a device batch; the draws (the fuser's keep mask
        and the model's) come from ``generator`` unless passed in. ``tp``
        (a parallel/collectives.py ``TensorParallel``): the parameters are
        the tp rank's columns, the draws the whole-width ones."""
        x = self._batch_features(batch)
        if draws is None:
            if generator is None:
                raise ValueError("pass a torch.Generator or the draws")
            draws = {}
            if self.fusion is not None:
                draws["fusion_keep"] = self.fusion.draw_keep(x, generator,
                                                             training)
        x = self.fusion_fn(x, draws.get("fusion_keep"), training)
        x = x.to(self.compute_dtype)
        if "dropout" not in draws:
            draws = dict(draws, **self.model.draw(
                generator, x, batch.edge_mask, batch.node_mask, training))
        loss = self.calculate_loss(x, batch, draws, training, tp)
        return loss, {"loss": loss}

    def eval_epoch(self, outputs, split: str) -> Dict[str, float]:
        """``{split}_loss``: the mean of the epoch's batch losses."""
        return {f"{split}_loss": mean_loss(outputs)}

    @torch.inference_mode()
    def encode(self, batch: GraphBatch) -> torch.Tensor:
        """The fused features through the clean encoder over a device
        batch in float32 → (N_pad, out_dim): embedding export."""
        return self.model.encoder(self.fusion_fn(self._batch_features(batch)),
                                  batch.edge_index, batch.edge_mask,
                                  training=False)


class DGIModule(BaseGCL):
    model_name = "dgi"

    def _build_model(self, encoder):
        return DGI(encoder, self.hparams["hidden_dim"])

    def calculate_loss(self, x, batch, draws, training, tp=None):
        z, g, zn = self.model(x, batch.edge_index, batch.edge_mask,
                              batch.node_mask, draws, training=training,
                              dtype=self.compute_dtype, tp=tp)
        return jsd_g2l_loss(z, g, zn, batch.node_mask, tp)


class GRACEModule(BaseGCL):
    model_name = "grace"

    def _build_model(self, encoder):
        hidden = self.hparams["hidden_dim"]
        return GRACE(encoder, hidden, proj_dim=hidden)

    def calculate_loss(self, x, batch, draws, training, tp=None):
        z1, z2 = self.model(x, batch.edge_index, batch.edge_mask,
                            batch.node_mask, draws, training=training,
                            dtype=self.compute_dtype, tp=tp)
        h1 = self.model.project(z1, self.compute_dtype, tp)
        h2 = self.model.project(z2, self.compute_dtype, tp)
        if tp is not None:
            h1, h2 = tp.gather_cols_whole(h1), tp.gather_cols_whole(h2)
        return infonce_intraview_loss(h1, h2, batch.node_mask)


class GGDModule(BaseGCL):
    model_name = "ggd"

    def _build_model(self, encoder):
        return GGD(encoder, self.hparams["hidden_dim"], n_proj=1, aug_p=0.5)

    def calculate_loss(self, x, batch, draws, training, tp=None):
        pos_h, neg_h = self.model(x, batch.edge_index, batch.edge_mask,
                                  batch.node_mask, draws, training=training,
                                  dtype=self.compute_dtype, tp=tp)
        return ggd_bce_loss(pos_h, neg_h, batch.node_mask)


GCL_CLASSES = {"dgi": DGIModule, "grace": GRACEModule, "ggd": GGDModule}


def create_gcl_model(cfg: Mapping, seed: int = 42) -> BaseGCL:
    """The module ``cfg["model_name"]`` names, from the model config's keys
    (configs/model/gcl.yaml)."""
    cls = GCL_CLASSES.get(cfg["model_name"])
    if cls is None:
        raise NotImplementedError(cfg["model_name"])
    return cls(in_dim=cfg["in_dim"], hidden_dim=cfg["hidden_dim"],
               out_dim=cfg["out_dim"],
               num_hidden_layers=cfg["num_hidden_layers"],
               scheduler_type=cfg["scheduler_type"],
               learning_rate=cfg["learning_rate"],
               warm_up_ratio=cfg["warm_up_ratio"],
               fuse_method=cfg["fuse_method"], seed=seed,
               compute_dtype=cfg.get("compute_dtype", "float32"))


def load_gcl_module(ckpt_path: str,
                    device: Optional[torch.device] = None) -> BaseGCL:
    """A GCL checkpoint (written by either package; its
    ``extras["model_name"]`` names the model) as a module on ``device``."""
    ckpt = load_checkpoint(ckpt_path)
    if ckpt["kind"] != "gcl":
        raise ValueError(f"not a GCL checkpoint: {ckpt_path}")
    module = GCL_CLASSES[ckpt["extras"]["model_name"]](**ckpt["hparams"])
    load_jax_params(module.model, ckpt["params"], module.fusion)
    return module.to(resolve_device(device))
