"""Data-parallel and dp × tp training steps (counterpart of
biomedkg_tpu/parallel/dp.py).

* ``make_dp_train_step``: the module's own ``train_step`` over the mesh's
  dp group (training/stepping.py): each rank of the axis takes its own
  batch, computes its loss and gradients, and the gradients and the loss
  are averaged over the axis (JAX's ``pmean``) by one explicit all-reduce
  of flat buckets; then the module's optimizer applies (clip, Adam) to
  the same mean on every rank, so the parameters stay identical. The
  module is not wrapped in ``DistributedDataParallel``: the port takes
  gradients with ``torch.autograd.grad``, which never fires DDP's hooks.
* ``make_dp_train_steps_scan``: k such steps in one call over the rank's k
  batches, returning the dp mean of the last loss.
* ``make_spmd_train_step``: dp × tp, column-parallel. Each tp rank holds
  the columns ``param_shard_dims`` gives it of every leaf (sharding.py):
  it computes its columns of every RGCN conv, all-gathers them over tp
  before the next conv's contraction, and sums DistMult's partial scores
  over its ``rel_emb`` columns with an all-reduce over tp; the L2 terms
  sum over tp too. The gradients average over dp, the clip reads the
  norm of the whole (gathered) gradient, and Adam updates each shard.
  RGAT and the other decoders under tp raise (ROADMAP.md queue 1, item
  12b), as do the modules' options the column-parallel loss does not
  carry (fusion, cold-start dropout, filtered negatives, fix_edge_id, the
  dst_bwd variants).

``stack_batches`` / ``stack_batch_groups`` are the JAX package's host
stacking, byte for byte.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.decoders import DistMult
from ..models.encoders import DROPOUT, RGCN
from ..nn import dropout, dropout_mask, sigmoid_binary_cross_entropy
from ..ops.negscore import distmult_neg_scores, distmult_neg_scores_ds
from ..ops.segment import take_rows, take_rows_sorted
from ..sampling.batch import GraphBatch
from ..training.kge_module import (_mix_factor, rolled_index,
                                   sample_negatives_sorted)
from ..training.stepping import TrainState, param_grads
from .collectives import (all_gather, all_gather_cols, all_reduce_grads,
                          psum, psum_replicated)
from .mesh import Mesh
from .sharding import param_shard_dims


def stack_batches(batches: List[GraphBatch]) -> GraphBatch:
    """Stack per-rank batches along a new leading (dp) axis."""
    return GraphBatch(*[
        np.stack([np.asarray(getattr(b, f)) for b in batches])
        for f in GraphBatch._fields])


def stack_batch_groups(groups: List[GraphBatch]) -> GraphBatch:
    """Stack k already-dp-stacked groups along a new leading (k) axis."""
    return GraphBatch(*[
        np.stack([np.asarray(getattr(g, f)) for g in groups])
        for f in GraphBatch._fields])


def _mean(loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return psum(loss.detach(), mesh.dp_group) / mesh.dp


def make_dp_train_step(module, mesh: Mesh):
    """``step(state, batch, generator=None, **draws) -> (state, loss)``:
    the module's ``train_step`` over the mesh's dp group, one optimizer
    step on this rank's device batch with the gradients and the returned
    loss averaged over the dp axis. ``draws`` go to the module's
    ``_forward_loss`` (the tests inject the reference's)."""
    def step(state: TrainState, batch, generator=None, **draws):
        state, logs = module.train_step(state, batch, generator,
                                        group=mesh.dp_group, **draws)
        return state, logs["train_loss"]

    return step


def make_dp_train_steps_scan(module, mesh: Mesh, k: int):
    """``steps(state, batches, generators=None, draws=None)``: ``k``
    optimizer steps over this rank's k batches (step j with
    ``generators[j]`` or the keyword draws ``draws[j]``); returns (state,
    the dp mean of the last step's loss)."""
    step = make_dp_train_step(module, mesh)

    def steps(state: TrainState, batches, generators=None, draws=None):
        if len(batches) != k:
            raise ValueError(f"want {k} batches a call, got {len(batches)}")
        loss = None
        for j, batch in enumerate(batches):
            state, loss = step(state, batch,
                               None if generators is None else generators[j],
                               **({} if draws is None else draws[j]))
        return state, loss

    return steps


# -- dp × tp -------------------------------------------------------------

def _tp_unsupported(module) -> Optional[str]:
    enc, dec = module.model.encoder, module.model.decoder
    if not isinstance(enc, RGCN):
        return f"the {type(enc).__name__} encoder"
    if type(dec) is not DistMult:
        return f"the {type(dec).__name__} decoder"
    if module.fusion is not None:
        return "modality fusion"
    if module.cold_start_dropout > 0.0:
        return "cold-start dropout"
    if module.filter_negatives:
        return "filtered negatives"
    if module.fix_edge_id is not None:
        return "fix_edge_id"
    if module.edge_layout == "dst" and module.dst_bwd != "scatter":
        return f"dst_bwd={module.dst_bwd!r}"
    return None


def shard_params(module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This tp rank's columns of each of the module's parameters (a fresh
    leaf that requires grad; replicated leaves whole)."""
    named = dict(module.named_parameters())
    dims = param_shard_dims(named)
    out = {}
    for name, p in named.items():
        d = dims[name]
        t = p.detach()
        if d is not None:
            if t.shape[d] % mesh.tp:
                raise ValueError(f"{name}: dim {d} of {tuple(t.shape)} does "
                                 f"not split over tp={mesh.tp}")
            t = t.chunk(mesh.tp, dim=d)[mesh.tp_rank]
        out[name] = t.clone().contiguous().requires_grad_(True)
    return out


@torch.no_grad()
def gather_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                  dims: Dict) -> Dict[str, torch.Tensor]:
    """The whole parameters from every tp rank's shards."""
    out = {}
    for name, t in params.items():
        d = dims[name]
        if d is None or mesh.tp == 1:
            out[name] = t.detach().clone()
            continue
        moved = t.detach().movedim(d, 0).contiguous()
        out[name] = all_gather(moved, mesh.tp_group).movedim(0, d).contiguous()
    return out


def _tp_forward_loss(module, params, batch, mesh: Mesh, generator=None,
                     negatives=None, dropout_masks=None) -> torch.Tensor:
    """The KGE loss (kge_module.py's ``_forward_loss`` with
    ``training=True``) with every leaf split over tp by columns."""
    enc = module.model.encoder
    group, t = mesh.tp_group, mesh.tp_rank
    cd = module.compute_dtype
    if generator is None and (negatives is None or (
            enc.drop_out and dropout_masks is None)):
        raise ValueError("pass a torch.Generator or the draws "
                         "(negatives, dropout_masks)")
    x = module.fusion_fn(module._batch_features(batch))
    etype, block_rel, emask = batch.edge_type, batch.block_rel, \
        batch.edge_mask
    src, dst = batch.edge_index[0], batch.edge_index[1]
    num_nodes = x.shape[0]
    dst32 = dst.to(torch.int32) if enc.edge_layout == "dst" else None
    norm, _ = enc._edge_norm(dst, dst32, etype, emask, num_nodes)
    norm = norm.to(cd)
    h = x.to(cd)
    last = len(enc.layers) - 1
    for i in range(last + 1):
        w_rel, w_root, b = (params[f"model.encoder.layers.{i}.{k}"].to(cd)
                            for k in ("w_rel", "w_root", "b"))
        out = enc._conv(w_rel, w_root, b, h, src, dst, dst32, etype, emask,
                        block_rel, norm)
        if i == last:
            break
        out = torch.relu(out)
        if enc.drop_out:
            keep = (dropout_masks[i] if dropout_masks is not None else
                    dropout_mask((num_nodes, enc.dims[i][1]), DROPOUT,
                                 generator, out.device))
            c = out.shape[1]
            out = dropout(out, keep[:, t * c:(t + 1) * c], DROPOUT)
        h = all_gather_cols(out, group)
    z = out.float()
    rel = params["model.decoder.rel_emb"]

    tail = (take_rows_sorted(z, dst) if enc.edge_layout == "dst"
            else take_rows(z, dst))
    pos = psum_replicated(torch.sum(
        take_rows(z, src) * take_rows(rel, etype) * tail, dim=-1), group)
    ratio = module.neg_ratio or 1
    num_edges = etype.shape[0]
    num_real = batch.node_mask.sum().clamp(min=1)
    z_neg = z.to(cd)
    if module.neg_sampler in ("sorted", "sorted2"):
        dual = module.neg_sampler == "sorted2"
        ns, nd, off = (negatives if negatives is not None else
                       sample_negatives_sorted(generator, ratio, num_edges,
                                               num_real, dual=dual))
        idx = rolled_index(off, num_edges, _mix_factor(num_edges))
        fn = distmult_neg_scores_ds if dual else distmult_neg_scores
        neg = fn(z_neg, ns, nd, etype[idx].to(torch.int32), rel)
        neg_mask = emask[idx]
    else:
        if negatives is None:
            shape = (ratio, num_edges)
            negatives = tuple(
                (torch.rand(shape, generator=generator,
                            device=generator.device) * num_real).long()
                for _ in range(2))
        ns, nd = negatives
        hn = take_rows(z_neg, ns.reshape(-1)).reshape(ratio, num_edges, -1)
        tn = take_rows(z_neg, nd.reshape(-1)).reshape(ratio, num_edges, -1)
        neg = torch.sum(hn * take_rows(rel, etype).to(cd)[None] * tn,
                        dim=-1).float().reshape(-1)
        neg_mask = emask.expand(ratio, num_edges).reshape(-1)
    neg = psum_replicated(neg, group)

    pred = torch.cat([pos, neg])
    gt = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
    weights = torch.cat([emask, neg_mask]).to(pred.dtype)
    bce = sigmoid_binary_cross_entropy(pred, gt, weights)
    nmask = batch.node_mask.to(z.dtype)
    width = enc.dims[-1][1]
    reg_z = psum_replicated(torch.sum(z ** 2 * nmask[:, None]), group) / (
        nmask.sum().clamp(min=1.0) * width)
    reg_rel = psum_replicated(torch.sum(rel ** 2), group) / (
        rel.numel() * mesh.tp)
    return bce + 1e-2 * (reg_z + reg_rel)


def init_spmd_state(module, mesh: Mesh) -> TrainState:
    """The dp × tp step's state: this rank's shards of the module's
    weights and a zero optimizer state over them."""
    if module.tx is None:
        raise RuntimeError("call configure_optimizers first")
    params = shard_params(module, mesh)
    return TrainState(params, module.tx.init(list(params.values())), 0)


def make_spmd_train_step(module, mesh: Mesh):
    """``step(state, batch, generator=None, negatives=None,
    dropout_masks=None) -> (state, loss)`` over ``init_spmd_state``'s
    shards: column-parallel over tp, the rank's own batch over dp; the
    loss returned is the dp mean. Every tp rank of a dp row takes the same
    batch and the same draws (the dropout masks at full width)."""
    why = _tp_unsupported(module)
    if why is not None:
        raise NotImplementedError(
            f"tensor parallelism for {why} is not ported (ROADMAP.md queue "
            "1, item 12b)")
    if module.tx is None:
        raise RuntimeError("call configure_optimizers first")
    dims = param_shard_dims(dict(module.named_parameters()))

    def step(state: TrainState, batch, generator=None, negatives=None,
             dropout_masks=None):
        params = list(state.params.values())
        loss = _tp_forward_loss(module, state.params, batch, mesh, generator,
                                negatives, dropout_masks)
        grads = all_reduce_grads(param_grads(loss, state.params),
                                 mesh.dp_group, mesh.dp)
        split = torch.zeros((), dtype=torch.float32, device=loss.device)
        whole = torch.zeros_like(split)
        for name, g in zip(state.params, grads):
            sq = torch.sum(g.float() ** 2)
            if dims[name] is None:
                whole = whole + sq
            else:
                split = split + sq
        g_norm = torch.sqrt(psum(split, mesh.tp_group) + whole)
        opt_state = module.tx.update(grads, state.opt_state, params,
                                     g_norm=g_norm)
        return (TrainState(state.params, opt_state, state.step + 1),
                _mean(loss, mesh))

    return step
