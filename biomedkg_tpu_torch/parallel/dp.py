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
* ``make_spmd_train_step``: dp × tp, column-parallel, for every module
  the JAX package's GSPMD step takes (the KGE modules with RGCN or RGAT,
  any decoder, sampler and option; GRACE, DGI and GGD). Each tp rank
  holds the columns ``param_layout`` gives it of every leaf (sharding.py)
  and runs the module's own ``_forward_loss`` with a ``TensorParallel``
  context: the encoders compute their columns of every conv and
  all-gather them before the next conv's contraction, the decoders and
  GCL heads sum their partial scores over tp, the L2 terms sum over tp.
  The gradients average over dp, the clip reads the norm of the whole
  gradient, and Adam updates each shard.

``stack_batches`` / ``stack_batch_groups`` are the JAX package's host
stacking, byte for byte.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from ..sampling.batch import GraphBatch
from ..training.stepping import TrainState, param_grads
from .collectives import (TensorParallel, all_gather, all_reduce_grads,
                          psum)
from .mesh import Mesh
from .sharding import WHOLE_PREFIX, ShardSpec, param_layout


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

def shard_params(module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This tp rank's columns of each of the module's parameters in
    ``param_layout``'s order (a fresh leaf that requires grad; replicated
    leaves whole)."""
    layout = param_layout(module, mesh.tp)
    out = {}
    for name, p in module.named_parameters():
        t = p.detach()
        if layout[name] is not None:
            d, order = layout[name]
            t = (t.chunk(mesh.tp, dim=d)[mesh.tp_rank] if order is None else
                 t.index_select(d, order.view(mesh.tp, -1)[mesh.tp_rank]
                                .to(t.device)))
        out[name] = t.clone().contiguous().requires_grad_(True)
    return out


def _gather_leaf(t: torch.Tensor, d: int, group) -> torch.Tensor:
    """The ranks' blocks of dim ``d`` side by side (differentiable: the
    gradient is the group's sum, each rank keeping its block)."""
    return all_gather(t.movedim(d, 0).contiguous(), group).movedim(0, d)


@torch.no_grad()
def gather_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                  layout: Dict[str, ShardSpec]) -> Dict[str, torch.Tensor]:
    """The whole parameters from every tp rank's shards (``layout``:
    ``param_layout(module, mesh.tp)``)."""
    out = {}
    for name, t in params.items():
        if layout[name] is None or mesh.tp == 1:
            out[name] = t.detach().clone()
            continue
        d, order = layout[name]
        whole = _gather_leaf(t.detach(), d, mesh.tp_group).contiguous()
        if order is not None:
            whole = torch.empty_like(whole).index_copy_(
                d, order.to(whole.device), whole)
        out[name] = whole
    return out


@contextlib.contextmanager
def _bound(module, tensors: Dict[str, torch.Tensor]):
    """The module's parameters replaced by ``tensors`` (by name) while the
    block runs."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            sub = module.get_submodule(owner)
            saved.append((sub, leaf, sub._parameters[leaf]))
            sub._parameters[leaf] = t
        yield
    finally:
        for sub, leaf, p in reversed(saved):
            sub._parameters[leaf] = p


def init_spmd_state(module, mesh: Mesh) -> TrainState:
    """The dp × tp step's state: this rank's shards of the module's
    weights and a zero optimizer state over them."""
    if module.tx is None:
        raise RuntimeError("call configure_optimizers first")
    params = shard_params(module, mesh)
    return TrainState(params, module.tx.init(list(params.values())), 0)


def make_spmd_train_step(module, mesh: Mesh):
    """``step(state, batch, generator=None, **draws) -> (state, loss)``
    over ``init_spmd_state``'s shards, for a KGE or GCL module: the
    module's own ``_forward_loss`` with the tp context, on its parameters
    bound to the rank's shards (a fuser's gathered whole), the rank's own
    batch over dp; the loss returned is the dp mean. Every tp rank of a dp
    row takes the same batch and the same draws (a ``generator`` in the
    same state, or the keyword draws at full width).

    The gradients: a replicated leaf (a fuser's JAX keeps whole) feeds
    every rank's columns, so each rank holds part of its gradient, summed
    over tp; then every gradient is averaged over dp, the clip reads the
    norm of the whole gradient (each split leaf's squares summed over tp,
    a replicated leaf counted once), and Adam updates each shard."""
    if module.tx is None:
        raise RuntimeError("call configure_optimizers first")
    layout = param_layout(module, mesh.tp)
    tp = TensorParallel(mesh.tp_group, mesh.tp_rank, mesh.tp)
    replicated = [name for name, spec in layout.items() if spec is None]

    def step(state: TrainState, batch, generator=None, **draws):
        params = list(state.params.values())
        view = {name: (_gather_leaf(p, layout[name][0], mesh.tp_group)
                       if name.startswith(WHOLE_PREFIX)
                       and layout[name] is not None else p)
                for name, p in state.params.items()}
        with _bound(module, view):
            loss, _ = module._forward_loss(batch, training=True,
                                           generator=generator, tp=tp,
                                           **draws)
        grads = dict(zip(state.params, param_grads(loss, state.params)))
        if replicated:
            summed = all_reduce_grads([grads[n] for n in replicated],
                                      mesh.tp_group)
            grads.update(zip(replicated, summed))
        grads = all_reduce_grads(list(grads.values()), mesh.dp_group,
                                 mesh.dp)
        split = torch.zeros((), dtype=torch.float32, device=loss.device)
        whole = torch.zeros_like(split)
        for name, g in zip(state.params, grads):
            sq = torch.sum(g.float() ** 2)
            if layout[name] is None:
                whole = whole + sq
            else:
                split = split + sq
        g_norm = torch.sqrt(psum(split, mesh.tp_group) + whole)
        opt_state = module.tx.update(grads, state.opt_state, params,
                                     g_norm=g_norm)
        return (TrainState(state.params, opt_state, state.step + 1),
                _mean(loss, mesh))

    return step
