"""Graph-partitioned full-graph execution: the node table and the edges
sharded over the ranks of the mesh's dp axis (counterpart of
biomedkg_tpu/parallel/graph_shard.py).

Shard p owns the node rows [p·shard_n, (p+1)·shard_n) and every edge whose
destination it owns. Each RGCN conv then:

  1. exchanges the remote rows its edges read: an ``all_gather`` of the
     row shards, or (``halo_plan``) an ``all_to_all`` halo exchange that
     ships only the rows each shard needs (per-pair send lists built on
     the host; P·H·d rows a rank a conv instead of N_pad·d);
  2. transforms its edge partition on the CUDA ``relation_matmul_sorted``
     (each partition is relation-block aligned) and sums the messages into
     its own rows (every destination is local);
  3. leaves the next conv's input shard in place.

The host side (``partition_graph``, ``balanced_node_order``,
``build_halo_plan``) is the JAX package's numpy, array for array.
``make_sharded_train_step`` trains on it: the masked BCE's numerator and
denominator and the L2 terms are summed over the ranks, gradients flow
back through the collectives (an all_gather's backward is a
reduce-scatter, an all_to_all's the reverse all_to_all), and the
replicated parameters' gradients are summed over the ranks (each rank's
loss carries its own edges' part; the decoder's L2 term enters on shard
0 only) before a replicated optimizer step.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.encoders import DROPOUT
from ..nn import dropout, dropout_mask
from ..ops.relmm import relation_matmul_sorted
from ..ops.segment import per_dst_relation_counts, scatter_add, take_rows
from ..sampling.batch import GraphBatch, pad_graph_batch
from ..training.stepping import TrainState, param_grads
from .collectives import (all_gather, all_reduce_grads, all_to_all, psum,
                          psum_replicated)
from .mesh import Mesh


class ShardedGraph(NamedTuple):
    x: np.ndarray          # (P, N_pad/P, D) node-feature shards
    edge_index: np.ndarray  # (P, 2, E_p) global src, global dst
    edge_type: np.ndarray   # (P, E_p)
    edge_mask: np.ndarray   # (P, E_p)
    block_rel: np.ndarray   # (P, E_p/block)
    node_mask: np.ndarray   # (P, N_pad/P)
    # (N_pad,) original node id of each sharded row (``balance=True``
    # relabels nodes; identity otherwise). Un-permute sharded outputs via
    # ``z_orig[node_order] = z_sharded``.
    node_order: np.ndarray = None


def balanced_node_order(batch: GraphBatch, num_shards: int) -> np.ndarray:
    """Degree-aware LPT node → shard assignment as a relabelling: nodes by
    in-degree descending, each onto the least edge-loaded shard with room
    (ownership is positional, ``dst // shard_n``). Returns ``node_order``,
    the original node of each new slot; the pad row stays the last."""
    n_pad = batch.x.shape[0]
    shard_n = n_pad // num_shards
    dst = batch.edge_index[1][batch.edge_mask]
    deg = np.bincount(dst, minlength=n_pad).astype(np.int64)
    order = np.argsort(-deg[:n_pad - 1], kind="stable")

    cap = np.full(num_shards, shard_n, np.int64)
    cap[-1] -= 1                       # reserve the global pad slot
    members = [[] for _ in range(num_shards)]
    heap = [(0, p) for p in range(num_shards)]
    heapq.heapify(heap)
    for node in order:
        while len(members[heap[0][1]]) >= cap[heap[0][1]]:
            heapq.heappop(heap)        # capacity sums to n_pad - 1
        load, p = heapq.heappop(heap)
        members[p].append(node)
        heapq.heappush(heap, (load + int(deg[node]), p))
    members[-1].append(n_pad - 1)      # pad row pinned last
    node_order = np.concatenate([np.asarray(m, np.int64)
                                 for m in members])
    assert len(node_order) == n_pad
    return node_order


def partition_graph(batch: GraphBatch, num_shards: int,
                    num_relations: int, block_size: int = 256,
                    balance: bool = False) -> ShardedGraph:
    """Split a padded full-graph batch into destination-partitioned,
    relation-block aligned edge shards padded to one envelope;
    ``balance=True`` relabels the nodes first (``balanced_node_order``)."""
    n_pad = batch.x.shape[0]
    if n_pad % num_shards:
        raise ValueError(f"node budget {n_pad} does not divide over "
                         f"{num_shards} shards")
    shard_n = n_pad // num_shards

    if balance:
        node_order = balanced_node_order(batch, num_shards)
        old2new = np.empty(n_pad, np.int64)
        old2new[node_order] = np.arange(n_pad)
        ei = old2new[batch.edge_index]
        batch = batch._replace(x=batch.x[node_order],
                               node_mask=batch.node_mask[node_order],
                               edge_index=ei.astype(
                                   batch.edge_index.dtype))
    else:
        node_order = np.arange(n_pad, dtype=np.int64)

    real = batch.edge_mask
    src = batch.edge_index[0][real]
    dst = batch.edge_index[1][real]
    et = batch.edge_type[real]
    owner = dst // shard_n

    parts = []
    for p in range(num_shards):
        sel = owner == p
        parts.append((np.stack([src[sel], dst[sel]]), et[sel]))

    # one relation-block aligned envelope across shards
    worst = block_size
    for _, et_p in parts:
        counts = np.bincount(et_p, minlength=num_relations)
        worst = max(worst, int(np.sum(
            (counts + block_size - 1) // block_size) * block_size))

    xs, eis, ets, ems, brs, nms = [], [], [], [], [], []
    for p, (ei_p, et_p) in enumerate(parts):
        # pad edges point at this shard's last local row, which may be a
        # real node: they add nothing only because the edge mask zeroes
        # both their message and their norm
        pb = pad_graph_batch(
            np.zeros((1, 1), np.float32), ei_p, et_p,
            num_relations=num_relations, node_budget=n_pad,
            edge_budget=worst, block_size=block_size)
        ei = pb.edge_index.copy()
        ei[:, ~pb.edge_mask] = (p + 1) * shard_n - 1
        xs.append(batch.x[p * shard_n:(p + 1) * shard_n])
        nms.append(batch.node_mask[p * shard_n:(p + 1) * shard_n])
        eis.append(ei)
        ets.append(pb.edge_type)
        ems.append(pb.edge_mask)
        brs.append(pb.block_rel)

    return ShardedGraph(
        x=np.stack(xs), edge_index=np.stack(eis), edge_type=np.stack(ets),
        edge_mask=np.stack(ems), block_rel=np.stack(brs),
        node_mask=np.stack(nms), node_order=node_order)


class HaloPlan(NamedTuple):
    """The host-built halo exchange of one partition (every conv reuses
    it). ``send_idx[p, q]``: the local rows (owner p's frame) p ships to
    q, padded to the worst per-pair halo ``halo`` with row 0.
    ``src_remap[q]``: shard q's edge sources in the frame ``[x_local |
    received rows]`` (a local source at ``src − q·shard_n``; one owned by
    p at position k of the sorted send list at ``shard_n + p·halo + k``).
    ``send_counts[p, q]``: the real rows p ships to q."""

    send_idx: np.ndarray   # (P, P, H) int32
    src_remap: np.ndarray  # (P, E_p) int32
    halo: int
    send_counts: np.ndarray = None


def build_halo_plan(sharded: ShardedGraph, shard_n: int) -> HaloPlan:
    """The all_to_all halo exchange of a destination-partitioned graph."""
    p_sh = sharded.edge_index.shape[0]
    need = {}
    for q in range(p_sh):
        src = sharded.edge_index[q][0]
        owner = src // shard_n
        for p in range(p_sh):
            if p != q:
                need[(p, q)] = np.unique(src[owner == p])
    halo = max([1] + [len(v) for v in need.values()])
    counts = np.zeros((p_sh, p_sh), np.int32)
    for (p, q), v in need.items():
        counts[p, q] = len(v)
    send_idx = np.zeros((p_sh, p_sh, halo), np.int32)
    remaps = []
    for q in range(p_sh):
        src = sharded.edge_index[q][0]
        owner = src // shard_n
        remap = (src - q * shard_n).astype(np.int64)
        for p in range(p_sh):
            if p == q:
                continue
            uniq = need[(p, q)]
            send_idx[p, q, :len(uniq)] = uniq - p * shard_n
            sel = owner == p
            remap[sel] = (shard_n + p * halo
                          + np.searchsorted(uniq, src[sel]))
        remaps.append(remap.astype(np.int32))
    return HaloPlan(send_idx, np.stack(remaps), halo, counts)


class LocalShard(NamedTuple):
    """One rank's shard of a ShardedGraph as tensors on its device (and
    its rows of the halo plan)."""
    shard: int
    x: torch.Tensor          # (shard_n, D) float32
    src: torch.Tensor        # (E_p,) global sources, int64
    dst_local: torch.Tensor  # (E_p,) destinations in the shard's frame
    edge_type: torch.Tensor  # (E_p,) int64
    edge_mask: torch.Tensor  # (E_p,) bool
    block_rel: torch.Tensor  # (E_p / block,) int64
    node_mask: torch.Tensor  # (shard_n,) bool
    send_idx: Optional[torch.Tensor] = None   # (P·H,) halo rows to ship
    src_remap: Optional[torch.Tensor] = None  # (E_p,) sources in the frame

    @property
    def rows(self) -> int:
        return self.x.shape[0]


def local_shard(sharded: ShardedGraph, mesh: Mesh, device,
                halo_plan: Optional[HaloPlan] = None) -> LocalShard:
    """This rank's shard (its dp index) of ``sharded`` on ``device``."""
    if sharded.x.shape[0] != mesh.dp:
        raise ValueError(f"{sharded.x.shape[0]} shards over a mesh of "
                         f"dp={mesh.dp}")
    p = mesh.dp_rank
    shard_n = sharded.x.shape[1]

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    ei = t(sharded.edge_index[p], torch.int64)
    halo = {}
    if halo_plan is not None:
        halo = dict(send_idx=t(halo_plan.send_idx[p].reshape(-1),
                               torch.int64),
                    src_remap=t(halo_plan.src_remap[p], torch.int64))
    return LocalShard(
        shard=p, x=t(sharded.x[p], torch.float32), src=ei[0],
        dst_local=ei[1] - p * shard_n,
        edge_type=t(sharded.edge_type[p], torch.int64),
        edge_mask=t(sharded.edge_mask[p], torch.bool),
        block_rel=t(sharded.block_rel[p], torch.int64),
        node_mask=t(sharded.node_mask[p], torch.bool), **halo)


def _exchange(x: torch.Tensor, local: LocalShard, group):
    """One conv's cross-rank rows → (rows, the edges' sources in them):
    the whole table (global ids), or ``[x_local | halo rows]`` (the
    remapped sources)."""
    if local.send_idx is None:
        return all_gather(x, group), local.src
    n = 1 if group is None else torch.distributed.get_world_size(group)
    send = take_rows(x, local.send_idx).reshape(n, -1, x.shape[1])
    recv = all_to_all(send, group)
    return torch.cat([x, recv.reshape(-1, x.shape[1])]), local.src_remap


def _encode_shard(encoder, local: LocalShard, group, *,
                  training: bool = False, generator=None,
                  dropout_masks=None,
                  compute_dtype: torch.dtype = torch.float32):
    """The RGCN stack on one shard: per conv one exchange, the grouped
    GEMM over the shard's relation blocks and the sum into its own rows;
    inverted dropout 0.2 after each hidden conv when ``encoder.drop_out``
    and ``training`` (the masks drawn per shard from ``generator``, or
    ``dropout_masks``). Returns the shard's (shard_n, out_dim) rows in
    ``compute_dtype``."""
    num_rel, n = encoder.num_relations, local.rows
    em = local.edge_mask
    cnt = per_dst_relation_counts(local.dst_local, local.edge_type, em, n,
                                  num_rel)
    flat_cnt = take_rows(cnt.reshape(-1),
                         local.dst_local * num_rel + local.edge_type)
    norm = (em.float() / flat_cnt.clamp(min=1.0)).to(compute_dtype)
    x = local.x.to(compute_dtype)
    last = len(encoder.layers) - 1
    for i, layer in enumerate(encoder.layers):
        rows, src = _exchange(x, local, group)
        msg = take_rows(rows, src) * em[:, None].to(compute_dtype)
        h = relation_matmul_sorted(msg, layer.w_rel.to(compute_dtype),
                                   local.block_rel)
        agg = scatter_add(h * norm[:, None], local.dst_local, n)
        x = x @ layer.w_root.to(compute_dtype) \
            + layer.b.to(compute_dtype) + agg
        if i == last:
            break
        x = torch.relu(x)
        if encoder.drop_out and training:
            keep = (dropout_masks[i] if dropout_masks is not None else
                    dropout_mask(x.shape, DROPOUT, generator, x.device))
            x = dropout(x, keep, DROPOUT)
    return x


@torch.no_grad()
def sharded_rgcn_encode(encoder, sharded: ShardedGraph, mesh: Mesh,
                        halo_plan: Optional[HaloPlan] = None
                        ) -> torch.Tensor:
    """The full-graph float32 RGCN forward with the node table sharded
    over the mesh's dp axis → (N_pad, out_dim) in shard order, on every
    rank."""
    local = local_shard(sharded, mesh, next(encoder.parameters()).device,
                        halo_plan)
    return all_gather(_encode_shard(encoder, local, mesh.dp_group),
                      mesh.dp_group)


def init_sharded_state(encoder, decoder, tx) -> TrainState:
    """A zero optimizer state over the encoder's and decoder's weights
    (named ``encoder.*`` / ``decoder.*``)."""
    params = {f"encoder.{k}": p for k, p in encoder.named_parameters()}
    params.update({f"decoder.{k}": p for k, p in decoder.named_parameters()})
    return TrainState(params, tx.init(list(params.values())), 0)


def make_sharded_train_step(encoder, decoder, tx, mesh: Mesh,
                            neg_ratio: int = 4,
                            halo_plan: Optional[HaloPlan] = None,
                            compute_dtype: torch.dtype = torch.float32):
    """Full-graph KGE training with the node table sharded over the
    mesh's dp axis. Returns ``run(state, sharded, generator=None,
    fixed_neg=None, dropout_masks=None) -> (state, loss)`` over
    ``init_sharded_state``'s state; ``sharded`` is a ShardedGraph or this
    rank's LocalShard.

    Per step each shard encodes its rows, all-gathers the final
    embeddings once, scores its own (destination-partitioned) edges and
    ``neg_ratio`` corruptions each, and the loss is the masked BCE over
    every shard's edges + 1e-2·(mean z² over the real nodes + Σ mean(leaf²)
    over the decoder), as training/kge_module.py computes it. ``fixed_neg``
    (P, 2, K, E_p) fixes every shard's (source, destination) negatives;
    otherwise each rank draws (K, E_p) pairs uniform over the real nodes
    (their count summed over the ranks) from ``generator``, which each
    rank seeds apart, as it draws its dropout masks. ``compute_dtype``
    bfloat16 runs the encoder in bf16 over the float32 weights (the
    grouped GEMM's ``wgmma`` instance), as the KGE module's does."""

    def run(state: TrainState, sharded, generator=None, fixed_neg=None,
            dropout_masks=None):
        local = sharded
        if isinstance(sharded, ShardedGraph):
            local = local_shard(sharded, mesh,
                                next(encoder.parameters()).device, halo_plan)
        group = mesh.dp_group
        z_local = _encode_shard(
            encoder, local, group, training=True, generator=generator,
            dropout_masks=dropout_masks, compute_dtype=compute_dtype).float()
        z_full = all_gather(z_local, group)
        em = local.edge_mask
        src = local.src
        dst = local.dst_local + local.shard * local.rows
        et = local.edge_type
        pos = decoder.score(z_full, src, dst, et)
        if fixed_neg is not None:
            fneg = torch.as_tensor(np.asarray(fixed_neg[local.shard])).to(
                device=z_full.device, dtype=torch.int64)
            neg_src, neg_dst = fneg[0], fneg[1]
        else:
            n_real = psum(local.node_mask.sum(), group).clamp(min=1)
            shape = (neg_ratio, et.shape[0])
            neg_src, neg_dst = (
                (torch.rand(shape, generator=generator,
                            device=generator.device) * n_real).long()
                for _ in range(2))
        neg = decoder.score_neg(z_full, neg_src, neg_dst, et).reshape(-1)
        k = neg_src.shape[0]
        pred = torch.cat([pos, neg])
        gt = torch.cat([torch.ones_like(pos), torch.zeros_like(neg)])
        w = torch.cat([em, em.expand(k, em.shape[0]).reshape(-1)]).to(
            pred.dtype)
        per = -(gt * torch.nn.functional.logsigmoid(pred)
                + (1.0 - gt) * torch.nn.functional.logsigmoid(-pred))
        num = psum_replicated(torch.sum(per * w), group)
        bce = num / psum(torch.sum(w), group).clamp(min=1.0)
        nm = local.node_mask.to(z_local.dtype)
        z_num = psum_replicated(torch.sum(z_local ** 2 * nm[:, None]), group)
        reg_z = z_num / (psum(nm.sum(), group).clamp(min=1.0)
                         * z_local.shape[-1])
        reg_rel = sum(torch.mean(p ** 2) for p in decoder.parameters())
        # every rank computes the decoder's L2 alike: shard 0 carries it
        reg_rel = psum_replicated(reg_rel if local.shard == 0
                                  else reg_rel * 0.0, group)
        loss = bce + 1e-2 * (reg_z + reg_rel)
        grads = all_reduce_grads(param_grads(loss, state.params), group)
        opt_state = tx.update(grads, state.opt_state,
                              list(state.params.values()))
        return (TrainState(state.params, opt_state, state.step + 1),
                loss.detach())

    return run
