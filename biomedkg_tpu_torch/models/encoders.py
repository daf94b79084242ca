"""Relational GCN, relational GAT and homogeneous GCN encoders
(counterpart of biomedkg_tpu/models/encoders.py).

Per layer (PyG RGCNConv with the per-relation mean):
    out_i = x_i @ W_root + b + Σ_r (1/|N_r(i)|) Σ_{j∈N_r(i)} x_j @ W_r
stacked in→hidden, num_hidden_layers×(hidden→hidden), hidden→out with
ReLU (+ inverted dropout 0.2 in training) between layers. The dropout
masks come from an explicit ``torch.Generator``, one per hidden layer in
the reference's order, or are passed in (the tests inject the reference's
masks, ROADMAP.md hazard H2).

``compute_dtype`` bfloat16 is the reference's mixed-precision policy: the
weights and x are cast to bf16 (the float32 masters keep the gradients),
matmuls sum in float32 and round to bf16, and the float32 aggregation is
cast back to bf16 before it joins the root term.

RGCN has two convs, picked as the reference picks them ("auto": node when
E >= R·N, else edge; the "dst" layout forces node):

* node-centric: R dense (N, din) @ (din, dout) products, a gather at
  ``rel·N + src``, then the per-destination sum;
* edge-centric ("relation" layout only): the gathered, masked source rows
  through the grouped GEMM over single-relation edge blocks
  (ops/relmm.py: the CUDA ``relation_matmul_sorted``, one launch per
  conv), then the same sum.

In the "dst" layout (destination-sorted batches) the sum and the (N, R)
count table run on the CUDA sorted segment-sum (ops/segsum.py): 1 + one
per conv launches per forward. The "relation" layout sums with a float32
``index_add_``.

Two opt-in ``dst_bwd`` variants read the dst batch's src-sorted copy
(``src_edges``, ``src_pos``) and change only where the gradients are
summed (the JAX package's opt-ins; it measured "agg" as a dead end at
its benchmark's envelope):

* "perm": the node conv transforms into an (N, R, dout) layout and
  gathers at ``src·R + rel`` with ``take_rows_via_perm``, whose backward
  permutes the gradient into the copy's order and sums it on the segsum
  (one more launch per conv in the backward);
* "agg": ops/aggconv.py's aggregate-then-transform conv, both SpMMs on
  the segsum (one in the forward, one in the backward, per conv), for the
  layers with din ≤ dout; wider-input layers (the 768 → 256 input conv)
  keep the node path.

``remat`` recomputes each conv in the backward
(``torch.utils.checkpoint``, as the JAX package's ``jax.checkpoint``):
less activation memory, the conv's launches twice.

RGAT (the reference's intended relational attention, PARITY.md) runs in
the "relation" layout only (its ``edge_layout`` refuses "dst"): per conv
one grouped GEMM (the source messages through W_r, H heads side by side,
head-major), additive attention logits, a masked softmax over each
destination's incoming edges, the float32 weighted sum and the head mean.
The logits come from per-(node, relation) projections: a_r·(x W_r) =
x·(W_r a_r), so one dense (N, din) @ (din, 2·R·H) product gives every
node's source and destination term under every relation, and each edge
gathers two scalars per head at ``src·2R + rel`` and ``dst·2R + R + rel``
(``attention_logits``), in float32 and rounded to ``compute_dtype`` once.
Each conv's three phases are spans of utils/profiling.py's recorder (off:
a test of its flag, nothing recorded): ``rgat.messages`` (the gather and
the grouped GEMM; ``launches`` and ``edge_slots``), ``rgat.attend`` (the
projection table, the logits, leaky ReLU and segment softmax;
``launches`` and ``pair_logit_convs``, one per conv) and
``rgat.aggregate`` (the weighted scatter and the head mean;
``launches``).

Under a dp × tp step (``tp``, a parallel/collectives.py
``TensorParallel``) each layer's weights are the rank's columns
(parallel/sharding.py): a conv computes those columns, the dropout takes
the rank's block of the whole-width mask, and the rows are all-gathered
before the next conv; the last conv's columns stay on the rank. RGAT's
projection table is each rank's part over its columns of every head,
summed over tp in float32 before the logits are gathered.

The GCN (the GCL models' encoder, PyG GCNConv) adds self-loops and
normalises symmetrically, D^-1/2 (A + I) D^-1/2 with the in-degree counted
on the real edges once per forward; per conv one dense product, the
gathered and scaled source rows, and their per-destination sum: the CUDA
sorted segment-sum in the "dst" layout (one launch per conv), a float32
``index_add_`` in the "relation" layout.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..nn import dropout, dropout_mask, xavier_uniform
from ..ops.aggconv import agg_conv
from ..ops.relmm import relation_matmul_sorted
from ..ops.segment import (per_dst_relation_counts, scatter_add,
                           segment_softmax, take_rows, take_rows_via_perm)
from ..ops.segsum import sorted_segment_sum
from ..utils import profiling

DROPOUT = 0.2
# RGAT's spans: each counts the hand-written launches; the messages also
# the batch's edge slots, the attention the convs whose logits come from
# the per-(node, relation) projection table
EDGE_SLOTS = "edge_slots"
PAIR_LOGIT_CONVS = "pair_logit_convs"
SPAN_COUNTERS = (profiling.LAUNCHES,)
MESSAGE_COUNTERS = (profiling.LAUNCHES, EDGE_SLOTS)
ATTEND_COUNTERS = (profiling.LAUNCHES, PAIR_LOGIT_CONVS)


def _layer_dims(in_dim, hidden_dim, out_dim, num_hidden_layers):
    dims = [(in_dim, hidden_dim)]
    dims += [(hidden_dim, hidden_dim)] * num_hidden_layers
    dims += [(hidden_dim, out_dim)]
    return dims


class RGCNLayer(nn.Module):
    def __init__(self, num_relations: int, din: int, dout: int):
        super().__init__()
        self.w_rel = nn.Parameter(torch.empty(num_relations, din, dout))
        self.w_root = nn.Parameter(torch.empty(din, dout))
        self.b = nn.Parameter(torch.zeros(dout))


def _dropout(x, i, training, drop_out, generator, dropout_masks, tp=None):
    """Inverted dropout after hidden conv ``i``: the injected mask, or one
    drawn from ``generator``, at the layer's whole width (under ``tp``
    the rank's block of it)."""
    if not (drop_out and training):
        return x
    width = x.shape[1] * (1 if tp is None else tp.size)
    if dropout_masks is not None:
        keep = dropout_masks[i]
    elif generator is not None:
        keep = dropout_mask((x.shape[0], width), DROPOUT, generator,
                            x.device)
    else:
        raise ValueError("training dropout needs a torch.Generator or "
                         "injected masks")
    if tp is not None:
        keep = keep[:, tp.cols(width)]
    return dropout(x, keep, DROPOUT)


def _next_input(x, i, training, drop_out, generator, dropout_masks, tp):
    """Hidden conv ``i``'s output as the next conv's input: ReLU, dropout,
    and under ``tp`` the ranks' columns gathered."""
    x = _dropout(torch.relu(x), i, training, drop_out, generator,
                 dropout_masks, tp)
    return x if tp is None else tp.gather_cols(x)


class RGCN(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_hidden_layers: int, num_relations: int,
                 drop_out: bool = True, conv_impl: str = "auto",
                 remat: bool = False):
        super().__init__()
        self.dims = _layer_dims(in_dim, hidden_dim, out_dim,
                                num_hidden_layers)
        self.num_relations = num_relations
        self.drop_out = drop_out
        self.remat = remat
        # "scatter", "perm" or "agg": where the dst layout's gradients are
        # summed (the module docstring)
        self.dst_bwd = "scatter"
        if conv_impl not in ("auto", "node", "edge"):
            raise ValueError(f"unknown conv_impl {conv_impl!r}")
        # "auto" picks node when E >= R·N (the reference's FLOP rule)
        self.conv_impl = conv_impl
        # "relation" or "dst" — must match the batches' layout
        self.edge_layout = "relation"
        self.layers = nn.ModuleList(
            RGCNLayer(num_relations, din, dout) for din, dout in self.dims)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        for layer in self.layers:
            layer.w_rel.copy_(xavier_uniform(layer.w_rel.shape, generator))
            layer.w_root.copy_(xavier_uniform(layer.w_root.shape, generator))
            layer.b.zero_()

    def _rel_onehot(self, edge_type):
        return edge_type[:, None] == torch.arange(
            self.num_relations, device=edge_type.device)[None, :]

    @staticmethod
    def _count_lookup(cnt2d, dst, ohr):
        """Per-edge count: the (N, R) table's row, one-hot selected."""
        return torch.where(ohr, take_rows(cnt2d, dst), 0.0).sum(1)

    def _edge_norm(self, dst, dst32, edge_type, edge_mask, num_nodes):
        """Per-edge 1/|N_r(dst)| (zero on pads), shared by every layer;
        in the "dst" layout also the (N, R) count table."""
        r = self.num_relations
        if self.edge_layout == "dst":
            ohr = self._rel_onehot(edge_type)
            cnt2d = sorted_segment_sum((ohr & edge_mask[:, None]).float(),
                                       dst32, num_nodes)
            flat_cnt = self._count_lookup(cnt2d, dst, ohr)
            return edge_mask.float() / flat_cnt.clamp(min=1.0), cnt2d
        else:
            cnt = per_dst_relation_counts(dst, edge_type, edge_mask,
                                          num_nodes, r)
            flat_cnt = take_rows(cnt.reshape(-1), dst * r + edge_type)
        return edge_mask.float() / flat_cnt.clamp(min=1.0), None

    def _conv(self, w_rel, w_root, b, x, src, dst, dst32, edge_type,
              edge_mask, block_rel, norm, perm=None):
        num_nodes = x.shape[0]
        impl = self.conv_impl
        if impl == "auto":
            impl = ("node" if edge_type.shape[0] >= self.num_relations
                    * num_nodes else "edge")
        if self.edge_layout == "dst":
            impl = "node"
        if impl == "node" and perm is not None:
            # (N, R, dout) layout, so the flat key src·R + rel is the
            # src-sorted copy's; the gather's backward sums on the segsum
            src_pos, key2 = perm
            r, dout = w_rel.shape[0], w_rel.shape[-1]
            h_all = x @ w_rel.permute(1, 0, 2).reshape(x.shape[1], r * dout)
            msg = take_rows_via_perm(h_all.reshape(-1, dout),
                                     src * r + edge_type, src_pos, key2)
        elif impl == "node":
            h_all = torch.matmul(x.unsqueeze(0), w_rel)   # (R, N, dout)
            flat = edge_type * num_nodes + src
            msg = take_rows(h_all.reshape(-1, h_all.shape[-1]), flat)
        else:
            msg = relation_matmul_sorted(
                take_rows(x, src) * edge_mask[:, None].to(x.dtype), w_rel,
                block_rel)
        # norm is zero on pad edges, so it also applies the edge mask; msg
        # is fresh (a gather's, or the grouped GEMM's, which its backward
        # does not keep), so scaling it in place saves an (E, dout) buffer
        msg = msg.mul_(norm[:, None])
        if self.edge_layout == "dst":
            agg = sorted_segment_sum(msg, dst32, num_nodes)
        else:
            agg = scatter_add(msg, dst, num_nodes)
        return x @ w_root + b + agg.to(x.dtype)

    def _agg_layer(self, w_rel, w_root, b, x, src, key, norm, s2, key2,
                   norm2):
        """The "agg" variant's conv: ops/aggconv.py + the root term."""
        agg = agg_conv(x, w_rel, src, key, norm.to(x.dtype), s2, key2,
                       norm2.to(x.dtype))
        return x @ w_root + b + agg

    def forward(self, x, edge_index, edge_type, edge_mask, block_rel=None,
                *, training: bool = False,
                compute_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[List[torch.Tensor]] = None,
                src_edges: Optional[torch.Tensor] = None,
                src_pos: Optional[torch.Tensor] = None, tp=None):
        """(N, out_dim) node embeddings in ``compute_dtype`` (under ``tp``
        the rank's columns). ``block_rel`` is the relation-layout batch's
        per-block relation (the edge conv needs it). In training, the
        dropout keep masks are ``dropout_masks`` (one bool (N, width) mask
        per hidden layer) or drawn from ``generator``. ``src_edges`` (4,
        E) [src, dst, rel, mask] and ``src_pos`` (E,), the dst batch's
        src-sorted copy, feed the ``dst_bwd`` variants."""
        if self.edge_layout not in ("relation", "dst"):
            raise ValueError(f"unknown edge_layout {self.edge_layout!r}")
        if self.dst_bwd not in ("scatter", "perm", "agg"):
            raise ValueError(f"unknown dst_bwd {self.dst_bwd!r}")
        src, dst = edge_index[0], edge_index[1]
        dst32 = dst.to(torch.int32) if self.edge_layout == "dst" else None
        num_nodes, r = x.shape[0], self.num_relations
        norm, cnt2d = self._edge_norm(dst, dst32, edge_type, edge_mask,
                                      num_nodes)
        norm = norm.to(compute_dtype)
        copy = (self.edge_layout == "dst" and src_edges is not None
                and src_edges.numel() > 0)
        variant = self.dst_bwd if copy else "scatter"
        if variant == "perm" and (src_pos is None or src_pos.numel() == 0):
            variant = "scatter"
        perm = None
        if variant == "perm":
            perm = (src_pos, (src_edges[0] * r + src_edges[2]).to(
                torch.int32))
        elif variant == "agg":
            s2, d2, r2, m2 = src_edges
            norm2 = m2.float() / self._count_lookup(
                cnt2d, d2, self._rel_onehot(r2)).clamp(min=1.0)
            agg_args = (src, (dst * r + edge_type).to(torch.int32), norm,
                        s2.to(torch.int32), d2 * r + r2, norm2)

        def conv(w_rel, w_root, b, x, agg):
            if agg:
                return self._agg_layer(w_rel, w_root, b, x, *agg_args)
            return self._conv(w_rel, w_root, b, x, src, dst, dst32,
                              edge_type, edge_mask, block_rel, norm,
                              perm if variant == "perm" else None)

        x = x.to(compute_dtype)
        for i, layer in enumerate(self.layers):
            din, dout = self.dims[i]
            # the wide-input layers of "agg" keep the node path (the
            # layer's whole widths decide, under tp too)
            args = (layer.w_rel.to(compute_dtype),
                    layer.w_root.to(compute_dtype),
                    layer.b.to(compute_dtype), x,
                    variant == "agg" and din <= dout)
            x = (checkpoint(conv, *args, use_reentrant=False)
                 if self.remat else conv(*args))
            if i == len(self.layers) - 1:
                break
            x = _next_input(x, i, training, self.drop_out, generator,
                            dropout_masks, tp)
        return x


def attention_keys(src, dst, edge_type, edge_mask, num_nodes,
                   num_relations):
    """(2E,) each edge's two rows of the flat projection table: the
    sources' ``src·2R + rel``, then the destinations' ``dst·2R + R +
    rel``. A masked slot's logit is the softmax's to drop and gets a zero
    gradient, so its rows are spread over the table (slot i takes row i
    mod N·2R): the zeros its backward adds then fall on many addresses,
    not all on the pad node's few."""
    r2 = 2 * num_relations
    keys = torch.cat([src * r2 + edge_type,
                      dst * r2 + num_relations + edge_type])
    spread = torch.arange(keys.shape[0], device=keys.device) % (
        num_nodes * r2)
    return torch.where(edge_mask.repeat(2), keys, spread)


def attention_logits(x, w_rel, att_src, att_dst, keys, tp=None):
    """(E, H) attention logits a_src[r]·(x_u W_r) + a_dst[r]·(x_v W_r) of
    each edge u → v of relation r, as x_u·(W_r a_src[r]) + x_v·(W_r
    a_dst[r]): W_r's head blocks projected onto the attention vectors (U,
    (din, 2, R, H)), the table x @ U of every node's two terms under every
    relation, and two scalars a head gathered from it at ``keys``
    (``attention_keys``). The products sum in float32 (float64 in float64)
    from the weights in x's type, and the logits are rounded to x's type
    once. Under ``tp`` the weights are the rank's columns of every head,
    and the ranks' parts of the table are summed over tp before the
    gather."""
    acc = torch.promote_types(x.dtype, torch.float32)
    r, din, _ = w_rel.shape
    heads, dout = att_src.shape[1:]
    att = torch.stack([att_src, att_dst]).to(acc)     # (2, R, H, dout)
    u = torch.einsum("rihd,srhd->isrh",
                     w_rel.to(acc).reshape(r, din, heads, dout), att)
    table = x.to(acc) @ u.reshape(din, 2 * r * heads)
    if tp is not None:
        table = tp.sum_shared(table)
    terms = take_rows(table.reshape(-1, heads), keys)     # (2E, H)
    e = keys.shape[0] // 2
    return (terms[:e] + terms[e:]).to(x.dtype)


class RGATLayer(nn.Module):
    def __init__(self, num_relations: int, num_heads: int, din: int,
                 dout: int):
        super().__init__()
        # the last axis is head-major: (H·dout) reshapes to (H, dout)
        self.w_rel = nn.Parameter(
            torch.empty(num_relations, din, num_heads * dout))
        self.att_src = nn.Parameter(torch.empty(num_relations, num_heads,
                                                dout))
        self.att_dst = nn.Parameter(torch.empty(num_relations, num_heads,
                                                dout))
        self.b = nn.Parameter(torch.zeros(dout))


class RGAT(nn.Module):
    """Relational graph attention stack. Per head: e_uv = leaky_relu(
    a_src[r]·(x_u W_r) + a_dst[r]·(x_v W_r), 0.2), softmax over the
    incoming edges of v across relations, Σ_u α_uv (x_u W_r), the heads
    averaged (so every layer keeps the reference stack's widths), + b."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_hidden_layers: int, num_relations: int,
                 num_heads: int = 1, drop_out: bool = True):
        super().__init__()
        self.dims = _layer_dims(in_dim, hidden_dim, out_dim,
                                num_hidden_layers)
        self.num_relations = num_relations
        self.num_heads = num_heads
        self.drop_out = drop_out
        self.layers = nn.ModuleList(
            RGATLayer(num_relations, num_heads, din, dout)
            for din, dout in self.dims)

    @property
    def edge_layout(self) -> str:
        return "relation"

    @edge_layout.setter
    def edge_layout(self, value: str):
        """The grouped GEMM needs single-relation blocks: only "relation"."""
        if value != "relation":
            raise ValueError(f"RGAT requires relation-blocked batches "
                             f"(layout='relation'), got {value!r}")

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        for layer in self.layers:
            for p in (layer.w_rel, layer.att_src, layer.att_dst):
                p.copy_(xavier_uniform(p.shape, generator))
            layer.b.zero_()

    def _conv(self, layer, x, src, dst, edge_mask, block_rel, keys, dtype,
              tp=None):
        """One conv; ``keys`` are the batch's ``attention_keys``."""
        num_nodes, heads = x.shape[0], self.num_heads
        dout = layer.b.shape[0]
        with profiling.span("rgat.messages", counters=MESSAGE_COUNTERS):
            profiling.count(EDGE_SLOTS, src.shape[0])
            w_rel = layer.w_rel.to(dtype)
            # the (E, din) messages are a temporary: outside autograd they
            # are freed as soon as their product is taken
            hs = relation_matmul_sorted(
                take_rows(x, src) * edge_mask[:, None].to(x.dtype), w_rel,
                block_rel).reshape(-1, heads, dout)
        with profiling.span("rgat.attend", counters=ATTEND_COUNTERS):
            profiling.count(PAIR_LOGIT_CONVS, 1)
            logits = attention_logits(x, w_rel, layer.att_src.to(dtype),
                                      layer.att_dst.to(dtype), keys, tp)
            logits = torch.nn.functional.leaky_relu(logits, 0.2)
            alpha = segment_softmax(logits, dst, num_nodes, mask=edge_mask)
        with profiling.span("rgat.aggregate", counters=SPAN_COUNTERS):
            weighted = (hs * alpha[..., None]).reshape(-1, heads * dout)
            agg = scatter_add(weighted, dst, num_nodes)
            return (agg.reshape(num_nodes, heads, dout).mean(1)
                    + layer.b.to(dtype))

    def forward(self, x, edge_index, edge_type, edge_mask, block_rel=None,
                *, training: bool = False,
                compute_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[List[torch.Tensor]] = None,
                tp=None):
        """(N, out_dim) node embeddings in ``compute_dtype`` of a
        relation-layout batch; dropout and ``tp`` as ``RGCN.forward``."""
        src, dst = edge_index[0], edge_index[1]
        keys = attention_keys(src, dst, edge_type, edge_mask, x.shape[0],
                              self.num_relations)
        x = x.to(compute_dtype)
        for i, layer in enumerate(self.layers):
            x = self._conv(layer, x, src, dst, edge_mask, block_rel, keys,
                           compute_dtype, tp)
            if i == len(self.layers) - 1:
                break
            x = _next_input(x, i, training, self.drop_out, generator,
                            dropout_masks, tp)
        return x


class GCNLayer(nn.Module):
    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(din, dout))
        self.b = nn.Parameter(torch.zeros(dout))


class GCNEncoder(nn.Module):
    """Homogeneous GCN stack of the GCL models: in→hidden,
    num_hidden_layers×(hidden→hidden), hidden→out, ReLU (+ inverted dropout
    0.2 in training) between convs. ``compute_dtype`` bfloat16 rounds as the
    reference does: the dense product sums in float32 and rounds to bf16,
    the float32 segment-sum is cast to bf16 before the self-loop term joins
    it, and the edge weights are computed in bf16."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_hidden_layers: int, drop_out: bool = True):
        super().__init__()
        self.dims = _layer_dims(in_dim, hidden_dim, out_dim,
                                num_hidden_layers)
        self.drop_out = drop_out
        # "relation" or "dst" — must match the batches' layout; a GCN has
        # no relation blocks, so every batch may come destination-sorted
        # (augmentations drop edges through the mask, keeping the order)
        self.edge_layout = "relation"
        self.layers = nn.ModuleList(GCNLayer(din, dout)
                                    for din, dout in self.dims)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        for layer in self.layers:
            layer.w.copy_(xavier_uniform(layer.w.shape, generator))
            layer.b.zero_()

    @staticmethod
    def _edge_norm(src, dst, edge_mask, num_nodes, dtype):
        """The per-edge weight dis[src]·dis[dst] (zero on masked edges) and
        the self-loop weight 1/deg, deg = real in-degree + 1; shared by
        every conv."""
        em = edge_mask.to(dtype)
        deg = scatter_add(em[:, None], dst, num_nodes)[:, 0] + 1.0
        dis = torch.rsqrt(deg)
        return dis[src] * dis[dst] * em, 1.0 / deg

    def _conv(self, w, b, x, src, dst, dst32, norm_e, self_w):
        num_nodes = x.shape[0]
        h = x @ w
        # the gather's output is fresh, so scaling it in place saves an
        # (E, dout) buffer
        msg = take_rows(h, src).mul_(norm_e[:, None])
        if self.edge_layout == "dst":
            agg = sorted_segment_sum(msg, dst32, num_nodes).to(h.dtype)
        else:
            agg = scatter_add(msg, dst, num_nodes)
        return agg + h * self_w[:, None] + b

    def forward(self, x, edge_index, edge_mask, *, training: bool = False,
                compute_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[List[torch.Tensor]] = None,
                tp=None):
        """(N, out_dim) node embeddings in ``compute_dtype`` (under ``tp``
        the rank's columns); in training the dropout keep masks are
        ``dropout_masks`` (one bool (N, width) mask per hidden conv) or
        drawn from ``generator``."""
        if self.edge_layout not in ("relation", "dst"):
            raise ValueError(f"unknown edge_layout {self.edge_layout!r}")
        src, dst = edge_index[0], edge_index[1]
        dst32 = dst.to(torch.int32) if self.edge_layout == "dst" else None
        x = x.to(compute_dtype)
        norm_e, self_w = self._edge_norm(src, dst, edge_mask, x.shape[0],
                                         compute_dtype)
        for i, layer in enumerate(self.layers):
            x = self._conv(layer.w.to(compute_dtype),
                           layer.b.to(compute_dtype), x, src, dst, dst32,
                           norm_e, self_w)
            if i == len(self.layers) - 1:
                break
            x = _next_input(x, i, training, self.drop_out, generator,
                            dropout_masks, tp)
        return x
