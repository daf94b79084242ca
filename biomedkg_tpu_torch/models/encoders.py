"""Relational GCN encoder (counterpart of biomedkg_tpu/models/encoders.py).

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

Only the node-centric conv is ported: R dense (N, din) @ (din, dout)
products, a gather at ``rel·N + src``, then the per-destination sum. In
the "dst" layout (destination-sorted batches) that sum and the (N, R)
count table run on the CUDA sorted segment-sum (ops/segsum.py): 1 + one
per conv launches per forward. The "relation" layout sums with a float32
``index_add_``. The edge-centric conv, RGAT and the ``dst_bwd`` variants
need kernels not yet ported and raise.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..nn import dropout, dropout_mask, xavier_uniform
from ..ops.segment import per_dst_relation_counts, scatter_add, take_rows
from ..ops.segsum import sorted_segment_sum

_EDGE_CONV = ("the edge-centric conv needs relation_matmul_sorted, not "
              "ported yet (ROADMAP.md: TPU kernels still to port, "
              "relmm.py::relation_matmul_sorted)")


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


class RGCN(nn.Module):
    DROPOUT = 0.2

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_hidden_layers: int, num_relations: int,
                 drop_out: bool = True, conv_impl: str = "auto"):
        super().__init__()
        self.dims = _layer_dims(in_dim, hidden_dim, out_dim,
                                num_hidden_layers)
        self.num_relations = num_relations
        self.drop_out = drop_out
        if conv_impl not in ("auto", "node", "edge"):
            raise ValueError(f"unknown conv_impl {conv_impl!r}")
        # "auto" picks node when E >= R·N (the reference's FLOP rule);
        # "edge" is not ported
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

    def _edge_norm(self, dst, dst32, edge_type, edge_mask, num_nodes):
        """Per-edge 1/|N_r(dst)| (zero on pads), shared by every layer."""
        r = self.num_relations
        if self.edge_layout == "dst":
            ohr = edge_type[:, None] == torch.arange(
                r, device=edge_type.device)[None, :]
            cnt2d = sorted_segment_sum((ohr & edge_mask[:, None]).float(),
                                       dst32, num_nodes)
            flat_cnt = torch.where(ohr, take_rows(cnt2d, dst), 0.0).sum(1)
        else:
            cnt = per_dst_relation_counts(dst, edge_type, edge_mask,
                                          num_nodes, r)
            flat_cnt = take_rows(cnt.reshape(-1), dst * r + edge_type)
        return edge_mask.float() / flat_cnt.clamp(min=1.0)

    def _conv(self, w_rel, w_root, b, x, src, dst, dst32, edge_type,
              norm):
        num_nodes = x.shape[0]
        impl = self.conv_impl
        if impl == "auto":
            impl = ("node" if edge_type.shape[0] >= self.num_relations
                    * num_nodes else "edge")
        if impl == "edge" and self.edge_layout != "dst":
            raise NotImplementedError(_EDGE_CONV)
        h_all = torch.matmul(x.unsqueeze(0), w_rel)   # (R, N, dout)
        flat = edge_type * num_nodes + src
        # norm is zero on pad edges, so it also applies the edge mask; the
        # gather's result is fresh, so scaling it in place saves an
        # (E, dout) buffer
        msg = take_rows(h_all.reshape(-1, h_all.shape[-1]), flat)
        msg = msg.mul_(norm[:, None])
        if self.edge_layout == "dst":
            agg = sorted_segment_sum(msg, dst32, num_nodes)
        else:
            agg = scatter_add(msg, dst, num_nodes)
        return x @ w_root + b + agg.to(x.dtype)

    def forward(self, x, edge_index, edge_type, edge_mask, *,
                training: bool = False,
                compute_dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                dropout_masks: Optional[List[torch.Tensor]] = None):
        """(N, out_dim) node embeddings in ``compute_dtype``. In training,
        the dropout keep masks are ``dropout_masks`` (one bool (N, width)
        mask per hidden layer) or drawn from ``generator``."""
        if self.edge_layout not in ("relation", "dst"):
            raise ValueError(f"unknown edge_layout {self.edge_layout!r}")
        src, dst = edge_index[0], edge_index[1]
        dst32 = dst.to(torch.int32) if self.edge_layout == "dst" else None
        norm = self._edge_norm(dst, dst32, edge_type, edge_mask, x.shape[0])
        norm = norm.to(compute_dtype)
        x = x.to(compute_dtype)
        for i, layer in enumerate(self.layers):
            x = self._conv(layer.w_rel.to(compute_dtype),
                           layer.w_root.to(compute_dtype),
                           layer.b.to(compute_dtype), x, src, dst, dst32,
                           edge_type, norm)
            if i == len(self.layers) - 1:
                break
            x = torch.relu(x)
            if self.drop_out and training:
                if dropout_masks is not None:
                    keep = dropout_masks[i]
                elif generator is not None:
                    keep = dropout_mask(x.shape, self.DROPOUT, generator,
                                        x.device)
                else:
                    raise ValueError("training dropout needs a "
                                     "torch.Generator or injected masks")
                x = dropout(x, keep, self.DROPOUT)
        return x
