"""Gather / scatter ops for message passing on padded batches
(counterpart of biomedkg_tpu/ops/segment.py).

Every row gather differentiates into a scatter that accumulates in float32
and returns the gradient's own type, as the reference's custom VJPs do
(bf16 sums saturate on hub nodes, ROADMAP.md hazard H4); torch's own
``index_select`` backward would sum in the gradient's type.
``take_rows_sorted`` routes that scatter through the sorted segment-sum
(ops/segsum.py: the CUDA kernel on a CUDA tensor). The reference's
``take_rows_matbwd`` (a one-hot matmul backward for small tables, a TPU
lowering choice) is ``take_rows`` here: the float32 scatter computes the
same exact sums.
"""

from __future__ import annotations

import torch

from .segsum import sorted_segment_sum


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index):
        ctx.save_for_backward(index)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return scatter_add(g, index, ctx.num_rows), None


def take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along rows (indices are in range by batch
    construction); the backward sums in float32."""
    return _TakeRows.apply(x, index)


class _TakeRowsSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index):
        ids = index.to(torch.int32)
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return (sorted_segment_sum(g.contiguous(), ids, ctx.num_rows)
                .to(g.dtype), None)


def take_rows_sorted(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` whose backward is ``sorted_segment_sum``: exact for
    any order, fast for ascending ``index`` (destination-sorted edges)."""
    return _TakeRowsSorted.apply(x, index)


def scatter_add(values: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``values`` rows into ``num_segments`` buckets keyed by
    ``index``, accumulated in float32."""
    out = values.new_zeros((num_segments,) + values.shape[1:],
                           dtype=torch.float32)
    return out.index_add_(0, index, values.float()).to(values.dtype)


def per_dst_relation_counts(dst: torch.Tensor, edge_type: torch.Tensor,
                            edge_mask: torch.Tensor, num_nodes: int,
                            num_relations: int) -> torch.Tensor:
    """Real edges per (dst node, relation) pair → (N, R) float32 (PyG
    RGCNConv's per-relation mean divides by these)."""
    flat = dst * num_relations + edge_type
    counts = scatter_add(edge_mask.float(), flat, num_nodes * num_relations)
    return counts.reshape(num_nodes, num_relations)
