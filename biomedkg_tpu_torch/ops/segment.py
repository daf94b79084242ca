"""Gather / scatter ops for message passing on padded batches
(counterpart of biomedkg_tpu/ops/segment.py).

Every row gather differentiates into a scatter that accumulates in float32
(float64 in float64) and returns the gradient's own type, as the
reference's custom VJPs do (bf16 sums saturate on hub nodes, ROADMAP.md
hazard H4); torch's own ``index_select`` backward would sum in the
gradient's type. ``take_rows_sorted`` routes that scatter through the
sorted segment-sum (ops/segsum.py: the CUDA kernel on a CUDA tensor), and
``take_rows_via_perm`` (``dst_bwd="perm"``) permutes the gradient into a
sorted order first. The reference's ``take_rows_matbwd`` (a one-hot
matmul backward for small tables, a TPU lowering choice) is ``take_rows``
here: the float32 scatter computes the same exact sums.

``scatter_max`` and ``segment_softmax`` (the RGAT attention) follow the
reference's, with every sum in float32 or wider (the reference sums the
softmax denominator in the scores' type).
"""

from __future__ import annotations

from typing import Optional

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


take_rows_matbwd = take_rows


class _TakeRowsViaPerm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, index, perm_pos, sorted_keys):
        ctx.save_for_backward(perm_pos, sorted_keys)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, index)

    @staticmethod
    def backward(ctx, g):
        perm_pos, sorted_keys = ctx.saved_tensors
        g2 = g.index_select(0, perm_pos)
        return (sorted_segment_sum(g2, sorted_keys, ctx.num_rows)
                .to(g.dtype), None, None, None)


def take_rows_via_perm(x: torch.Tensor, index: torch.Tensor,
                       perm_pos: torch.Tensor,
                       sorted_keys: torch.Tensor) -> torch.Tensor:
    """``x[index]`` whose backward permutes the gradient rows into an order
    where their keys ascend (``perm_pos``: the dst batch's
    (src, rel)-lexsorted copy, ``GraphBatch.src_pos``) and sums them with
    ``sorted_segment_sum`` at ``sorted_keys`` (int32), in place of the
    float32 scatter at the unsorted ``index`` (the JAX package's opt-in
    ``dst_bwd="perm"``). Contract: ``sorted_keys[i] ==
    index[perm_pos[i]]`` wherever that row's gradient is nonzero (pads may
    point anywhere with a zero gradient), ascending."""
    return _TakeRowsViaPerm.apply(x, index, perm_pos, sorted_keys)


def take_rows_sorted(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` whose backward is ``sorted_segment_sum``: exact for
    any order, fast for ascending ``index`` (destination-sorted edges)."""
    return _TakeRowsSorted.apply(x, index)


def scatter_add(values: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``values`` rows into ``num_segments`` buckets keyed by
    ``index``, accumulated in float32 (float64 in float64)."""
    acc = torch.promote_types(values.dtype, torch.float32)
    out = values.new_zeros((num_segments,) + values.shape[1:], dtype=acc)
    return out.index_add_(0, index, values.to(acc)).to(values.dtype)


def per_dst_relation_counts(dst: torch.Tensor, edge_type: torch.Tensor,
                            edge_mask: torch.Tensor, num_nodes: int,
                            num_relations: int) -> torch.Tensor:
    """Real edges per (dst node, relation) pair → (N, R) float32 (PyG
    RGCNConv's per-relation mean divides by these)."""
    flat = dst * num_relations + edge_type
    counts = scatter_add(edge_mask.float(), flat, num_nodes * num_relations)
    return counts.reshape(num_nodes, num_relations)


def scatter_max(values: torch.Tensor, index: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max-reduce ``values`` rows into ``num_segments`` buckets keyed by
    ``index``; an empty bucket holds ``finfo(dtype).min`` (the reference's
    ``segment_max`` gives -inf there)."""
    out = values.new_full((num_segments,) + values.shape[1:],
                          torch.finfo(values.dtype).min)
    idx = index.reshape((-1,) + (1,) * (values.dim() - 1)).expand_as(values)
    return out.scatter_reduce_(0, idx, values, "amax")


def segment_softmax(scores: torch.Tensor, index: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax of ``scores`` (E,) or (E, H) within the segments of
    ``index``; masked entries get probability 0 and an all-masked or empty
    segment stays finite. The segment max that shifts the exponents is
    detached: softmax is shift-invariant, so its gradient terms cancel
    exactly in exact arithmetic. The denominator sums in float32 and is
    clamped at 1e-16."""
    squeeze = scores.dim() == 1
    if squeeze:
        scores = scores[:, None]
    neg = torch.finfo(scores.dtype).min
    if mask is not None:
        scores = torch.where(mask[:, None], scores, neg)
    seg_max = scatter_max(scores.detach(), index, num_segments)
    expd = torch.exp(scores - take_rows(seg_max, index))
    if mask is not None:
        expd = torch.where(mask[:, None], expd, 0.0)
    denom = scatter_add(expd, index, num_segments)
    out = expd / take_rows(denom, index).clamp(min=1e-16)
    return out[:, 0] if squeeze else out
