"""Gather / scatter ops for message passing on padded batches
(counterpart of biomedkg_tpu/ops/segment.py).

Plain torch: the reference pins XLA's fast gather/scatter pair with custom
VJPs; torch's own ``index_select`` / ``index_add_`` already differentiate
into each other. Scatters accumulate in float32 (bf16 sums saturate on hub
nodes, ROADMAP.md hazard H4).
"""

from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along rows (indices are in range by batch
    construction)."""
    return x.index_select(0, index)


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
