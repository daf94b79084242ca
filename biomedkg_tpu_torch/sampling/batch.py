"""Static-shape padded graph batches (counterpart of
biomedkg_tpu/sampling/batch.py).

``pad_graph_batch`` is the reference's host-side packing, array for array:
the same layouts, dtypes and pad conventions, so both packages see
byte-identical batches. ``batch_to_device`` moves a batch to torch and
widens the compact wire dtypes (int16 / int8 at small budgets) to int64,
the index type of torch gathers; kernels that take int32 ids narrow their
own copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class GraphBatch(NamedTuple):
    x: np.ndarray            # (N_pad, D) features, or (0,)
    edge_index: np.ndarray   # (2, E_pad)
    edge_type: np.ndarray    # (E_pad,)
    node_mask: np.ndarray    # (N_pad,) bool — real nodes
    edge_mask: np.ndarray    # (E_pad,) bool — real edges
    block_rel: np.ndarray    # (E_pad // block_size,)
    num_seed: np.ndarray     # () int32 — seed nodes occupy rows [0, num_seed)
    node_ids: np.ndarray     # (N_pad,) int32 global node ids (pad slots: 0)
    # dst layout: (4, E_pad) [src (ascending), dst, rel, mask] copy of the
    # edges, (src, rel)-lexsorted; empty (0,) otherwise
    src_edges: np.ndarray = np.zeros(0, np.int16)
    # dst layout: position of each copy edge in the primary order
    src_pos: np.ndarray = np.zeros(0, np.int32)

    @property
    def num_nodes(self) -> int:
        return self.node_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]


def pad_graph_batch(
    x: Optional[np.ndarray],
    edge_index: np.ndarray,
    edge_type: np.ndarray,
    num_relations: int,
    node_budget: int,
    edge_budget: int,
    block_size: int = 256,
    num_seed: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    node_ids: Optional[np.ndarray] = None,
    num_nodes_hint: Optional[int] = None,
    layout: str = "relation",
) -> GraphBatch:
    """Pack a subgraph into a fixed (node_budget, edge_budget) envelope.

    ``layout``:
      * "relation" — relation-sorted edges, each relation segment padded to
        a multiple of ``block_size`` (single-relation blocks, ``block_rel``).
      * "dst" — edges (dst, rel)-lexsorted. Pad SRCs target the dummy node
        (the last node slot); pad DST/REL entries repeat the last real
        values so the ids stay ascending — ``edge_mask``, not the ids,
        marks pads.
    Overflowing edges are dropped as a uniform random subset.
    """
    if edge_budget % block_size:
        raise ValueError("edge budget must align to blocks")
    if layout not in ("relation", "dst"):
        raise ValueError(f"unknown layout {layout!r}")
    num_nodes = x.shape[0] if x is not None else num_nodes_hint
    if num_nodes > node_budget - 1:
        raise ValueError(
            f"subgraph has {num_nodes} nodes > budget {node_budget} - 1 dummy"
        )

    edge_index = np.asarray(edge_index, dtype=np.int32)
    edge_type = np.asarray(edge_type, dtype=np.int32)
    num_edges = edge_type.shape[0]

    counts = np.bincount(edge_type, minlength=num_relations)
    padded_total = int(np.sum((counts + block_size - 1) // block_size)
                       * block_size)
    over = (num_edges > edge_budget) if layout == "dst" \
        else (padded_total > edge_budget)
    if over:
        rng = rng or np.random.default_rng(0)
        perm = rng.permutation(num_edges)
        if layout == "dst":
            keep = edge_budget
        else:
            keep = max(1, num_edges * edge_budget // padded_total)
            while keep > 0:
                sel = perm[:keep]
                counts = np.bincount(edge_type[sel],
                                     minlength=num_relations)
                padded_total = int(np.sum(
                    (counts + block_size - 1) // block_size) * block_size)
                if padded_total <= edge_budget:
                    break
                keep = min(keep - 1,
                           keep * edge_budget // max(padded_total, 1))
        sel = perm[:max(keep, 0)]
        edge_index = edge_index[:, sel]
        edge_type = edge_type[sel]
        num_edges = edge_type.shape[0]
        counts = np.bincount(edge_type, minlength=num_relations)

    idx_dt = np.int16 if node_budget < 2**15 else np.int32
    rel_dt = np.int8 if num_relations < 2**7 else np.int32
    dummy = node_budget - 1
    ei = np.full((2, edge_budget), dummy, dtype=idx_dt)
    et = np.zeros(edge_budget, dtype=rel_dt)
    emask = np.zeros(edge_budget, dtype=bool)
    block_rel = np.zeros(edge_budget // block_size, dtype=rel_dt)
    if layout == "dst":
        order = np.lexsort((edge_type, edge_index[1]))
        ei[0, :num_edges] = edge_index[0, order]
        ei[1, :num_edges] = edge_index[1, order]
        et[:num_edges] = edge_type[order]
        emask[:num_edges] = True
        if num_edges:
            ei[1, num_edges:] = ei[1, num_edges - 1]
            et[num_edges:] = et[num_edges - 1]

        sdt = np.int16 if max(node_budget, num_relations) < 2**15 \
            else np.int32
        src_edges = np.zeros((4, edge_budget), dtype=sdt)
        src_pos = np.full(edge_budget, edge_budget - 1, np.int32)
        if num_edges:
            o2 = np.lexsort((et[:num_edges], ei[0, :num_edges]))
            src_edges[0, :num_edges] = ei[0, :num_edges][o2]
            src_edges[1, :num_edges] = ei[1, :num_edges][o2]
            src_edges[2, :num_edges] = et[:num_edges][o2]
            src_edges[3, :num_edges] = 1
            src_edges[0, num_edges:] = src_edges[0, num_edges - 1]
            src_edges[1, num_edges:] = src_edges[1, num_edges - 1]
            src_edges[2, num_edges:] = src_edges[2, num_edges - 1]
            src_pos[:num_edges] = o2
        return _finish_batch(x, num_nodes, node_budget, node_ids, num_seed,
                             ei, et, emask, block_rel,
                             src_edges=src_edges, src_pos=src_pos)

    # relation-sorted placement with per-segment block padding
    order = np.argsort(edge_type, kind="stable")
    seg_padded = ((counts + block_size - 1) // block_size) * block_size
    seg_offsets = np.concatenate([[0], np.cumsum(seg_padded)[:-1]])
    within = np.arange(num_edges) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    pos = np.repeat(seg_offsets, counts) + within
    ei[0, pos] = edge_index[0, order]
    ei[1, pos] = edge_index[1, order]
    et[pos] = edge_type[order]
    emask[pos] = True

    for r in range(num_relations):
        if seg_padded[r] == 0:
            continue
        lo, hi = seg_offsets[r], seg_offsets[r] + seg_padded[r]
        block_rel[lo // block_size: hi // block_size] = r
        # pad rows inside a segment keep its relation id (single-relation
        # blocks); they stay masked and point at the dummy node
        et[lo:hi][~emask[lo:hi]] = r

    return _finish_batch(x, num_nodes, node_budget, node_ids, num_seed,
                         ei, et, emask, block_rel)


def _finish_batch(x, num_nodes, node_budget, node_ids, num_seed,
                  ei, et, emask, block_rel,
                  src_edges=None, src_pos=None) -> GraphBatch:
    if x is not None:
        xp = np.zeros((node_budget,) + x.shape[1:], dtype=np.float32)
        xp[:num_nodes] = x
    else:
        xp = np.zeros(0, dtype=np.float32)
    nmask = np.zeros(node_budget, dtype=bool)
    nmask[:num_nodes] = True
    ids = np.zeros(node_budget, dtype=np.int32)
    ids[:num_nodes] = (np.asarray(node_ids, np.int32) if node_ids is not None
                       else np.arange(num_nodes, dtype=np.int32))
    return GraphBatch(
        x=xp,
        edge_index=ei,
        edge_type=et,
        node_mask=nmask,
        edge_mask=emask,
        block_rel=block_rel,
        num_seed=np.int32(num_seed if num_seed is not None else num_nodes),
        node_ids=ids,
        src_edges=(src_edges if src_edges is not None
                   else np.zeros(0, np.int16)),
        src_pos=(src_pos if src_pos is not None
                 else np.zeros(0, np.int32)),
    )


def batch_to_device(batch: GraphBatch, device,
                    pinned: bool = False) -> GraphBatch:
    """The batch as torch tensors on ``device``: float32 features, bool
    masks, every index array widened to int64. ``pinned``: each array is
    pinned and copied with ``non_blocking=True`` in its wire type, then
    widened on the card, all on the caller's current stream."""
    def move(a, dtype):
        if pinned:
            host = torch.as_tensor(a).pin_memory()
            return host.to(device, non_blocking=True).to(dtype)
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return GraphBatch(
        x=move(batch.x, torch.float32),
        edge_index=move(batch.edge_index, torch.int64),
        edge_type=move(batch.edge_type, torch.int64),
        node_mask=move(batch.node_mask, torch.bool),
        edge_mask=move(batch.edge_mask, torch.bool),
        block_rel=move(batch.block_rel, torch.int64),
        num_seed=move(batch.num_seed, torch.int64),
        node_ids=move(batch.node_ids, torch.int64),
        src_edges=move(batch.src_edges, torch.int64),
        src_pos=move(batch.src_pos, torch.int64),
    )
