"""Hetero-native typed tables (counterpart of biomedkg_tpu/models/typed.py):
one feature table per node type and one edge block per (head_type,
relation, tail_type) signature, instead of the merged homogeneous graph.

Every block is single-relation and single-src/dst-type, so a conv is, per
signature: the source type's rows gathered at ``src_local``
(``take_rows``: the backward a float32 ``index_add_``), one dense product
with ``w_rel[r]``, and one sorted segment-sum over the ascending
``dst_local`` into the destination type's table (ops/segsum.py: the CUDA
kernel on a CUDA tensor, its plain version on the CPU), divided by the
(dst, r) count. The root term and bias are shared as in the homogeneous
RGCN (mean-per-(dst, rel) aggregation), so ``typed_encode`` equals
``RGCN`` on the merged graph, and the parameters are the port's ``RGCN``
layers' (``w_rel`` (R, din, dout), ``w_root``, ``b``): a typed-trained
model is an RGCN.

The typed path runs in float32 whatever the module's ``compute_dtype``
says, as the JAX typed path does. Training dropout (p = 0.2 after each
hidden conv) draws one keep mask per type from an explicit
``torch.Generator``, in the JAX order (``typed_encode``: the tables'
order; ``typed_encode_batch``: sorted type names), or takes injected
masks: ``dropout_masks[layer][type]``.

The decoders read the tables concatenated in global type-offset order
(``concat_tables``), so scoring and evaluation reuse the homogeneous
machinery.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..nn import dropout, dropout_mask
from ..ops.segment import take_rows
from ..ops.segsum import sorted_segment_sum
from ..sampling.typed_batch import TypedBatch, parse_sig
from .encoders import DROPOUT, RGCN


class TypedGraph(NamedTuple):
    """Per-type tables + per-signature edge blocks (numpy on the host, or
    tensors on a device after ``typed_to_device``)."""

    type_names: List[str]                       # insertion order == global
    x: Dict[str, np.ndarray]                    # type → (N_t, D)
    counts: Dict[str, np.ndarray]               # type → (N_t, R) real counts
    # signature (head_type, rel_id, tail_type) → (src_local, dst_local)
    sigs: Dict[Tuple[str, int, str], Tuple[np.ndarray, np.ndarray]]
    type_offset: Dict[str, int]
    num_relations: int

    @property
    def num_nodes(self) -> int:
        return sum(v.shape[0] for v in self.x.values())


def to_typed(g, type_offset: Dict[str, int], node_type_of) -> TypedGraph:
    """Split a CSRGraph ``g`` (a TripletGraph's ``graph``, ``type_offset``
    and ``node_type_of``) into typed tables + signature blocks; each
    block's ``dst_local`` ascends."""
    names = [t for t in sorted(type_offset, key=type_offset.get)]
    sizes = {}
    for i, t in enumerate(names):
        nxt = (type_offset[names[i + 1]] if i + 1 < len(names)
               else g.num_nodes)
        sizes[t] = nxt - type_offset[t]
    x = {t: g.x[type_offset[t]:type_offset[t] + sizes[t]] for t in names}

    src, dst, et = g.edge_index[0], g.edge_index[1], g.edge_type
    type_of = np.asarray(node_type_of)
    counts = {t: np.zeros((sizes[t], g.num_relations), np.float32)
              for t in names}
    sigs: Dict[Tuple[str, int, str], Tuple[np.ndarray, np.ndarray]] = {}
    # one integer composite key and one sort, not T²·R full-edge scans
    T, R = len(names), g.num_relations
    code = ((type_of[src].astype(np.int64) * T + type_of[dst]) * R
            + et)
    order = np.argsort(code, kind="stable")
    sc = code[order]
    if len(sc):
        bounds = np.concatenate([[0], np.nonzero(np.diff(sc))[0] + 1,
                                 [len(sc)]])
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            c = int(sc[lo])
            r, td, ts = c % R, (c // R) % T, c // (R * T)
            s_name, t_name = names[ts], names[td]
            idx = order[lo:hi]
            sl = (src[idx] - type_offset[s_name]).astype(np.int32)
            dl = (dst[idx] - type_offset[t_name]).astype(np.int32)
            o2 = np.argsort(dl, kind="stable")
            sigs[(s_name, r, t_name)] = (sl[o2], dl[o2])
            np.add.at(counts[t_name], (dl, r), 1.0)
    return TypedGraph(type_names=names, x=x, counts=counts, sigs=sigs,
                      type_offset=dict(type_offset),
                      num_relations=g.num_relations)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _tables_to_device(tables, device) -> dict:
    """The float32 features and counts of a TypedGraph or TypedBatch."""
    return {"x": {t: _f32(v, device) for t, v in tables.x.items()},
            "counts": {t: _f32(v, device) for t, v in tables.counts.items()}}


def typed_to_device(typed: TypedGraph, device) -> TypedGraph:
    """The tables and blocks as tensors on ``device``: float32 features and
    counts, int64 ``src_local``, int32 ``dst_local`` (the segsum's ids)."""
    return typed._replace(
        **_tables_to_device(typed, device),
        sigs={k: (torch.as_tensor(sl, device=device).long(),
                  torch.as_tensor(dl, device=device).to(torch.int32))
              for k, (sl, dl) in typed.sigs.items()})


def typed_batch_to_device(batch: TypedBatch, device) -> TypedBatch:
    """A TypedBatch with what the encode and the loss read as tensors on
    ``device``: float32 features and counts, each block's rows as
    ``(src_local int64, dst_local int32, mask float32)``, ``pos`` int64
    (its mask row 0/1); ``nodes`` and ``num_nodes`` stay on the host."""
    return batch._replace(
        **_tables_to_device(batch, device),
        sigs={k: (torch.as_tensor(b[0], device=device).long(),
                  torch.as_tensor(b[1], device=device).to(torch.int32),
                  _f32(b[2], device))
              for k, b in batch.sigs.items()},
        pos=torch.as_tensor(batch.pos, device=device).long())


def _layers(encoder: RGCN):
    if not isinstance(encoder, RGCN):
        raise ValueError(f"typed tables run the RGCN stack, got "
                         f"{type(encoder).__name__}")
    return [(lp.w_rel.float(), lp.w_root.float(), lp.b.float())
            for lp in encoder.layers]


def _typed_dropout(out: Dict[str, torch.Tensor], order, li: int,
                   generator: Optional[torch.Generator], dropout_masks):
    """Inverted dropout of each table after hidden conv ``li``, the masks
    injected or drawn in ``order``."""
    for t in order:
        if dropout_masks is not None:
            keep = dropout_masks[li][t]
        elif generator is not None:
            keep = dropout_mask(out[t].shape, DROPOUT, generator,
                                out[t].device)
        else:
            raise ValueError("training dropout needs a torch.Generator or "
                             "injected masks")
        out[t] = dropout(out[t], keep, DROPOUT)


def _encode(layers, xs, blocks, counts, *, dropout_order, training,
            drop_out, generator, dropout_masks):
    """The typed RGCN stack over ``blocks``: (s_t, r, t_t, src_local,
    dst_local, mask or None) per signature."""
    xs = {t: v.float() for t, v in xs.items()}
    for li, (w_rel, w_root, b) in enumerate(layers):
        out = {t: x @ w_root + b for t, x in xs.items()}
        for s_t, r, t_t, sl, dl, m in blocks:
            # one dense product and one sorted segment-sum per signature
            msg = torch.matmul(take_rows(xs[s_t], sl), w_rel[r])
            if m is not None:
                msg = msg * m[:, None]
            agg = sorted_segment_sum(msg, dl, xs[t_t].shape[0])
            cnt = counts[t_t][:, r]
            out[t_t] = out[t_t] + agg / cnt.clamp(min=1.0)[:, None]
        if li < len(layers) - 1:
            out = {t: torch.relu(v) for t, v in out.items()}
            if drop_out and training:
                _typed_dropout(out, dropout_order(out), li, generator,
                               dropout_masks)
        xs = out
    return xs


def typed_encode(encoder: RGCN, typed: TypedGraph, *,
                 training: bool = False, drop_out: bool = False,
                 generator: Optional[torch.Generator] = None,
                 dropout_masks=None) -> Dict[str, torch.Tensor]:
    """The RGCN stack over a device TypedGraph (``typed_to_device``) →
    {type: (N_t, out_dim) float32}."""
    blocks = [(s_t, r, t_t, sl, dl, None)
              for (s_t, r, t_t), (sl, dl) in typed.sigs.items()]
    return _encode(_layers(encoder), typed.x, blocks, typed.counts,
                   dropout_order=list, training=training,
                   drop_out=drop_out, generator=generator,
                   dropout_masks=dropout_masks)


def concat_tables(tables: Dict[str, torch.Tensor],
                  type_names: List[str]) -> torch.Tensor:
    """Typed tables → homogeneous (N, d) in global type-offset order (the
    order the decoders and evaluators read)."""
    return torch.cat([tables[t] for t in type_names], dim=0)


def typed_encode_batch(encoder: RGCN, batch: TypedBatch, *,
                       training: bool = False, drop_out: bool = False,
                       generator: Optional[torch.Generator] = None,
                       dropout_masks=None) -> Dict[str, torch.Tensor]:
    """The RGCN stack over one device TypedBatch
    (``typed_batch_to_device``): per-signature masked blocks and the
    batch's (dst, rel) mean normalisation → {type: (B_t, out_dim)}."""
    blocks = []
    for key, (sl, dl, m) in batch.sigs.items():
        s_t, r, t_t = parse_sig(key)
        blocks.append((s_t, r, t_t, sl, dl, m))
    return _encode(_layers(encoder), batch.x, blocks, batch.counts,
                   dropout_order=sorted, training=training,
                   drop_out=drop_out, generator=generator,
                   dropout_masks=dropout_masks)
