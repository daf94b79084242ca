"""Host-side multi-relational graph in CSR form (counterpart of
biomedkg_tpu/sampling/csr.py): the CSR builds and ``induced_subgraph``
through the native library (sampling/native/), with the reference's
vectorised numpy fallback. Both give the reference's arrays exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import native


def ranges_concat(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenate [starts[i], starts[i]+counts[i]) index ranges,
    vectorized."""
    nz = counts > 0
    s = np.asarray(starts, dtype=np.int64)[nz]
    c = np.asarray(counts, dtype=np.int64)[nz]
    if len(s) == 0:
        return np.empty(0, dtype=np.int64)
    total = int(c.sum())
    out = np.ones(total, dtype=np.int64)
    out[0] = s[0]
    if len(s) > 1:
        first_pos = np.cumsum(c)[:-1]   # output index where range i+1 begins
        prev_end = s[:-1] + c[:-1]          # value just past range i
        out[first_pos] = s[1:] - prev_end + 1
    return np.cumsum(out)


@dataclass
class CSRGraph:
    num_nodes: int
    edge_index: np.ndarray          # (2, E) int32/int64
    edge_type: np.ndarray           # (E,) int32
    num_relations: int
    x: Optional[np.ndarray] = None  # (N, D) node features

    _out: Optional[tuple] = field(default=None, repr=False, compare=False)
    _in: Optional[tuple] = field(default=None, repr=False, compare=False)
    # induced_subgraph's reusable id lookup (all -1 between calls)
    _lookup_buf: Optional[np.ndarray] = field(default=None, repr=False,
                                              compare=False)

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    def _build(self, key_row: np.ndarray, other: np.ndarray):
        lib = native.get_lib()
        if lib is not None:
            key = np.ascontiguousarray(key_row, np.int64)
            oth = np.ascontiguousarray(other, np.int64)
            et = np.ascontiguousarray(self.edge_type, np.int32)
            e = key.shape[0]
            indptr = np.empty(self.num_nodes + 1, np.int64)
            nbr = np.empty(e, np.int64)
            et_out = np.empty(e, np.int32)
            perm = np.empty(e, np.int64)
            lib.build_csr(native.i64(key), native.i64(oth), native.i32(et),
                          e, self.num_nodes, native.i64(indptr),
                          native.i64(nbr), native.i32(et_out),
                          native.i64(perm))
            return indptr, nbr, et_out, perm
        order = np.argsort(key_row, kind="stable")
        sorted_key = key_row[order]
        indptr = np.zeros(self.num_nodes + 1, dtype=np.int64)
        np.add.at(indptr, sorted_key + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, other[order].astype(np.int64), \
            self.edge_type[order].astype(np.int32), order

    def out_csr(self):
        """(indptr, neighbors, etypes, edge_perm) keyed by source node."""
        if self._out is None:
            self._out = self._build(self.edge_index[0], self.edge_index[1])
        return self._out

    def in_csr(self):
        """(indptr, neighbors, etypes, edge_perm) keyed by destination node."""
        if self._in is None:
            self._in = self._build(self.edge_index[1], self.edge_index[0])
        return self._in

    def induced_subgraph(self, nodes: np.ndarray):
        """Edges with both endpoints in ``nodes`` (unique), relabelled to
        [0, |nodes|), in CSR-slice order: ((2, E') int32, (E',) int32)."""
        indptr, nbr, etypes, _ = self.out_csr()
        nodes = np.ascontiguousarray(nodes, dtype=np.int64)
        if self._lookup_buf is None:
            self._lookup_buf = np.full(self.num_nodes, -1, np.int64)
        lib = native.get_lib()
        if lib is not None:
            cap = int((indptr[nodes + 1] - indptr[nodes]).sum())
            src = np.empty(max(cap, 1), np.int64)
            dst = np.empty(max(cap, 1), np.int64)
            et = np.empty(max(cap, 1), np.int32)
            m = lib.induced_subgraph(
                native.i64(indptr), native.i64(nbr), native.i32(etypes),
                native.i64(nodes), len(nodes), native.i64(self._lookup_buf),
                native.i64(src), native.i64(dst), native.i32(et), cap)
            ei = np.stack([src[:m], dst[:m]]).astype(np.int32)
            return ei, et[:m]
        starts = indptr[nodes]
        counts = indptr[nodes + 1] - starts
        pos = ranges_concat(starts, counts)
        src_rep = np.repeat(np.arange(len(nodes)), counts)  # local src ids
        dst_all = nbr[pos]
        et_all = etypes[pos]
        lookup = self._lookup_buf
        lookup[nodes] = np.arange(len(nodes))
        dst_local = lookup[dst_all]
        lookup[nodes] = -1  # restore for the next call
        keep = dst_local >= 0
        ei = np.stack([src_rep[keep], dst_local[keep]]).astype(np.int32)
        return ei, et_all[keep]
