"""Typed-table GraphSAINT sub-batches (counterpart of
biomedkg_tpu/sampling/typed_batch.py, host numpy: the same arrays for the
same seed).

Each batch carries one fixed-size node table per node type and one
fixed-size edge block per (head_type, relation, tail_type) signature, so
every block is single-relation and single-src/dst-type: the conv is a
dense (E_s, d) @ (d, d) product plus one sorted segment-sum into that
type's table (models/typed.py). The budgets (per-type nodes,
per-signature edges, supervision edges) are probed once and shared by
every batch. The induced subgraph, its per-(dst, rel) mean normalisation
and the "batch edges are both message passing and supervision" protocol
match the homogeneous SAINT path.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from .csr import CSRGraph
from .saint import _round_up, random_walk


def sig_key(s_t: str, r: int, t_t: str) -> str:
    return f"{s_t}|{int(r)}|{t_t}"


def parse_sig(key: str) -> Tuple[str, int, str]:
    s_t, r, t_t = key.split("|")
    return s_t, int(r), t_t


class TypedBatch(NamedTuple):
    """One padded typed sub-batch (host side; dict keys and array shapes
    are identical across batches)."""

    x: Dict[str, np.ndarray]          # type → (B_t, D) features (pads: 0)
    nodes: Dict[str, np.ndarray]      # type → (B_t,) global ids (pads: 0)
    num_nodes: Dict[str, np.ndarray]  # type → () int32 real count
    counts: Dict[str, np.ndarray]     # type → (B_t, R) (dst, rel) counts
    # sig "s|r|t" → (3, E_s) int32 rows [src_local, dst_local (sorted),
    # mask]; pad slots repeat the last real row with mask 0
    sigs: Dict[str, np.ndarray]
    # supervision edges in BATCH-GLOBAL ids (type-blocked concat order,
    # type t's block starting at sum of earlier types' budgets):
    # (4, P) int32 rows [src_bg, dst_bg, rel, mask]
    pos: np.ndarray

    @property
    def type_names(self) -> List[str]:
        return list(self.x.keys())


class TypedSaintSampler:
    """GraphSAINT random-walk batches split into typed tables + blocks.

    ``graph`` is the (homogeneous-id) split graph; ``node_type_of`` /
    ``type_names`` come from the dataset (data/triplet.py). The static
    signature vocabulary is taken from ``sig_graph`` (largest split) so
    every batch shares one envelope.
    """

    def __init__(self, graph: CSRGraph, node_type_of: np.ndarray,
                 type_names: List[str], batch_size: int, walk_length: int,
                 num_steps: int, seed: int = 0,
                 sig_graph: CSRGraph | None = None,
                 budgets: dict | None = None):
        self.graph = graph
        self.node_type_of = np.asarray(node_type_of, np.int32)
        self.type_names = list(type_names)
        self.batch_size = batch_size
        self.walk_length = walk_length
        self.num_steps = num_steps
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.dropped_edges = 0

        sg = sig_graph if sig_graph is not None else graph
        self._sig_keys = self._signatures(sg)
        self._type_idx = {t: i for i, t in enumerate(self.type_names)}
        if budgets is None:
            budgets = self.probe_budgets(seed)
        self.node_budget: Dict[str, int] = budgets["nodes"]
        self.sig_budget: Dict[str, int] = budgets["sigs"]
        self.pos_budget: int = budgets["pos"]
        # batch-global offset of each type's block in concat order
        self.type_base: Dict[str, int] = {}
        off = 0
        for t in self.type_names:
            self.type_base[t] = off
            off += self.node_budget[t]
        self.total_budget = off

    # -- static structure --------------------------------------------------

    def _signatures(self, g: CSRGraph) -> List[str]:
        st = self.node_type_of[g.edge_index[0]]
        dt = self.node_type_of[g.edge_index[1]]
        T = len(self.type_names)
        code = (st.astype(np.int64) * T + dt) * g.num_relations + g.edge_type
        keys = []
        for c in np.unique(code):
            r = int(c % g.num_relations)
            td = int((c // g.num_relations) % T)
            ts = int(c // (g.num_relations * T))
            keys.append(sig_key(self.type_names[ts], r,
                                self.type_names[td]))
        return keys

    def probe_budgets(self, seed: int, probes: int = 8) -> dict:
        rng = np.random.default_rng(seed + 104729)
        worst_nodes = {t: 1 for t in self.type_names}
        worst_sig = {k: 1 for k in self._sig_keys}
        worst_pos = 1
        for _ in range(probes):
            nodes, ei, et = self._sample_raw(rng)
            t_of = self.node_type_of[nodes]
            for ti, t in enumerate(self.type_names):
                worst_nodes[t] = max(worst_nodes[t], int((t_of == ti).sum()))
            st, dt = t_of[ei[0]], t_of[ei[1]]
            T = len(self.type_names)
            code = (st.astype(np.int64) * T + dt) * \
                self.graph.num_relations + et
            vals, cnts = np.unique(code, return_counts=True)
            for c, n in zip(vals, cnts):
                r = int(c % self.graph.num_relations)
                td = int((c // self.graph.num_relations) % T)
                ts = int(c // (self.graph.num_relations * T))
                k = sig_key(self.type_names[ts], r, self.type_names[td])
                if k in worst_sig:
                    worst_sig[k] = max(worst_sig[k], int(n))
            worst_pos = max(worst_pos, int(et.shape[0]))
        return {
            "nodes": {t: _round_up(int(v * 1.5), 8)
                      for t, v in worst_nodes.items()},
            "sigs": {k: _round_up(int(v * 1.5), 8)
                     for k, v in worst_sig.items()},
            "pos": _round_up(int(worst_pos * 1.5), 128),
        }

    # -- sampling ----------------------------------------------------------

    def _sample_raw(self, rng: np.random.Generator):
        roots = rng.integers(0, self.graph.num_nodes, self.batch_size)
        walks = random_walk(self.graph, roots, self.walk_length, rng)
        nodes = np.unique(walks)
        ei, et = self.graph.induced_subgraph(nodes)  # batch-local ids
        return nodes, ei, et

    def sample(self) -> TypedBatch:
        nodes, ei, et = self._sample_raw(self.rng)
        return self.split(nodes, ei, et)

    def split(self, nodes: np.ndarray, ei: np.ndarray,
              et: np.ndarray) -> TypedBatch:
        """Split a (sorted-unique nodes, batch-local edges) subgraph into
        the typed static envelope."""
        g = self.graph
        R = g.num_relations
        T = len(self.type_names)
        t_of = np.asarray(self.node_type_of[nodes], np.int32)

        # per-type local position of every batch node; node overflow is an
        # ERROR, matching pad_graph_batch's contract (silent head-drops
        # would bias every overflowing batch against the same high-id
        # nodes — re-probe or pass explicit budgets instead)
        local = np.zeros(len(nodes), np.int32)
        for ti, t in enumerate(self.type_names):
            sel = t_of == ti
            cnt = int(sel.sum())
            if cnt > self.node_budget[t]:
                raise ValueError(
                    f"type {t!r} overflowed its probed node budget "
                    f"({cnt} > {self.node_budget[t]}); re-probe with a "
                    "larger margin or pass budgets= explicitly")
            local[sel] = np.arange(cnt, dtype=np.int32)

        x_t, id_t, num_t, cnt_t = {}, {}, {}, {}
        for ti, t in enumerate(self.type_names):
            B = self.node_budget[t]
            sel = np.flatnonzero(t_of == ti)
            ids = np.zeros(B, np.int32)
            ids[: len(sel)] = nodes[sel]
            feats = np.zeros((B,) + (g.x.shape[1:] if g.x is not None
                                     else (1,)), np.float32)
            if g.x is not None and len(sel):
                feats[: len(sel)] = g.x[nodes[sel]]
            x_t[t] = feats
            id_t[t] = ids
            num_t[t] = np.int32(len(sel))
            cnt_t[t] = np.zeros((B, R), np.float32)

        # edge split by signature: one argsort + per-sig searchsorted
        # (a per-sig full scan is O(S·E) on the per-step host hot path)
        st, dt = t_of[ei[0]], t_of[ei[1]]
        sl, dl = local[ei[0]], local[ei[1]]
        code = (st.astype(np.int64) * T + dt) * R + et
        order_all = np.argsort(code, kind="stable")
        sc = code[order_all]
        kept = np.zeros(et.shape[0], bool)
        sigs: Dict[str, np.ndarray] = {}
        for k in self._sig_keys:
            s_name, r, t_name = parse_sig(k)
            ts = self._type_idx[s_name]
            td = self._type_idx[t_name]
            c = (np.int64(ts) * T + td) * R + r
            lo = np.searchsorted(sc, c, "left")
            hi = np.searchsorted(sc, c, "right")
            sel = order_all[lo:hi]
            E = self.sig_budget[k]
            if len(sel) > E:
                # uniform random subset — same unbiasedness contract as
                # pad_graph_batch's edge subsampling
                sel = self.rng.choice(sel, E, replace=False)
            blk = np.zeros((3, E), np.int32)
            if len(sel):
                order = np.argsort(dl[sel], kind="stable")
                blk[0, : len(sel)] = sl[sel][order]
                blk[1, : len(sel)] = dl[sel][order]
                blk[2, : len(sel)] = 1
                blk[0, len(sel):] = blk[0, len(sel) - 1]
                blk[1, len(sel):] = blk[1, len(sel) - 1]
                np.add.at(cnt_t[t_name], (dl[sel], et[sel]), 1.0)
                kept[sel] = True
            sigs[k] = blk
        # everything not kept — sig-budget overflow AND edges of
        # signatures absent from the static vocabulary — is dropped from
        # BOTH message passing and supervision (an edge the encoder never
        # propagated must not be trained on)
        self.dropped_edges += int(et.shape[0] - kept.sum())

        # supervision edges in batch-global (type-blocked) coordinates
        base = np.asarray([self.type_base[self.type_names[i]]
                           for i in range(T)], np.int32)
        keep = np.flatnonzero(kept)
        if len(keep) > self.pos_budget:
            self.dropped_edges += len(keep) - self.pos_budget
            keep = np.sort(self.rng.choice(keep, self.pos_budget,
                                           replace=False))
        pos = np.zeros((4, self.pos_budget), np.int32)
        if len(keep):
            pos[0, : len(keep)] = base[st[keep]] + sl[keep]
            pos[1, : len(keep)] = base[dt[keep]] + dl[keep]
            pos[2, : len(keep)] = et[keep]
            pos[3, : len(keep)] = 1
            pos[0, len(keep):] = pos[0, len(keep) - 1]
            pos[1, len(keep):] = pos[1, len(keep) - 1]
            pos[2, len(keep):] = pos[2, len(keep) - 1]
        return TypedBatch(x=x_t, nodes=id_t, num_nodes=num_t,
                          counts=cnt_t, sigs=sigs, pos=pos)

    def flat_real(self, batch: TypedBatch) -> Tuple[np.ndarray, np.ndarray]:
        """(total_budget,) batch-global ids of REAL nodes, cyclically
        repeated past num_real — the negative-corruption support — plus
        the scalar real count."""
        ids = []
        for t in self.type_names:
            n = int(batch.num_nodes[t])
            ids.append(self.type_base[t] + np.arange(n, dtype=np.int32))
        real = np.concatenate(ids) if ids else np.zeros(1, np.int32)
        n_real = max(len(real), 1)
        reps = -(-self.total_budget // n_real)
        flat = np.tile(real, reps)[: self.total_budget]
        return flat, np.int32(n_real)

    def set_epoch(self, epoch: int):
        self.rng = np.random.default_rng((self.seed, epoch))

    def __iter__(self):
        for _ in range(self.num_steps):
            yield self.sample()

    def __len__(self):
        return self.num_steps
