"""The benchmark's graph and node features, made from numbers alone.

``primekg_edges`` is a frozen copy of the PrimeKG++-schema generator
(``data/synthetic.py::synthetic_triplets`` of the program): the same eight
relation signatures and shares, the same power-law endpoint draws and the
same first-occurrence de-duplication, written on integer ids. A later
change to the program's generator cannot move the benchmark's graph.

Node ids follow the rule the program's triplet layer states for any
triplet table: node types in sorted order, each type one contiguous id
range, its nodes that occur in some row in the order of their names. The
benchmark names a node by its index within its type (an integer), so the
id order is the index order, and ``triplet_columns`` hands the program
those integer names. Relation ids are first-appearance order, which is the
signature order below, since the rows come grouped by relation.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, NamedTuple

import numpy as np
import torch

# (relation, x_type, y_type, relative edge share)
RELATIONS = [
    ("protein_protein", "gene/protein", "gene/protein", 0.55),
    ("drug_protein", "drug", "gene/protein", 0.06),
    ("contraindication", "drug", "disease", 0.04),
    ("indication", "drug", "disease", 0.02),
    ("off-label use", "drug", "disease", 0.01),
    ("drug_drug", "drug", "drug", 0.25),
    ("disease_protein", "disease", "gene/protein", 0.06),
    ("disease_disease", "disease", "disease", 0.01),
]


class Graph(NamedTuple):
    """Edges in the program's id space, rows grouped by relation."""
    src: np.ndarray          # (E,) int64
    dst: np.ndarray          # (E,) int64
    rel: np.ndarray          # (E,) int64
    num_nodes: int
    num_relations: int
    type_names: List[str]    # sorted
    type_offset: Dict[str, int]
    type_index: Dict[str, np.ndarray]   # id - offset -> index in its type
    relation_names: List[str]           # by relation id


def _power_law(rng, n: int, size: int, alpha: float = 0.8) -> np.ndarray:
    w = (1.0 + np.arange(n)) ** (-alpha)
    w /= w.sum()
    return rng.choice(n, size=size, p=w)


def primekg_edges(sizes: Dict[str, int], num_edges: int, seed: int,
                  node_types: List[str]) -> Graph:
    """The PrimeKG++-schema graph over ``node_types``: each relation's
    int(num_edges·share) draws, duplicates of (head, relation, tail)
    dropped (the first kept), then the rows whose types are both in
    ``node_types``; nodes that occur in no kept row get no id."""
    rng = np.random.default_rng(seed)
    shares = np.array([r[3] for r in RELATIONS], np.float64)
    shares /= shares.sum()
    types = sorted(sizes)
    type_code = {t: i for i, t in enumerate(types)}
    width = max(sizes.values())
    heads, tails, rels, keys = [], [], [], []
    for code, ((_, xt, yt, _), share) in enumerate(zip(RELATIONS, shares)):
        m = max(1, int(num_edges * share))
        h = _power_law(rng, sizes[xt], m)
        t = _power_law(rng, sizes[yt], m)
        heads.append(h + type_code[xt] * width)
        tails.append(t + type_code[yt] * width)
        rels.append(np.full(m, code, np.int64))
        keys.append((heads[-1] * len(RELATIONS) + code) * (len(types) * width)
                    + tails[-1])
    _, first = np.unique(np.concatenate(keys), return_index=True)
    first.sort()
    head = np.concatenate(heads)[first]
    tail = np.concatenate(tails)[first]
    rel = np.concatenate(rels)[first]
    keep_codes = [type_code[t] for t in node_types]
    keep = np.isin(head // width, keep_codes) & np.isin(tail // width,
                                                         keep_codes)
    head, tail, rel = head[keep], tail[keep], rel[keep]
    # relation ids in first-appearance order among the kept rows
    present, first_row = np.unique(rel, return_index=True)
    order = present[np.argsort(first_row)]
    remap = np.full(len(RELATIONS), -1, np.int64)
    remap[order] = np.arange(len(order))
    rel = remap[rel]
    # node ids: kept types in sorted order, occurring nodes by index
    ids = np.full(len(types) * width, -1, np.int64)
    offset, type_offset, type_index, kept_types = 0, {}, {}, []
    occurs = np.zeros(len(types) * width, bool)
    occurs[head] = True
    occurs[tail] = True
    for t in types:
        if t not in node_types:
            continue
        base = type_code[t] * width
        idx = np.flatnonzero(occurs[base:base + sizes[t]])
        ids[base + idx] = offset + np.arange(len(idx))
        type_offset[t] = offset
        type_index[t] = idx
        kept_types.append(t)
        offset += len(idx)
    return Graph(ids[head], ids[tail], rel, offset, len(order), kept_types,
                 type_offset, type_index, [RELATIONS[c][0] for c in order])


def triplet_columns(graph: Graph) -> Dict[str, np.ndarray]:
    """The graph as the program's triplet columns: types as strings,
    relation names, and each node named by its integer index within its
    type, so the program's id rule gives back ``graph``'s ids."""
    type_of = np.empty(graph.num_nodes, object)
    index_of = np.empty(graph.num_nodes, np.int64)
    for t in graph.type_names:
        lo = graph.type_offset[t]
        n = len(graph.type_index[t])
        type_of[lo:lo + n] = t
        index_of[lo:lo + n] = graph.type_index[t]
    names = np.array(graph.relation_names)
    type_of = type_of.astype(str)
    return {"x_type": type_of[graph.src], "x_name": index_of[graph.src],
            "relation": names[graph.rel], "y_type": type_of[graph.dst],
            "y_name": index_of[graph.dst]}


def edge_keys(src, dst, rel, num_nodes: int, num_relations: int):
    """One int64 key per (src, rel, dst)."""
    return (np.asarray(src, np.int64) * num_relations + rel) * num_nodes \
        + np.asarray(dst, np.int64)


def link_split(num_edges: int, val_ratio: float, test_ratio: float,
               seed: int) -> np.ndarray:
    """The indices of the train edges of the reference's deterministic
    link split (PyG RandomLinkSplit semantics): a permutation from
    ``numpy.random.default_rng(seed)``, val first, test next, train the
    rest."""
    perm = np.random.default_rng(seed).permutation(num_edges)
    n_val = int(num_edges * val_ratio)
    n_test = int(num_edges * test_ratio)
    return perm[n_val + n_test:]


def node_features(num_nodes: int, dim: int, seed: int,
                  device) -> torch.Tensor:
    """(N, dim) float32 features, xavier-normal as the reference's random
    node initialisation draws them, in one call on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, "features"))
    std = (2.0 / (num_nodes + dim)) ** 0.5
    return torch.randn(num_nodes, dim, generator=gen, device=device) * std


def seed_of(seed: int, *purpose) -> int:
    """A 63-bit seed for one purpose of a run (a name and numbers), from
    the run's seed, which may be any whole number of up to 64 bits."""
    digest = hashlib.sha256(repr(purpose).encode()).digest()
    words = [int(seed) % 2**32, int(seed) // 2**32 % 2**32]
    words += np.frombuffer(digest[:16], np.uint32).tolist()
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) | (int(state[1]) >> 1)
