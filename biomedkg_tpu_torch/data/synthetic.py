"""Synthetic triplets as numpy columns.

Counterpart of biomedkg_tpu/data/synthetic.py without pandas. A triplet
table is a dict of equal-length numpy string columns (``COLUMNS``). The
generators make the same ``numpy.random.Generator`` calls in the same order
as the reference, and rebuild pandas'
``drop_duplicates(subset=["x_name", "relation", "y_name"])`` (keep the first
row of each key, in row order) with ``np.unique(..., return_index=True)``,
so one seed gives exactly the reference's rows: the PrimeKG++-schema graph
(``synthetic_triplets``), the DPI benchmark's stand-in
(``synthetic_dpi``), the cluster-structured fixture of the unseen-node
protocol (``clustered_triplets``, ``cluster_token``) and the planted
latent-factor graph of the ranking learning check (``planted_triplets``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

COLUMNS = ("x_type", "x_name", "relation", "y_type", "y_name")
Triplets = Dict[str, np.ndarray]

# (relation, x_type, y_type, relative edge share) — the PrimeKG relation
# signatures surviving the gene/drug/disease node-type filter.
PRIMEKG_RELATIONS = [
    ("protein_protein", "gene/protein", "gene/protein", 0.55),
    ("drug_protein", "drug", "gene/protein", 0.06),
    ("contraindication", "drug", "disease", 0.04),
    ("indication", "drug", "disease", 0.02),
    ("off-label use", "drug", "disease", 0.01),
    ("drug_drug", "drug", "drug", 0.25),
    ("disease_protein", "disease", "gene/protein", 0.06),
    ("disease_disease", "disease", "disease", 0.01),
]

# the one relation of the drug-protein-interaction benchmark
DPI_RELATION = [("drug_protein_interaction", "drug", "gene/protein", 1.0)]


def _power_law_targets(rng, n, size, alpha=0.8):
    """Sample node ids with a heavy-tailed preference (hub structure)."""
    w = (1.0 + np.arange(n)) ** (-alpha)
    w /= w.sum()
    return rng.choice(n, size=size, p=w)


def synthetic_triplets_from_schema(sizes, relations, num_edges, seed=0,
                                   name_fn=None) -> Triplets:
    rng = np.random.default_rng(seed)
    if name_fn is None:
        def name_fn(t, i):
            return f"{t.split('/')[0][:4]}_{i:06d}"
    names = {t: np.array([name_fn(t, i) for i in range(n)])
             for t, n in sizes.items()}
    # one integer code per distinct name STRING (names of two types may
    # coincide), so the duplicate key compares strings like pandas does
    vocab, inverse = np.unique(np.concatenate(list(names.values())),
                               return_inverse=True)
    bounds = np.cumsum([0] + [len(v) for v in names.values()])
    name_code = {t: inverse[bounds[i]:bounds[i + 1]]
                 for i, t in enumerate(names)}
    rel_names, rel_code = np.unique([r[0] for r in relations],
                                    return_inverse=True)
    shares = np.array([r[3] for r in relations], dtype=np.float64)
    shares /= shares.sum()

    cols = {c: [] for c in COLUMNS}
    keys = []
    for (rel, xt, yt, _), code, share in zip(relations, rel_code, shares):
        m = max(1, int(num_edges * share))
        src = _power_law_targets(rng, sizes[xt], m)
        dst = _power_law_targets(rng, sizes[yt], m)
        cols["x_type"].append(np.full(m, xt))
        cols["x_name"].append(names[xt][src])
        cols["relation"].append(np.full(m, rel))
        cols["y_type"].append(np.full(m, yt))
        cols["y_name"].append(names[yt][dst])
        keys.append((name_code[xt][src].astype(np.int64) * len(rel_names)
                     + code) * len(vocab) + name_code[yt][dst])
    _, first = np.unique(np.concatenate(keys), return_index=True)
    first.sort()
    return {c: np.concatenate(v)[first] for c, v in cols.items()}


def synthetic_triplets(
    num_gene: int = 2000,
    num_drug: int = 600,
    num_disease: int = 400,
    num_edges: int = 40000,
    relations=None,
    seed: int = 0,
) -> Triplets:
    relations = relations or PRIMEKG_RELATIONS
    sizes = {"gene/protein": num_gene, "drug": num_drug,
             "disease": num_disease}
    return synthetic_triplets_from_schema(
        sizes, relations, num_edges=num_edges, seed=seed,
        name_fn=lambda t, i: f"{t.split('/')[0]}_{i:06d}")


def synthetic_dpi(num_drug: int = 300, num_gene: int = 500,
                  num_edges: int = 4000, seed: int = 1) -> Triplets:
    """Drug-protein interaction triplets over the PrimeKG++ schema's drug
    and gene/protein names (the DPI benchmark's stand-in)."""
    return synthetic_triplets(
        num_gene=num_gene, num_drug=num_drug, num_disease=1,
        num_edges=num_edges, relations=DPI_RELATION, seed=seed)


def _entity_columns(names, heads, tails, relation) -> Triplets:
    """One relation's rows over the single node type "entity"."""
    m = len(heads)
    return {"x_type": np.full(m, "entity"), "x_name": names[heads],
            "relation": np.full(m, relation), "y_type": np.full(m, "entity"),
            "y_name": names[tails]}


def _concat(parts) -> Triplets:
    return {c: np.concatenate([p[c] for p in parts]) for c in COLUMNS}


def clustered_triplets(num_nodes: int = 300, num_clusters: int = 6,
                       num_relations: int = 4, num_edges: int = 6000,
                       seed: int = 0):
    """Cluster-structured graph whose edges follow from node attributes,
    the fixture of the unseen-node protocol (data/inductive.py).

    Nodes get uniform cluster labels; relation ``r`` joins cluster ``c``
    heads to cluster ``(c + shift_r) % C`` tails, shift_r = r % (C - 1) + 1,
    with uniform draws over the allowed pairs; duplicate (head, relation,
    tail) rows keep their first occurrence.

    Returns ``(columns, cluster, features)``: the triplet columns over the
    one node type "entity", the (N,) cluster labels and (N, num_clusters)
    one-hot float32 features in the sorted-name node order.
    """
    rng = np.random.default_rng(seed)
    cluster = rng.integers(0, num_clusters, size=num_nodes)
    names = np.array([f"ent_{i:06d}" for i in range(num_nodes)])
    members = [np.nonzero(cluster == c)[0] for c in range(num_clusters)]

    parts, keys = [], []
    per_rel = max(1, num_edges // num_relations)
    for r in range(num_relations):
        shift = (r % (num_clusters - 1)) + 1
        heads = rng.integers(0, num_nodes, size=per_rel)
        tails = np.empty(per_rel, np.int64)
        for c in range(num_clusters):
            sel = cluster[heads] == c
            tgt = members[(c + shift) % num_clusters]
            if len(tgt) == 0:
                tgt = np.arange(num_nodes)
            tails[sel] = rng.choice(tgt, size=int(sel.sum()))
        parts.append(_entity_columns(names, heads, tails, f"rel_{r}"))
        keys.append((heads.astype(np.int64) * num_relations + r)
                    * num_nodes + tails)
    _, first = np.unique(np.concatenate(keys), return_index=True)
    first.sort()
    columns = {c: v[first] for c, v in _concat(parts).items()}
    feats = np.eye(num_clusters, dtype=np.float32)[cluster]
    return columns, cluster, feats


def cluster_token(cluster_id: int) -> str:
    """The attribute text of a node in ``cluster_id``: letters only, so a
    character-level WordPiece vocabulary keeps clusters apart."""
    word = chr(ord("a") + cluster_id % 26) * (3 + cluster_id // 26)
    return f"cluster {word} marker"


def planted_triplets(num_nodes: int = 400, num_relations: int = 4,
                     latent_dim: int = 8, edges_per_head: int = 4,
                     seed: int = 0):
    """Latent-factor graph with a known filtered-ranking ceiling: node
    factors u_i ~ N(0, I_k)/sqrt(k), relation factors d_r ~ N(0, I_k), and
    the edges of relation r each head's top-``edges_per_head`` tails by the
    DistMult score (u_i * d_r)·u_j (no self-loops). A model that recovers
    (u, d) reaches tail-side filtered MRR 1; chance is about 1/N.

    Returns ``(columns, u)``: the triplet columns over one node type and
    the (N, latent_dim) float32 factors in the sorted-name node order.
    """
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((num_nodes, latent_dim)).astype(np.float32)
    u /= np.sqrt(latent_dim)
    d = rng.standard_normal((num_relations, latent_dim)).astype(np.float32)

    names = np.array([f"ent_{i:06d}" for i in range(num_nodes)])
    parts = []
    for r in range(num_relations):
        scores = (u * d[r]) @ u.T
        np.fill_diagonal(scores, -np.inf)
        tails = np.argpartition(-scores, edges_per_head,
                                axis=1)[:, :edges_per_head]
        heads = np.repeat(np.arange(num_nodes), edges_per_head)
        parts.append(_entity_columns(names, heads, tails.reshape(-1),
                                     f"rel_{r}"))
    return _concat(parts), u
