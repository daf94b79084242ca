"""Synthetic PrimeKG++-schema triplets as numpy columns.

Counterpart of biomedkg_tpu/data/synthetic.py without pandas. A triplet
table is a dict of equal-length numpy string columns (``COLUMNS``). The
generator makes the same ``numpy.random.Generator`` calls in the same order
as the reference, and rebuilds pandas'
``drop_duplicates(subset=["x_name", "relation", "y_name"])`` (keep the first
row of each key, in row order) with ``np.unique(..., return_index=True)``,
so one seed gives exactly the reference's rows.
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
