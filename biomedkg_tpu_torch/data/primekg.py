"""PrimeKG dataset (counterpart of biomedkg_tpu/data/primekg.py).

The triplets come, in the reference's order, from the csv that
``BIOMEDKG_KG_CSV`` names (``user_supplied_csv``: it must exist, match
``BIOMEDKG_KG_CSV_SHA256`` when that is set, and hold the columns in
``_REQUIRED_COLUMNS``), then from a ``kg.csv`` in ``data_dir`` (its header
checked the same way), else from the synthetic PrimeKG-schema graph
(``BIOMEDKG_SYNTHETIC_SCALE=primekg`` selects the PrimeKG++-scale one).
Both csv sources are read without pandas (data/csv_columns.py). Not
ported: the TDC resource and the download of ``kg.csv``, which need the
network; without them the JAX package falls through to the same sources.

A missing field in one of the five columns the graph is built from, on a
row the node-type filter keeps, raises ``ValueError`` naming the row (the
JAX package raises on such a row too, or builds a graph with a NaN node).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, FrozenSet, List, Optional

import numpy as np

from .csv_columns import CsvColumns, read_csv_columns, read_header, sha256
from .synthetic import COLUMNS, Triplets, synthetic_triplets
from .triplet import TripletGraph

# the columns TripletBase consumes (reference _base.py:23-87)
_REQUIRED_COLUMNS = frozenset({"x_type", "x_name", "y_type", "y_name",
                               "relation", "display_relation"})


def user_supplied_csv(env_key: str,
                      required_columns: FrozenSet[str] = frozenset()
                      ) -> Optional[str]:
    """The csv ``$<env_key>`` names, or None when it is unset: it must
    exist, match ``$<env_key>_SHA256`` when that is set, and its header
    must hold ``required_columns``."""
    path = os.environ.get(env_key)
    if not path:
        return None
    if not os.path.exists(path):
        raise FileNotFoundError(f"{env_key}={path!r} does not exist")
    want = os.environ.get(env_key + "_SHA256")
    if want:
        got = sha256(path)
        if got.lower() != want.lower():
            raise ValueError(f"{env_key} checksum mismatch: file {got}, "
                             f"expected {want}")
    header = set(read_header(path))
    missing = set(required_columns) - header
    if missing:
        raise ValueError(
            f"{env_key}={path!r} lacks required columns {sorted(missing)}; "
            f"found {sorted(header)}")
    return path


def _load_csv_columns(data_dir: str) -> Optional[CsvColumns]:
    """The csv source's columns, or None when there is none."""
    user = user_supplied_csv("BIOMEDKG_KG_CSV", _REQUIRED_COLUMNS)
    if user:
        print(f"[biomedkg_tpu_torch] PrimeKG csv from BIOMEDKG_KG_CSV={user}",
              file=sys.stderr)
        return read_csv_columns(user, COLUMNS)
    csv_path = os.path.join(data_dir, "kg.csv")
    if not os.path.exists(csv_path):
        return None
    header = set(read_header(csv_path))
    if not _REQUIRED_COLUMNS <= header:
        raise ValueError(
            f"cached {csv_path} lacks required columns "
            f"{sorted(_REQUIRED_COLUMNS - header)} — delete it or set "
            "BIOMEDKG_KG_CSV")
    return read_csv_columns(csv_path, COLUMNS)


def _synthetic_columns() -> Triplets:
    print("[biomedkg_tpu_torch] PrimeKG csv unavailable; using the "
          "synthetic PrimeKG-schema graph", file=sys.stderr)
    if os.environ.get("BIOMEDKG_SYNTHETIC_SCALE") == "primekg":
        # PrimeKG++-scale: node/edge counts of the real dataset filtered
        # to gene/drug/disease
        return synthetic_triplets(num_gene=27000, num_drug=8000,
                                  num_disease=17000, num_edges=1_300_000,
                                  seed=42)
    return synthetic_triplets(seed=42)


def refuse_missing(table: CsvColumns, rows: np.ndarray,
                   what: str) -> Triplets:
    """The columns of ``table``'s data rows ``rows``, or ``ValueError``
    naming the first of them with a missing field."""
    bad = np.zeros(len(rows), bool)
    for mask in table.na.values():
        bad |= mask[rows]
    if bad.any():
        row = int(rows[np.flatnonzero(bad)[0]])
        cols = [c for c, m in table.na.items() if m[row]]
        raise ValueError(f"{what}: data row {row + 1} has no value in "
                         f"{cols}; the graph cannot be built from it")
    return {c: v[rows] for c, v in table.columns.items()}


class PrimeKG(TripletGraph):
    def __init__(self, data_dir: str, node_type: Optional[List[str]] = None,
                 encoder: Optional[Callable] = None):
        table = _load_csv_columns(data_dir)
        if table is None:
            columns = _synthetic_columns()
            keep = (np.ones(len(columns["x_type"]), bool) if not node_type
                    else np.isin(columns["x_type"], node_type)
                    & np.isin(columns["y_type"], node_type))
            columns = {k: v[keep] for k, v in columns.items()}
        else:
            if node_type:
                # a missing type is in no list (pandas' isin of NaN)
                keep = (np.isin(table.columns["x_type"], node_type)
                        & ~table.na["x_type"]
                        & np.isin(table.columns["y_type"], node_type)
                        & ~table.na["y_type"])
                rows = np.flatnonzero(keep)
            else:
                rows = np.arange(len(table.columns["x_type"]))
            columns = refuse_missing(table, rows, "PrimeKG csv")
        super().__init__(columns=columns, encoder=encoder)
