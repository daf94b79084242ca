"""PrimeKG dataset (counterpart of biomedkg_tpu/data/primekg.py).

Only the synthetic PrimeKG-schema graph is ported: the reference's other
sources (the TDC resource, a local or downloaded ``kg.csv``, the
``BIOMEDKG_KG_CSV`` on-ramp) read csv through pandas, which the port does
not depend on, and wait for the csv-loading slice (ROADMAP.md queue 1).
A run that would have read one of them raises instead of silently
serving the synthetic graph. ``BIOMEDKG_SYNTHETIC_SCALE=primekg`` selects
the PrimeKG++-scale graph, as in the reference.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, List, Optional

import numpy as np

from .synthetic import Triplets, synthetic_triplets
from .triplet import TripletGraph


def _load_columns(data_dir: str) -> Triplets:
    user = os.environ.get("BIOMEDKG_KG_CSV")
    csv_path = os.path.join(data_dir, "kg.csv")
    if user or os.path.exists(csv_path):
        raise NotImplementedError(
            f"PrimeKG csv loading ({user or csv_path}) is not ported yet "
            "(ROADMAP.md queue 1: csv/TDC sources); the port serves the "
            "synthetic PrimeKG-schema graph only")
    print("[biomedkg_tpu_torch] using the synthetic PrimeKG-schema graph",
          file=sys.stderr)
    if os.environ.get("BIOMEDKG_SYNTHETIC_SCALE") == "primekg":
        # PrimeKG++-scale: node/edge counts of the real dataset filtered
        # to gene/drug/disease
        return synthetic_triplets(num_gene=27000, num_drug=8000,
                                  num_disease=17000, num_edges=1_300_000,
                                  seed=42)
    return synthetic_triplets(seed=42)


class PrimeKG(TripletGraph):
    def __init__(self, data_dir: str, node_type: Optional[List[str]] = None,
                 encoder: Optional[Callable] = None):
        columns = _load_columns(data_dir)
        if node_type:
            keep = (np.isin(columns["x_type"], node_type)
                    & np.isin(columns["y_type"], node_type))
            columns = {k: v[keep] for k, v in columns.items()}
        super().__init__(columns=columns, encoder=encoder)
