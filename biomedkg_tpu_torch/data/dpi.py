"""DrugBank drug-protein-interaction dataset (counterpart of
biomedkg_tpu/data/dpi.py).

The triplets come from the csv ``BIOMEDKG_DPI_CSV`` names
(``user_supplied_csv``: it must exist, match ``BIOMEDKG_DPI_CSV_SHA256``
when that is set, and hold ``_DPI_COLUMNS``), else from the csv at
``data_dir`` (a file path, configs/data/dpi.yaml's
``./data/dpi/dpi_benchmark.csv``), else from ``synthetic_dpi(seed=43)``.
As the reference's ``dropna()``, every row with a missing field in any
column of the file is dropped (data/csv_columns.py reads pandas' NA
tokens as missing); ``dropped_rows`` holds their 0-based data-row
indices.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Optional

import numpy as np

from .csv_columns import read_csv_columns
from .primekg import user_supplied_csv
from .synthetic import COLUMNS, synthetic_dpi
from .triplet import TripletGraph

_DPI_COLUMNS = frozenset({"x_type", "x_name", "y_type", "y_name",
                          "relation"})


class DPI(TripletGraph):
    def __init__(self, data_dir: str, encoder: Optional[Callable] = None):
        path = user_supplied_csv("BIOMEDKG_DPI_CSV", _DPI_COLUMNS)
        if path:
            print(f"[biomedkg_tpu_torch] DPI csv from "
                  f"BIOMEDKG_DPI_CSV={path}", file=sys.stderr)
        elif os.path.exists(data_dir):
            path = data_dir
        if path:
            table = read_csv_columns(path, COLUMNS, any_na=True)
            keep = np.flatnonzero(~table.any_na)
            self.dropped_rows = np.flatnonzero(table.any_na)
            columns = {c: v[keep] for c, v in table.columns.items()}
        else:
            print("[biomedkg_tpu_torch] DPI benchmark csv unavailable; "
                  "falling back to the synthetic DTI graph.",
                  file=sys.stderr)
            columns = synthetic_dpi(seed=43)
            self.dropped_rows = np.zeros(0, np.int64)
        super().__init__(columns=columns, encoder=encoder)
