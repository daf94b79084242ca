"""Triplet csv files as numpy columns, without pandas.

The JAX package reads its csv sources with ``pandas.read_csv`` (default
options); the port reads them with the standard library's ``csv`` module
and gives each column the values pandas would:

* fields are split by ``,`` with ``"`` quoting (a quoted field may hold
  commas, doubled quotes and newlines); empty lines are skipped, a short
  row is padded with missing fields, a long one raises;
* a field equal to one of pandas' default NA tokens (``NA_TOKENS``: the
  empty string, ``NA``, ``N/A``, ``NaN``, ``nan``, ``null``, ``None``,
  ``#N/A``, ``<NA>``, ...) is missing (NaN in pandas), quoted or not;
* a column whose present fields are all integers is int64, Python ints
  in the graph built from it (``"007"`` is 7), or float64 when a field
  is missing; one whose fields are all decimal numbers is float64;
  every other column keeps its fields as strings.

A column pandas would type in a way this reader does not copy (booleans,
``inf``, numbers Python reads but the patterns here do not, integers past
int64) raises ``ValueError`` naming the row, rather than a guess.
"""

from __future__ import annotations

import csv
import hashlib
import io
import re
from typing import Dict, Iterable, List, NamedTuple, Optional

import numpy as np

# pandas._libs.parsers.STR_NA_VALUES (pandas 1.x-3.x)
NA_TOKENS = ("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
             "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
             "None", "n/a", "nan", "null")
_BOOL_TOKENS = frozenset({"True", "TRUE", "true", "False", "FALSE", "false"})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_DECIMAL = re.compile(r"\s*[+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?\s*")
_INT64_MAX = np.iinfo(np.int64).max


class CsvColumns(NamedTuple):
    """The requested ``columns`` (numpy arrays, one entry a data row),
    each column's missing-field mask (``na``) and, when asked for, the
    rows with a missing field in any column of the file (``any_na``)."""
    columns: Dict[str, np.ndarray]
    na: Dict[str, np.ndarray]
    any_na: Optional[np.ndarray]


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _open(path: str):
    # utf-8-sig: a byte-order mark before the header is dropped, as
    # pandas drops it
    return open(path, newline="", encoding="utf-8-sig")


def read_header(path: str) -> List[str]:
    """The column names: the first non-empty record of the file."""
    with _open(path) as f:
        for record in csv.reader(f):
            if record:
                return record
    return []


def _floatable(text: str) -> bool:
    try:
        float(text)
    except ValueError:
        return False
    return True


def _typed(name: str, values: np.ndarray, na: np.ndarray) -> np.ndarray:
    """``values`` (strings) with pandas' type: int64, float64 (NaN where
    missing) or the strings as they are."""
    live = np.flatnonzero(~na)
    if live.size == 0:
        return np.full(len(values), np.nan)     # an all-missing column
    first = values[live[0]]
    if first in _BOOL_TOKENS:
        if all(values[i] in _BOOL_TOKENS for i in live):
            raise ValueError(f"csv column {name!r} is all booleans, which "
                             "pandas reads as bool; not supported")
        return values
    if not _floatable(first):
        return values
    ints = decimals = True
    for i in live:
        text = values[i]
        if ints and _INT.fullmatch(text):
            continue
        ints = False
        if decimals and _DECIMAL.fullmatch(text):
            continue
        decimals = False
        if not _floatable(text):
            return values                       # a string column
    if not decimals:
        bad = next(i for i in live if not _DECIMAL.fullmatch(values[i]))
        raise ValueError(
            f"csv column {name!r}, data row {bad + 1}: {values[bad]!r} is a "
            "number pandas may read otherwise than this reader; not "
            "supported")
    if ints:
        out = [int(values[i]) for i in live]
        big = next((j for j, v in enumerate(out) if abs(v) > _INT64_MAX),
                   None)
        if big is not None:
            raise ValueError(f"csv column {name!r}, data row "
                             f"{live[big] + 1}: {values[live[big]]!r} "
                             "overflows int64; not supported")
        if live.size == len(values):
            return np.array(out, dtype=np.int64)
    else:
        out = [float(values[i]) for i in live]
    column = np.full(len(values), np.nan)
    column[live] = out
    return column


def read_csv_columns(path: str, columns: Iterable[str],
                     any_na: bool = False) -> CsvColumns:
    """The csv at ``path``: ``columns`` typed as pandas types them, their
    missing-field masks and, with ``any_na``, the rows with a missing
    field in any column. A requested column the header lacks raises
    ``KeyError``."""
    with _open(path) as f:
        text = f.read()
    records = [r for r in csv.reader(io.StringIO(text)) if r]
    del text
    if not records:
        raise ValueError(f"{path}: empty csv")
    header, rows = records[0], records[1:]
    width = len(header)
    for i, row in enumerate(rows):
        if len(row) > width:
            raise ValueError(f"{path}: data row {i + 1} has {len(row)} "
                             f"fields, the header {width}")
        if len(row) < width:
            rows[i] = row + [""] * (width - len(row))
    # pandas keeps the first of repeated column names as it is
    index = {}
    for j, name in enumerate(header):
        index.setdefault(name, j)
    columns = list(columns)
    missing = [c for c in columns if c not in index]
    if missing:
        raise KeyError(f"{path} lacks columns {missing}; found {header}")
    wanted = range(width) if any_na else sorted({index[c] for c in columns})
    fields = {j: np.array([row[j] for row in rows], dtype=str)
              if rows else np.zeros(0, dtype=str) for j in wanted}
    na = {j: np.isin(v, NA_TOKENS) for j, v in fields.items()}
    out = {c: _typed(c, fields[index[c]], na[index[c]]) for c in columns}
    row_na = None
    if any_na:
        row_na = np.zeros(len(rows), bool)
        for mask in na.values():
            row_na |= mask
    return CsvColumns(out, {c: na[index[c]] for c in columns}, row_na)


def write_csv_columns(path: str, columns: Dict[str, np.ndarray]) -> None:
    """``columns`` as a csv with a header, quoted where needed."""
    names = list(columns)
    with open(path, "w", newline="", encoding="utf-8") as f:
        writer = csv.writer(f)
        writer.writerow(names)
        writer.writerows(zip(*(columns[c].tolist() for c in names)))
