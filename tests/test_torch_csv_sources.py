"""The port's csv sources against the JAX package's pandas loaders: the
csv reader (data/csv_columns.py) on quoted commas and newlines, empty
fields, every pandas NA token and numeric name columns; the
``BIOMEDKG_KG_CSV`` and ``data_dir/kg.csv`` PrimeKG sources and the
``BIOMEDKG_DPI_CSV`` / ``data_dir`` DPI sources build the same node list,
edge arrays and edge map (exact: both sides end in numpy), or both
refuse; ``user_supplied_csv``'s refusals say what JAX's say; and
``synthetic_dpi`` is byte-identical to JAX's."""

import csv

import numpy as np
import pytest
from pandas._libs.parsers import STR_NA_VALUES

from biomedkg_tpu.data import dpi as jax_dpi
from biomedkg_tpu.data import primekg as jax_primekg
from biomedkg_tpu.data.synthetic import synthetic_dpi as jax_synthetic_dpi
from biomedkg_tpu_torch.data import csv_columns
from biomedkg_tpu_torch.data import primekg
from biomedkg_tpu_torch.data.dpi import DPI
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.data.synthetic import (COLUMNS, DPI_RELATION,
                                               synthetic_dpi)

HEADER = ["relation", "display_relation", "x_type", "x_name", "y_type",
          "y_name", "source"]
TYPES = ["gene/protein", "drug", "disease"]


@pytest.fixture(autouse=True)
def _no_download(monkeypatch):
    # the JAX loader would try the network for a missing kg.csv
    monkeypatch.setattr(jax_primekg, "_download_csv", lambda path: False)
    for key in ("BIOMEDKG_KG_CSV", "BIOMEDKG_KG_CSV_SHA256",
                "BIOMEDKG_DPI_CSV", "BIOMEDKG_DPI_CSV_SHA256",
                "BIOMEDKG_SYNTHETIC_SCALE"):
        monkeypatch.delenv(key, raising=False)


def _write(path, rows, header=HEADER):
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, quoting=csv.QUOTE_MINIMAL)
        writer.writerow(header)
        writer.writerows(rows)
    return str(path)


def _kg_rows():
    """PrimeKG rows whose names hold commas, quotes and a newline, with NA
    tokens only where the graph does not read (display_relation, source)
    and digit-only disease names in string columns (kept as strings)."""
    rows = [
        ["protein_protein", "ppi", "gene/protein", "TP53, tumor",
         "gene/protein", 'MDM2 "the" ligase', "NCBI"],
        ["protein_protein", "NA", "gene/protein", "BRCA1\nvariant",
         "gene/protein", "TP53, tumor", ""],
        ["drug_protein", "target", "drug", "aspirin", "gene/protein",
         "BRCA1\nvariant", "null"],
        ["indication", "", "drug", "aspirin", "disease", "007", "N/A"],
        ["indication", "indication", "drug", "ibuprofen", "disease", "10",
         "#N/A"],
        ["disease_disease", "parent", "disease", "10", "disease", "007",
         "None"],
        ["drug_drug", "synergy", "drug", "ibuprofen", "drug", "aspirin",
         "<NA>"],
        ["off-label use", "off", "drug", "ibuprofen", "disease", "3", "nan"],
        # a relation whose later rows break its first row's signature
        ["drug_protein", "target", "drug", "ibuprofen", "disease", "3",
         "NaN"],
    ]
    return rows


def _assert_same_graph(jax_tg, tg):
    assert tg.node_list == jax_tg.node_list
    assert [type(n) for n in tg.node_list] == \
        [type(n) for n in jax_tg.node_list]
    assert tg.edge_map_index == jax_tg.edge_map_index
    assert tg.node_type_names == jax_tg.node_type_names
    assert tg.type_offset == jax_tg.type_offset
    assert tg.node_to_global == jax_tg.node_to_global
    np.testing.assert_array_equal(tg.graph.edge_index,
                                  jax_tg.graph.edge_index)
    np.testing.assert_array_equal(tg.graph.edge_type, jax_tg.graph.edge_type)
    np.testing.assert_array_equal(tg.node_type_of, jax_tg.node_type_of)
    assert tg.graph.num_nodes == jax_tg.graph.num_nodes


def test_na_tokens_are_pandas():
    assert sorted(csv_columns.NA_TOKENS) == sorted(STR_NA_VALUES)


@pytest.mark.parametrize("source", ["env", "data_dir"])
@pytest.mark.parametrize("node_type", [None, TYPES, ["drug", "disease"]])
def test_primekg_csv_matches_jax(tmp_path, monkeypatch, source, node_type):
    """BIOMEDKG_KG_CSV and a kg.csv in data_dir: the same graph as JAX's
    pandas path."""
    data_dir = tmp_path / "primekg"
    data_dir.mkdir()
    if source == "env":
        path = _write(tmp_path / "mine.csv", _kg_rows())
        monkeypatch.setenv("BIOMEDKG_KG_CSV", path)
    else:
        _write(data_dir / "kg.csv", _kg_rows())
    jax_tg = jax_primekg.PrimeKG(str(data_dir), node_type=node_type)
    tg = primekg.PrimeKG(str(data_dir), node_type=node_type)
    _assert_same_graph(jax_tg, tg)
    if node_type != ["drug", "disease"]:
        assert "TP53, tumor" in tg.node_list and "BRCA1\nvariant" in \
            tg.node_list


def test_primekg_missing_graph_field_raises_as_jax(tmp_path, monkeypatch):
    """An NA in a column the graph reads raises in both packages (JAX's
    sorted() meets a NaN); the port names the row. The node-type filter
    drops a row whose type is NA first, in both."""
    rows = _kg_rows()
    rows.append(["drug_drug", "x", "drug", "NA", "drug", "aspirin", "s"])
    path = _write(tmp_path / "na.csv", rows)
    monkeypatch.setenv("BIOMEDKG_KG_CSV", path)
    with pytest.raises(Exception):
        jax_primekg.PrimeKG(str(tmp_path))
    with pytest.raises(ValueError, match=f"data row {len(rows)} has no "
                                         r"value in \['x_name'\]"):
        primekg.PrimeKG(str(tmp_path))

    rows = _kg_rows() + [["drug_drug", "x", "", "aspirin", "drug",
                          "ibuprofen", "s"]]
    monkeypatch.setenv("BIOMEDKG_KG_CSV", _write(tmp_path / "t.csv", rows))
    _assert_same_graph(jax_primekg.PrimeKG(str(tmp_path), node_type=TYPES),
                       primekg.PrimeKG(str(tmp_path), node_type=TYPES))
    with pytest.raises(Exception):
        jax_primekg.PrimeKG(str(tmp_path))
    with pytest.raises(ValueError, match="x_type"):
        primekg.PrimeKG(str(tmp_path))


def test_primekg_numeric_name_column_matches_jax(tmp_path, monkeypatch):
    """A name column of digits only is an integer column (007 is 7, names
    sort as numbers), as pandas types it; a node type whose names are
    integers on one side and strings on the other does not sort, and
    both packages raise."""
    rows = [["indication", "i", "drug", "aspirin", "disease", "007", "s"],
            ["indication", "i", "drug", "ibuprofen", "disease", "10", "s"],
            ["contraindication", "c", "drug", "aspirin", "disease", "3",
             "s"]]
    monkeypatch.setenv("BIOMEDKG_KG_CSV", _write(tmp_path / "n.csv", rows))
    jax_tg, tg = jax_primekg.PrimeKG(str(tmp_path)), \
        primekg.PrimeKG(str(tmp_path))
    _assert_same_graph(jax_tg, tg)
    assert tg.node_list[:3] == [3, 7, 10]
    rows.append(["disease_disease", "d", "disease", "ulcer", "disease",
                 "3", "s"])
    monkeypatch.setenv("BIOMEDKG_KG_CSV", _write(tmp_path / "m.csv", rows))
    with pytest.raises(TypeError):
        jax_primekg.PrimeKG(str(tmp_path))
    with pytest.raises(TypeError, match="numeric and string names"):
        primekg.PrimeKG(str(tmp_path))


def _dpi_rows():
    """DTI rows: the drug names all digits (a float column once an NA is
    in it), every pandas NA token once, in every column, quoted commas
    and a newline in gene names."""
    genes = ["EGFR, kinase", "ABL1\nfusion", 'KIT "c"', "TP53", "BRAF"]
    rows = []
    tokens = sorted(STR_NA_VALUES)
    for i in range(60):
        rows.append(["drug", f"{i % 13:03d}", "drug_protein_interaction",
                     "gene/protein", genes[i % len(genes)], str(i % 7)])
    cols = len(rows[0])
    for j, token in enumerate(tokens):
        rows[3 * j + 1][j % cols] = token
    return rows


@pytest.mark.parametrize("source", ["env", "data_dir"])
def test_dpi_csv_matches_jax(tmp_path, monkeypatch, source):
    """The DPI csv (BIOMEDKG_DPI_CSV, else data_dir as a file): the rows
    with an NA token in any column dropped as JAX's dropna drops them,
    the rest the same graph; the all-digit drug names are the floats
    pandas makes of them."""
    header = ["x_type", "x_name", "relation", "y_type", "y_name", "score"]
    rows = _dpi_rows()
    path = _write(tmp_path / "dpi.csv", rows, header)
    data_dir = str(tmp_path / "absent.csv")
    if source == "env":
        monkeypatch.setenv("BIOMEDKG_DPI_CSV", path)
    else:
        data_dir = path
    jax_tg, tg = jax_dpi.DPI(data_dir), DPI(data_dir)
    _assert_same_graph(jax_tg, tg)
    na = {i for i, row in enumerate(rows) if any(
        v in STR_NA_VALUES for v in row)}
    assert tg.dropped_rows.tolist() == sorted(na)
    assert len(na) == len(STR_NA_VALUES)
    assert all(isinstance(n, float) for n in tg.node_list[:13])


def test_dpi_falls_back_to_synthetic(tmp_path, capsys):
    tg = DPI(str(tmp_path / "absent.csv"))
    assert "falling back to the synthetic DTI graph" in capsys.readouterr().err
    _assert_same_graph(jax_dpi.DPI(str(tmp_path / "absent.csv")), tg)
    assert tg.edge_map_index == {0: DPI_RELATION[0][0]}


def _jax_error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


@pytest.mark.parametrize("key, required", [
    ("BIOMEDKG_KG_CSV", primekg._REQUIRED_COLUMNS),
    ("BIOMEDKG_DPI_CSV", {"x_type", "x_name", "y_type", "y_name",
                          "relation"})])
def test_user_supplied_csv_refusals_match_jax(tmp_path, monkeypatch, key,
                                              required):
    """A missing file, a checksum mismatch and a header without the
    required columns raise the JAX package's errors and messages; a
    matching checksum (any case) passes."""
    monkeypatch.setenv(key, str(tmp_path / "nope.csv"))
    for fn in (jax_primekg.user_supplied_csv, primekg.user_supplied_csv):
        with pytest.raises(FileNotFoundError, match="does not exist"):
            fn(key, required)
    path = _write(tmp_path / "short.csv", [["a", "b"]], ["x_type", "x_name"])
    monkeypatch.setenv(key, path)
    monkeypatch.setenv(key + "_SHA256", "0" * 64)
    want = _jax_error(lambda: jax_primekg.user_supplied_csv(key, required))
    with pytest.raises(ValueError) as got:
        primekg.user_supplied_csv(key, required)
    assert str(got.value) == str(want) and "checksum mismatch" in str(want)
    monkeypatch.setenv(key + "_SHA256", csv_columns.sha256(path).upper())
    want = _jax_error(lambda: jax_primekg.user_supplied_csv(key, required))
    with pytest.raises(ValueError) as got:
        primekg.user_supplied_csv(key, required)
    assert str(got.value) == str(want) and "lacks required columns" in \
        str(want)
    good = _write(tmp_path / "good.csv", [], sorted(required))
    monkeypatch.setenv(key, good)
    monkeypatch.setenv(key + "_SHA256", csv_columns.sha256(good))
    assert primekg.user_supplied_csv(key, required) == good == \
        jax_primekg.user_supplied_csv(key, required)


def test_cached_kg_csv_header_checked(tmp_path):
    (tmp_path / "kg.csv").write_text("x_type,x_name\ndrug,a\n")
    with pytest.raises(ValueError, match="cached .* lacks required columns"):
        primekg.PrimeKG(str(tmp_path))
    with pytest.raises(ValueError, match="cached .* lacks required columns"):
        jax_primekg.PrimeKG(str(tmp_path))


def test_primekg_module_on_kg_csv(tmp_path, monkeypatch):
    """The data module over a kg.csv written from the synthetic columns:
    the graph and splits of the in-memory build."""
    from biomedkg_tpu_torch.data.synthetic import synthetic_triplets
    columns = synthetic_triplets(num_gene=200, num_drug=80, num_disease=40,
                                 num_edges=3000, seed=5)
    columns["display_relation"] = columns["relation"]
    (tmp_path / "d").mkdir()
    csv_columns.write_csv_columns(str(tmp_path / "d" / "kg.csv"), columns)
    kw = dict(embed_dim=8, node_type=TYPES, batch_size=8, val_ratio=0.2,
              test_ratio=0.2, seed=3)
    dm = PrimeKGModule(data_dir=str(tmp_path / "d"), **kw)
    dm.setup()
    jdm = jax_primekg.PrimeKG(str(tmp_path / "d"), node_type=TYPES)
    _assert_same_graph(jdm, dm.data)
    mem = primekg.TripletGraph({c: columns[c] for c in COLUMNS})
    np.testing.assert_array_equal(dm.graph.edge_index, mem.graph.edge_index)


@pytest.mark.parametrize("text, message", [
    ("a,b\nTrue,x\nfalse,y\n", "booleans"),
    ("a,b\n1,x\ninf,y\n", "number pandas may read otherwise"),
    ("a,b\n99999999999999999999,x\n", "overflows int64"),
    ("a,b\n1,x,3\n", "has 3 fields"),
])
def test_reader_refuses_what_it_cannot_match(tmp_path, text, message):
    path = tmp_path / "odd.csv"
    path.write_text(text)
    with pytest.raises(ValueError, match=message):
        csv_columns.read_csv_columns(str(path), ["a", "b"])


def test_reader_types_columns_as_pandas(tmp_path):
    """Integers, integers with a missing field (float), decimals, short
    rows padded, blank lines skipped, a byte-order mark dropped; each
    against pandas."""
    import pandas as pd
    text = ("﻿i,f,d,s\n 7,1,2.5,x\n\n-3,,1e3,\"a\nb\"\n"
            "007,4,.5,NA\n12,5\n")
    path = tmp_path / "t.csv"
    path.write_text(text, encoding="utf-8")
    df = pd.read_csv(path)
    got = csv_columns.read_csv_columns(str(path), ["i", "f", "d", "s"])
    for c in ("i", "f", "d"):
        assert got.columns[c].dtype == df[c].dtype, c
        np.testing.assert_array_equal(got.columns[c], df[c].to_numpy())
    assert got.na["s"].tolist() == df["s"].isna().tolist()
    assert [v for v, m in zip(got.columns["s"], got.na["s"]) if not m] == \
        [v for v in df["s"] if isinstance(v, str)]


@pytest.mark.parametrize("kw", [dict(seed=43), dict(seed=1),
                                dict(num_drug=90, num_gene=150,
                                     num_edges=700, seed=9)])
def test_synthetic_dpi_is_jax_bytes(kw):
    want = jax_synthetic_dpi(**kw)
    got = synthetic_dpi(**kw)
    assert list(got) == list(COLUMNS)
    for c in COLUMNS:
        ref = want[c].to_numpy().astype(str)
        assert got[c].dtype == ref.dtype, c
        assert got[c].tobytes() == ref.tobytes(), c
