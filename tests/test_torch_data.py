"""Host data layer of the PyTorch port against the JAX package: the same
seed must give array-equal triplets, graphs, features, splits and padded
batches (numpy on both sides, so equality is exact)."""

import functools

import numpy as np
import pytest
import torch

from biomedkg_tpu.data import primekg as jax_primekg
from biomedkg_tpu.data.modules import PrimeKGModule as JaxModule
from biomedkg_tpu.data.node_encoders import RandomEncode as JaxEncode
from biomedkg_tpu.data.split import random_link_split as jax_split
from biomedkg_tpu.data.synthetic import synthetic_triplets as jax_synth
from biomedkg_tpu.data.triplet import TripletGraph as JaxTripletGraph
from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.sampling.loaders import FullGraphLoader as JaxLoader
from biomedkg_tpu_torch.data.csv_columns import write_csv_columns
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.data.node_encoders import RandomEncode
from biomedkg_tpu_torch.data.split import random_link_split
from biomedkg_tpu_torch.data.synthetic import COLUMNS, synthetic_triplets
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.sampling.batch import batch_to_device, \
    pad_graph_batch
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader

CONFIGS = {
    "default-seed42": dict(seed=42),
    "small-seed7": dict(num_gene=300, num_drug=120, num_disease=80,
                        num_edges=5000, seed=7),
}
FEAT_DIM = 16


@functools.lru_cache(maxsize=None)
def _graphs(cfg):
    kw = CONFIGS[cfg]
    jax_tg = JaxTripletGraph(jax_synth(**kw), encoder=JaxEncode(FEAT_DIM))
    tg = TripletGraph(synthetic_triplets(**kw), encoder=RandomEncode(FEAT_DIM))
    return jax_tg, tg


def _assert_graph_equal(a, b):
    assert a.num_nodes == b.num_nodes
    assert a.num_relations == b.num_relations
    np.testing.assert_array_equal(a.edge_index, b.edge_index)
    np.testing.assert_array_equal(a.edge_type, b.edge_type)
    assert a.edge_type.dtype == b.edge_type.dtype
    if a.x is None:
        assert b.x is None
    else:
        np.testing.assert_array_equal(a.x, b.x)


def _assert_batch_equal(a, b):
    for field in a._fields:
        x, y = np.asarray(getattr(a, field)), np.asarray(getattr(b, field))
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_synthetic_rows(cfg):
    df = jax_synth(**CONFIGS[cfg])
    cols = synthetic_triplets(**CONFIGS[cfg])
    for c in COLUMNS:
        np.testing.assert_array_equal(df[c].to_numpy().astype(str), cols[c])


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_triplet_graph(cfg):
    jax_tg, tg = _graphs(cfg)
    _assert_graph_equal(jax_tg.graph, tg.graph)
    assert tg.graph.x.shape == (tg.graph.num_nodes, FEAT_DIM)
    assert jax_tg.edge_map_index == tg.edge_map_index
    assert jax_tg.node_list == tg.node_list
    assert jax_tg.node_type_names == tg.node_type_names
    np.testing.assert_array_equal(jax_tg.node_type_of, tg.node_type_of)
    assert jax_tg.type_offset == tg.type_offset
    assert jax_tg.node_to_global == tg.node_to_global
    assert jax_tg.num_edge_types == tg.num_edge_types


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_random_link_split(cfg):
    jax_tg, tg = _graphs(cfg)
    for a, b in zip(jax_split(jax_tg.graph, 0.2, 0.2, seed=3),
                    random_link_split(tg.graph, 0.2, 0.2, seed=3)):
        _assert_graph_equal(a.graph, b.graph)
        np.testing.assert_array_equal(a.label_edge_index, b.label_edge_index)
        np.testing.assert_array_equal(a.label_edge_type, b.label_edge_type)


@pytest.mark.parametrize("layout", ["relation", "dst"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_full_graph_loader(cfg, layout):
    jax_tg, tg = _graphs(cfg)
    _assert_batch_equal(JaxLoader(jax_tg.graph, edge_layout=layout).batch(),
                        FullGraphLoader(tg.graph, edge_layout=layout).batch())


@pytest.mark.parametrize("layout", ["relation", "dst"])
def test_pad_graph_batch_overflow(layout):
    """Edges beyond the budget are dropped as the same random subset."""
    rng = np.random.default_rng(5)
    ei = rng.integers(0, 90, (2, 3000))
    et = rng.integers(0, 5, 3000)
    x = rng.standard_normal((90, 4)).astype(np.float32)
    kw = dict(num_relations=5, node_budget=128, edge_budget=1024,
              block_size=64, layout=layout, rng=None)
    _assert_batch_equal(jax_pad(x, ei, et, **kw),
                        pad_graph_batch(x, ei, et, **kw))


def test_batch_to_device_widens():
    _, tg = _graphs("small-seed7")
    batch = FullGraphLoader(tg.graph, edge_layout="dst").batch()
    assert batch.edge_index.dtype == np.int16
    dev = batch_to_device(batch, "cpu")
    for field in ("edge_index", "edge_type", "block_rel", "node_ids",
                  "src_edges", "src_pos"):
        t = getattr(dev, field)
        assert t.dtype == torch.int64, field
        np.testing.assert_array_equal(t.numpy(), getattr(batch, field))
    assert dev.x.dtype == torch.float32 and dev.edge_mask.dtype == torch.bool


@pytest.mark.parametrize("node_type", [["gene/protein", "drug", "disease"],
                                       ["drug", "disease"]])
def test_primekg_module(tmp_path, monkeypatch, node_type):
    monkeypatch.chdir(tmp_path)
    # no download attempt: the JAX loader goes straight to the fallback
    monkeypatch.setattr(jax_primekg, "_download_csv", lambda path: False)
    kw = dict(data_dir="./data/primekg", embed_dim=FEAT_DIM,
              node_type=node_type, batch_size=8, val_ratio=0.2,
              test_ratio=0.2, node_init_method="random", seed=11)
    jdm, dm = JaxModule(**kw), PrimeKGModule(**kw)
    jdm.setup("split")
    dm.setup("split")
    _assert_graph_equal(jdm.graph, dm.graph)
    assert jdm.edge_map_index == dm.edge_map_index
    assert jdm.data.node_list == dm.data.node_list
    for split in ("train_data", "val_data", "test_data"):
        _assert_graph_equal(getattr(jdm, split).graph,
                            getattr(dm, split).graph)


def test_primekg_refuses_csv_sources(tmp_path, monkeypatch):
    """The csv sources load (BIOMEDKG_KG_CSV, then a kg.csv in data_dir,
    the same graph as JAX's pandas path; tests/test_torch_csv_sources.py
    holds the reader's corner cases); a cached kg.csv without the required
    columns and a missing BIOMEDKG_KG_CSV file still raise, as in JAX; the
    LM cache's build (Stage A) raises without the modality csvs, naming
    the first."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jax_primekg, "_download_csv", lambda path: False)
    kw = dict(data_dir="./data/primekg", embed_dim=FEAT_DIM,
              node_type=["drug"], batch_size=8, val_ratio=0.2,
              test_ratio=0.2)
    dm = PrimeKGModule(**kw)
    columns = synthetic_triplets(**CONFIGS["small-seed7"])
    columns["display_relation"] = columns["relation"]
    path = str(tmp_path / "kg.csv")
    write_csv_columns(path, columns)
    monkeypatch.setenv("BIOMEDKG_KG_CSV", str(tmp_path / "absent.csv"))
    with pytest.raises(FileNotFoundError, match="does not exist"):
        dm.setup()
    monkeypatch.setenv("BIOMEDKG_KG_CSV", path)
    dm.setup()
    jdm = JaxModule(**kw)
    jdm.setup()
    _assert_graph_equal(jdm.graph, dm.graph)
    assert jdm.data.node_list == dm.data.node_list
    monkeypatch.delenv("BIOMEDKG_KG_CSV")
    (tmp_path / "data" / "primekg").mkdir(parents=True)
    (tmp_path / "data" / "primekg" / "kg.csv").write_text("x_type\n")
    with pytest.raises(ValueError, match="lacks required columns"):
        dm.setup()
    write_csv_columns(str(tmp_path / "data" / "primekg" / "kg.csv"), columns)
    jdm, dm = JaxModule(**kw), PrimeKGModule(**kw)
    jdm.setup()
    dm.setup()
    _assert_graph_equal(jdm.graph, dm.graph)
    with pytest.raises(FileNotFoundError,
                       match="protein_aminoacid_sequence.csv"):
        PrimeKGModule(data_dir=".", embed_dim=8, node_type=["drug"],
                      batch_size=8, val_ratio=0.2, test_ratio=0.2,
                      node_init_method="lm")
