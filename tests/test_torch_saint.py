"""The port's GraphSAINT path (CSR builds, induced subgraphs, random-walk
batches, the data module's shared budgets) against the JAX package on the
default synthetic graph: host numpy and the native library on both sides,
byte-identical arrays for the same seed."""

import functools

import itertools

import numpy as np
import pytest

from biomedkg_tpu.data import modules as jax_modules
from biomedkg_tpu.data import primekg as jax_primekg
from biomedkg_tpu.data.synthetic import synthetic_triplets as jax_synth
from biomedkg_tpu.data.triplet import TripletGraph as JaxTripletGraph
from biomedkg_tpu.sampling import native as jax_native
from biomedkg_tpu.sampling.loaders import SaintRandomWalkLoader as JaxLoader
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.data.synthetic import synthetic_triplets
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.sampling import native
from biomedkg_tpu_torch.sampling.csr import CSRGraph, ranges_concat
from biomedkg_tpu_torch.sampling.loaders import SaintRandomWalkLoader


@functools.lru_cache(maxsize=None)
def _graphs():
    return (JaxTripletGraph(jax_synth(seed=42)).graph,
            TripletGraph(synthetic_triplets(seed=42)).graph)


def _fresh(jax_graph, graph):
    """Copies without cached CSR arrays, so each mode builds its own."""
    def copy(g, cls):
        return cls(num_nodes=g.num_nodes, edge_index=g.edge_index,
                   edge_type=g.edge_type, num_relations=g.num_relations,
                   x=g.x)
    return copy(jax_graph, type(jax_graph)), copy(graph, CSRGraph)


@pytest.fixture(params=["native", "numpy"])
def mode(request, monkeypatch):
    """Both packages on their native library, or both on the numpy
    fallback (BIOMEDKG_NO_NATIVE=1)."""
    for module in (jax_native, native):
        monkeypatch.setattr(module, "_lib", None)
        monkeypatch.setattr(module, "_build_failed", False)
    if request.param == "numpy":
        monkeypatch.setenv("BIOMEDKG_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("BIOMEDKG_NO_NATIVE", raising=False)
        if jax_native.get_lib() is None:
            pytest.skip("the reference's native sampler did not load")
        assert native.get_lib() is not None, "g++ build failed"
    return request.param


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_ranges_concat():
    got = ranges_concat(np.array([5, 0, 9, 2]), np.array([2, 0, 3, 1]))
    np.testing.assert_array_equal(got, [5, 6, 9, 10, 11, 2])
    assert ranges_concat(np.array([1]), np.array([0])).size == 0


def test_csr_and_induced_subgraph_match_jax(mode):
    jg, g = _fresh(*_graphs())
    _assert_same(jg.out_csr(), g.out_csr())
    _assert_same(jg.in_csr(), g.in_csr())
    rng = np.random.default_rng(0)
    for size in (1, 37, 500):
        nodes = rng.choice(g.num_nodes, size, replace=False)
        _assert_same(jg.induced_subgraph(nodes), g.induced_subgraph(nodes))


@pytest.mark.parametrize("fill", [None, 0.92])
@pytest.mark.parametrize("layout", ["dst", "relation"])
def test_saint_stream_matches_jax(mode, fill, layout):
    jg, g = _fresh(*_graphs())
    kw = dict(batch_size=16, walk_length=10, num_steps=3, block_size=128,
              seed=7, fill_target=fill, edge_layout=layout,
              with_features=False)
    ref, ours = JaxLoader(jg, **kw), SaintRandomWalkLoader(g, **kw)
    assert (ours.node_budget, ours.edge_budget, ours.max_roots) == \
        (ref.node_budget, ref.edge_budget, ref.max_roots)
    for epoch in (None, 3):
        if epoch is not None:
            ref.set_epoch(epoch)
            ours.set_epoch(epoch)
        for a, b in zip(ref, ours):
            _assert_same(a, b)
    assert ours.dropped_edges == ref.dropped_edges


def test_data_module_shares_budgets_like_jax(mode, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_primekg, "_download_csv", lambda *a, **k: False)
    kw = dict(data_dir=str(tmp_path), embed_dim=8,
              node_type=["gene/protein", "drug", "disease"], batch_size=16,
              val_ratio=0.2, test_ratio=0.2, node_init_method="random",
              seed=3)
    ref, ours = jax_modules.PrimeKGModule(**kw), PrimeKGModule(**kw)
    for dm in (ref, ours):
        dm.setup(stage="split")
        dm.edge_layout = "dst"
        dm.device_features = True
        dm.saint_fill_target = 0.92
    for split in ("train", "val", "test"):
        a = getattr(ref, f"{split}_dataloader")(loader_type="saint")
        b = getattr(ours, f"{split}_dataloader")(loader_type="saint")
        assert (b.node_budget, b.edge_budget, len(b)) == \
            (a.node_budget, a.edge_budget, len(a))
        assert b.fill_target == a.fill_target
        _assert_same(a.sample()[0], b.sample()[0])
    # loader_type="full": the split's whole graph, one host batch yielded
    # SAINT_TRAIN_STEPS times (val and test: once), as JAX's values
    for split, steps in (("train", ref.SAINT_TRAIN_STEPS), ("val", 1),
                         ("test", 1)):
        a = getattr(ref, f"{split}_dataloader")(loader_type="full")
        b = getattr(ours, f"{split}_dataloader")(loader_type="full")
        assert len(a) == len(b) == steps
        got = list(itertools.islice(b, 2))
        for x, y in zip(next(iter(a)), got[0]):
            assert np.array_equal(np.asarray(x), y)
        assert all(g is got[0] for g in got)
