"""The port's neighbour sampling (the native hop and numpy's Gumbel-top-k,
``NeighborSampler``, ``NeighborBatchLoader`` and the data module's
neighbour loaders) against the JAX package on the default synthetic graph:
for the same seed, byte-identical batch streams, native and
``BIOMEDKG_NO_NATIVE=1``, with the budgets shared across splits."""

import itertools

import numpy as np
import pytest

from biomedkg_tpu.data import modules as jax_modules
from biomedkg_tpu.data import primekg as jax_primekg
from biomedkg_tpu.sampling import native as jax_native
from biomedkg_tpu.sampling.neighbor import \
    NeighborBatchLoader as JaxNeighborLoader
from biomedkg_tpu.sampling.neighbor import \
    sample_in_neighbors as jax_sample_in_neighbors
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.sampling import native
from biomedkg_tpu_torch.sampling.loaders import NeighborBatchLoader
from biomedkg_tpu_torch.sampling.neighbor import sample_in_neighbors

from test_torch_saint import _assert_same, _fresh, _graphs


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


def test_one_hop_matches_jax(mode):
    """Capped (k = 3, 30) and full (k = -1) hops, including a frontier of
    nodes with no in-edges."""
    jg, g = _fresh(*_graphs())
    frontier = np.random.default_rng(1).choice(g.num_nodes, 300,
                                               replace=False)
    indptr = g.in_csr()[0]
    frontier = np.concatenate(
        [frontier, np.flatnonzero(np.diff(indptr) == 0)[:5]])
    for k in (3, 30, -1):
        got = sample_in_neighbors(g, frontier, k, np.random.default_rng(9))
        want = jax_sample_in_neighbors(jg, frontier, k,
                                       np.random.default_rng(9))
        _assert_same(want, got)
        deg = indptr[frontier + 1] - indptr[frontier]
        cap = np.minimum(deg, k) if k >= 0 else deg
        np.testing.assert_array_equal(
            np.bincount(got[1], minlength=len(frontier)), cap)


@pytest.mark.parametrize("layout", ["dst", "relation"])
def test_neighbor_stream_matches_jax(mode, layout):
    """Probed budgets, two epochs of shuffled batches with features, and a
    re-keyed epoch, byte for byte; the dropped-edge ledger too."""
    jg, g = _fresh(*_graphs())
    kw = dict(batch_size=48, fanouts=[10, 5], shuffle=True, block_size=64,
              seed=7, edge_layout=layout)
    ref, ours = JaxNeighborLoader(jg, **kw), NeighborBatchLoader(g, **kw)
    assert (ours.node_budget, ours.edge_budget, len(ours)) == \
        (ref.node_budget, ref.edge_budget, len(ref))
    for epoch in (None, None, 4):
        if epoch is not None:
            ref.set_epoch(epoch)
            ours.set_epoch(epoch)
        for a, b in zip(ref, ours):
            _assert_same(a, b)
    assert ours.dropped_edges == ref.dropped_edges


def test_node_budget_truncation_matches_jax(mode):
    """A node budget below the sampled subgraph keeps the seeds and the
    earliest neighbours (edges counted as dropped); one below the seed
    count raises."""
    jg, g = _fresh(*_graphs())
    kw = dict(batch_size=32, fanouts=[30, 30], seed=3, node_budget=128,
              edge_budget=4096, with_features=False, edge_layout="dst")
    ref, ours = JaxNeighborLoader(jg, **kw), NeighborBatchLoader(g, **kw)
    for a, b in zip(ref, ours):
        _assert_same(a, b)
    assert ours.dropped_edges == ref.dropped_edges > 0
    tight = NeighborBatchLoader(g, **dict(kw, node_budget=16))
    with pytest.raises(ValueError, match="seed nodes"):
        next(iter(tight))


def test_data_module_neighbor_loaders_match_jax(mode, tmp_path,
                                                monkeypatch):
    """train/val/test ("neighbor") share the budgets probed once on the
    test graph; all_dataloader and subgraph_dataloader match too; "full"
    still raises."""
    monkeypatch.setattr(jax_primekg, "_download_csv", lambda *a, **k: False)
    kw = dict(data_dir=str(tmp_path), embed_dim=8,
              node_type=["gene/protein", "drug", "disease"], batch_size=16,
              val_ratio=0.2, test_ratio=0.2, node_init_method="random",
              seed=5)
    ref, ours = jax_modules.PrimeKGModule(**kw), PrimeKGModule(**kw)
    for dm in (ref, ours):
        dm.setup(stage="split")
        dm.edge_layout = "dst"
        dm.device_features = True
    budgets = set()
    for split in ("train", "val", "test"):
        a = getattr(ref, f"{split}_dataloader")(loader_type="neighbor")
        b = getattr(ours, f"{split}_dataloader")(loader_type="neighbor")
        assert (b.node_budget, b.edge_budget, len(b), b.shuffle) == \
            (a.node_budget, a.edge_budget, len(a), a.shuffle)
        budgets.add((b.node_budget, b.edge_budget))
        for _, x, y in zip(range(2), a, b):
            _assert_same(x, y)
            assert y.x.size == 0
    assert len(budgets) == 1
    a, b = ref.all_dataloader(), ours.all_dataloader()
    assert (b.node_budget, b.edge_budget) == (a.node_budget, a.edge_budget)
    _assert_same(next(iter(a)), next(iter(b)))
    _assert_same(ref.subgraph_dataloader().batch(),
                 next(iter(ours.subgraph_dataloader())))
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
