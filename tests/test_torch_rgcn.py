"""Model layer of the PyTorch port against the JAX package: a small RGCN
(widths 16, 2 hidden layers, 8 relations) on the default synthetic graph
with JAX-initialised weights carried across by interop/jax_params.py.

Tolerances: z, scores and candidate matrices 1e-4 (rtol and atol); both
sides compute in float32 and differ only in summation order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.data.node_encoders import RandomEncode as JaxEncode
from biomedkg_tpu.data.synthetic import synthetic_triplets as jax_synth
from biomedkg_tpu.data.triplet import TripletGraph as JaxTripletGraph
from biomedkg_tpu.ops import segment as jax_segment
from biomedkg_tpu.sampling.loaders import FullGraphLoader as JaxLoader
from biomedkg_tpu.training.kge_module import KGEModule as JaxKGEModule
from biomedkg_tpu_torch.data.node_encoders import RandomEncode
from biomedkg_tpu_torch.data.synthetic import synthetic_triplets
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.interop.jax_params import load_jax_params, \
    to_jax_params
from biomedkg_tpu_torch.nn import xavier_uniform
from biomedkg_tpu_torch.ops import segment
from biomedkg_tpu_torch.sampling.batch import batch_to_device
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader
from biomedkg_tpu_torch.training.kge_module import KGEModule

DIM = 16
TOL = dict(rtol=1e-4, atol=1e-4)


def _hparams(num_relation):
    return dict(encoder_name="rgcn", decoder_name="dismult", in_dim=DIM,
                hidden_dim=DIM, out_dim=DIM, num_hidden_layers=2,
                num_relation=num_relation, num_heads=2,
                scheduler_type="cosine", learning_rate=1e-3,
                warm_up_ratio=0.2, fuse_method="none", neg_ratio=1,
                node_init_method="random")


@functools.lru_cache(maxsize=None)
def _setup():
    jax_tg = JaxTripletGraph(jax_synth(seed=42), encoder=JaxEncode(DIM))
    tg = TripletGraph(synthetic_triplets(seed=42), encoder=RandomEncode(DIM))
    hp = _hparams(tg.num_edge_types)
    jax_module = JaxKGEModule(**hp)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_module.init(jax.random.PRNGKey(0)))
    module = KGEModule(**hp)
    load_jax_params(module.model, params)
    return jax_tg, tg, jax_module, params, module


@functools.lru_cache(maxsize=None)
def _jax_z(layout):
    jax_tg, _, jax_module, params, _ = _setup()
    jax_module.edge_layout = layout
    batch = JaxLoader(jax_tg.graph, edge_layout=layout).batch()
    return np.asarray(jax_module.encode(params, batch))


def _port_z(layout):
    _, tg, _, _, module = _setup()
    module.edge_layout = layout
    batch = FullGraphLoader(tg.graph, edge_layout=layout).batch()
    return module.encode(batch_to_device(batch, "cpu")).numpy()


@pytest.mark.parametrize("jax_layout", ["relation", "dst"])
@pytest.mark.parametrize("layout", ["relation", "dst"])
def test_rgcn_z_matches_jax(layout, jax_layout):
    z = _port_z(layout)
    assert z.shape == _jax_z(jax_layout).shape
    np.testing.assert_allclose(z, _jax_z(jax_layout), **TOL)


def test_distmult_matches_jax():
    _, _, jax_module, params, module = _setup()
    z = _jax_z("relation")
    rng = np.random.default_rng(0)
    n, r = z.shape[0], params["model"]["decoder"]["rel_emb"].shape[0]
    head, tail = rng.integers(0, n, 64), rng.integers(0, n, 64)
    rel = rng.integers(0, r, 64)
    dec, jdec = module.model.decoder, jax_module.model.decoder
    dp = params["model"]["decoder"]
    zt = torch.tensor(z)
    h_t, t_t, r_t = (torch.from_numpy(a) for a in (head, tail, rel))
    with torch.no_grad():
        np.testing.assert_allclose(
            dec.score(zt, h_t, t_t, r_t).numpy(),
            np.asarray(jdec.score(dp, z, head, tail, rel)), **TOL)
        np.testing.assert_allclose(
            dec.score_all_tails(zt, h_t[:8], r_t[:8]).numpy(),
            np.asarray(jdec.score_all_tails(dp, z, head[:8], rel[:8])),
            **TOL)
        np.testing.assert_allclose(
            dec.score_all_heads(zt, t_t[:8], r_t[:8]).numpy(),
            np.asarray(jdec.score_all_heads(dp, z, tail[:8], rel[:8])),
            **TOL)


def test_segment_ops_match_jax():
    rng = np.random.default_rng(2)
    n, r, e = 40, 3, 500
    vals = rng.standard_normal((e, 6)).astype(np.float32)
    dst = rng.integers(0, n, e)
    et = rng.integers(0, r, e)
    mask = rng.random(e) < 0.8
    t = torch.from_numpy
    np.testing.assert_allclose(
        segment.scatter_add(t(vals), t(dst), n).numpy(),
        np.asarray(jax_segment.scatter_add(jnp.asarray(vals),
                                           jnp.asarray(dst), n)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        segment.per_dst_relation_counts(t(dst), t(et), t(mask), n, r).numpy(),
        np.asarray(jax_segment.per_dst_relation_counts(
            jnp.asarray(dst), jnp.asarray(et), jnp.asarray(mask), n, r)))
    np.testing.assert_array_equal(
        segment.take_rows(t(vals), t(dst)).numpy(),
        np.asarray(jax_segment.take_rows(jnp.asarray(vals),
                                         jnp.asarray(dst))))


def test_params_round_trip_and_init():
    _, _, _, params, module = _setup()
    back = to_jax_params(module.model)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    fresh = KGEModule(**_hparams(8))
    fresh.init(torch.Generator().manual_seed(0))
    w = fresh.model.encoder.layers[0].w_rel.detach()
    bound = np.sqrt(6.0 / (DIM + DIM))
    assert w.shape == (8, DIM, DIM) and float(w.abs().max()) <= bound
    assert not fresh.model.encoder.layers[0].b.detach().any()
    a = xavier_uniform((3, 4), torch.Generator().manual_seed(1))
    b = xavier_uniform((3, 4), torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    bad = dict(params, model=dict(params["model"], decoder={
        "rel_emb": np.zeros((2, DIM), np.float32)}))
    with pytest.raises(ValueError, match="rel_emb"):
        load_jax_params(fresh.model, bad)


def test_unported_paths_raise():
    """The refusals that remain: ``dst_bwd="perm"``, and RGAT, which has
    no destination-sorted layout, asked for "dst" (fusion is ported:
    tests/test_torch_fusion.py)."""
    hp = _hparams(8)
    module = KGEModule(**hp)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        module.dst_bwd = "perm"
    rgat = KGEModule(**dict(hp, encoder_name="rgat"))
    with pytest.raises(ValueError, match="relation-blocked"):
        rgat.edge_layout = "dst"
    rgat.edge_layout = "relation"
    assert rgat.edge_layout == "relation"
