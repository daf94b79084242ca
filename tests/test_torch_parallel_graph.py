"""The port's graph-sharded full-graph encode and training step
(parallel/graph_shard.py) on 4 gloo ranks against the JAX package's on 4
devices of its virtual CPU mesh, and against one device.

The ranks start once (a module fixture runs every scenario in one group,
tests/test_torch_parallel_ranks.py). Tolerances: the encodes 2e-4
(tests/test_parallel.py); the loss 1e-5; the parameters after one Adam
step rtol 1e-5 / atol 1e-6 (float32 sums in another order), Adam's eps
1e-3 (test_torch_parallel_ranks.EPS: the update follows the gradient's
size, so a gradient wrong by a factor shows). The sampled negatives are
drawn by the port's own generator: their range, the loss falling and the
dropout keep rate (0.8) are checked instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from biomedkg_tpu.data.node_encoders import RandomEncode
from biomedkg_tpu.data.synthetic import synthetic_triplets
from biomedkg_tpu.data.triplet import TripletGraph
from biomedkg_tpu.models.decoders import DistMult
from biomedkg_tpu.models.encoders import RGCN
from biomedkg_tpu.models.factory import GAE
from biomedkg_tpu.parallel.graph_shard import (build_halo_plan,
                                               make_sharded_train_step,
                                               partition_graph,
                                               sharded_rgcn_encode)
from biomedkg_tpu.parallel.mesh import make_mesh
from biomedkg_tpu.sampling.loaders import FullGraphLoader
from biomedkg_tpu.training.kge_module import TrainState
from biomedkg_tpu_torch.parallel.launch import run_local_ranks
from test_torch_parallel_ranks import EPS, flat_params, graph_worker

DIM, WORLD, K = 16, 4, 3


@pytest.fixture(scope="module")
def setup():
    tg = TripletGraph(synthetic_triplets(num_gene=100, num_drug=40,
                                         num_disease=30, num_edges=1200,
                                         seed=5),
                      encoder=RandomEncode(embed_dim=DIM))
    r = tg.num_edge_types
    enc = RGCN(in_dim=DIM, hidden_dim=DIM, out_dim=DIM, num_hidden_layers=1,
               num_relations=r, drop_out=False)
    dec = DistMult(r, DIM)
    params = GAE(enc, dec).init(jax.random.PRNGKey(0))
    batch = FullGraphLoader(tg.graph, block_size=64).batch()
    sharded = partition_graph(batch, WORLD, r, block_size=64)
    fixed = np.random.default_rng(0).integers(
        0, tg.graph.num_nodes,
        (WORLD, 2, K, sharded.edge_type.shape[1])).astype(np.int32)
    return dict(tg=tg, enc=enc, dec=dec, params=params, batch=batch,
                sharded=sharded, fixed=fixed, r=r)


@pytest.fixture(scope="module")
def ranks(setup):
    s = setup
    payload = dict(
        world=WORLD, dim=DIM, num_rel=s["r"], k=K, fixed_neg=s["fixed"],
        params=jax.tree_util.tree_map(np.asarray, s["params"]),
        batch={f: np.asarray(getattr(s["batch"], f))
               for f in s["batch"]._fields},
        sampled_steps=6)
    return run_local_ranks(WORLD, graph_worker, (payload,), timeout=240)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(dp=WORLD, tp=1, devices=jax.devices()[:WORLD])


def test_encodes_match_jax_and_one_device(setup, ranks, mesh):
    s = setup
    want = np.asarray(sharded_rgcn_encode(s["enc"], s["params"]["encoder"],
                                          s["sharded"], mesh))
    single = np.asarray(s["enc"].apply(
        s["params"]["encoder"], s["batch"].x, s["batch"].edge_index,
        s["batch"].edge_type, s["batch"].edge_mask, s["batch"].block_rel,
        training=False))
    real = s["batch"].node_mask
    for out in ranks:                  # every rank holds the whole table
        for key in ("z_all_gather", "z_halo"):
            np.testing.assert_allclose(out[key], want, rtol=2e-4,
                                       atol=2e-4)
            np.testing.assert_allclose(out[key][real], single[real],
                                       rtol=2e-4, atol=2e-4)
    # the halo exchange reproduces the all_gather path
    np.testing.assert_allclose(ranks[0]["z_halo"], ranks[0]["z_all_gather"],
                               rtol=1e-6, atol=1e-6)


def test_balanced_partition_matches_after_unpermuting(setup, ranks):
    s = setup
    bal = partition_graph(s["batch"], WORLD, s["r"], block_size=64,
                          balance=True)
    z = ranks[0]["z_all_gather"]
    for key in ("z_balanced", "z_balanced_halo"):
        z_orig = np.empty_like(ranks[0][key])
        z_orig[bal.node_order] = ranks[0][key]
        np.testing.assert_allclose(z_orig, z, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("leg", ["all_gather", "halo"])
def test_training_step_matches_jax(setup, ranks, mesh, leg):
    s = setup
    plan = None if leg == "all_gather" else build_halo_plan(
        s["sharded"], s["sharded"].x.shape[1])
    params = jax.tree_util.tree_map(lambda a: jnp.array(np.asarray(a)),
                                    s["params"])
    tx = optax.adam(1e-2, eps=EPS)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = make_sharded_train_step(s["enc"], s["dec"], tx, mesh, s["r"],
                                   neg_ratio=K, halo_plan=plan)
    new_state, loss = step(state, s["sharded"], jax.random.PRNGKey(1),
                           fixed_neg=s["fixed"])
    want = flat_params(jax.tree_util.tree_map(np.asarray, new_state.params))
    for out in ranks:
        got_loss, got = out[f"train_{leg}"]
        assert abs(got_loss - float(loss)) < 1e-5, (got_loss, float(loss))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_sampled_negatives_run_in_range(setup, ranks):
    n_real = int(setup["batch"].node_mask.sum())
    for out in ranks:
        losses, lo, hi = out["sampled"]
        assert np.all(np.isfinite(losses))
        assert losses[-1] < losses[0], losses
        assert 0 <= lo and hi < n_real, (lo, hi, n_real)
    # the loss is the same on every rank
    assert len({tuple(out["sampled"][0]) for out in ranks}) == 1


def test_dropout_keeps_four_in_five(ranks):
    shares = [s for out in ranks for s in out["keep_share"]]
    assert len(shares) == WORLD * 4 * 2     # 4 steps, 2 convs before the last
    assert abs(np.mean(shares) - 0.8) < 0.02, np.mean(shares)
