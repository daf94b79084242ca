"""The port's row-sharded typed step (parallel/typed_shard.py) and sharded
filtered ranking (eval/ranking.py ``mesh=``) on 4 gloo ranks against the
JAX package's on 4 devices of its virtual CPU mesh, and the port's
``dryrun_multichip(4)`` (parallel/dryrun.py), which holds each strategy
against one device itself.

The ranks start once (tests/test_torch_parallel_ranks.py). The typed step
takes JAX's negatives (its ``make_typed_batch_loss`` key splits):
the loss within 1e-5, the parameters rtol 1e-5 / atol 1e-6 after one Adam
step (eps 1e-3: test_torch_parallel_ranks.EPS). The sharded ranks equal the
port's unsharded ranks bit for bit (the same chunk and tile shapes), and
JAX's metrics with and without its mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from biomedkg_tpu.data.synthetic import synthetic_triplets
from biomedkg_tpu.data.triplet import TripletGraph
from biomedkg_tpu.eval.ranking import filtered_ranking_metrics
from biomedkg_tpu.models.decoders import DistMult
from biomedkg_tpu.models.encoders import RGCN
from biomedkg_tpu.parallel.mesh import make_mesh
from biomedkg_tpu.parallel.typed_shard import make_typed_spmd_step
from biomedkg_tpu.sampling.typed_batch import TypedSaintSampler
from biomedkg_tpu_torch.parallel.launch import run_local_ranks
from test_torch_parallel_ranks import EPS, flat_params, typed_rank_worker

D, WORLD, K = 24, 4, 4
CHUNKS = (8, 64)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    tg = TripletGraph(synthetic_triplets(num_gene=80, num_drug=40,
                                         num_disease=30, num_edges=1200,
                                         seed=5),
                      encoder=lambda ns: rng.standard_normal(
                          (len(ns), D)).astype(np.float32))
    g = tg.graph
    r = g.num_relations
    mesh4 = make_mesh(dp=WORLD, tp=1, devices=jax.devices()[:WORLD])

    sampler = TypedSaintSampler(g, tg.node_type_of, tg.node_type_names,
                                batch_size=24, walk_length=6, num_steps=2,
                                seed=1)
    batch = sampler.sample()
    flat, n_real = sampler.flat_real(batch)
    enc = RGCN(in_dim=D, hidden_dim=32, out_dim=16, num_hidden_layers=1,
               num_relations=r, drop_out=False)
    dec = DistMult(r, 16)
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"encoder": enc.init(r1), "decoder": dec.init(r2)}
    tx = optax.adam(1e-3, eps=EPS)
    key = jax.random.PRNGKey(7)
    step = make_typed_spmd_step(enc, dec, tx, mesh4, batch, neg_ratio=K)
    new, _, loss = step(params, tx.init(params), key, batch,
                        jnp.asarray(flat), n_real)
    _, r_s, r_d = jax.random.split(key, 3)
    shape = (K,) + batch.pos[2].shape
    negatives = [np.asarray(jax.random.randint(rr, shape, 0, n_real))
                 for rr in (r_s, r_d)]

    # ranking: random embeddings, the graph's edges as the known triples
    zr = np.random.default_rng(1)
    z = zr.standard_normal((g.num_nodes, 16)).astype(np.float32)
    rel_emb = zr.standard_normal((r, 16)).astype(np.float32)
    known = np.stack([g.edge_index[0], g.edge_type, g.edge_index[1]], 1)
    test = known[zr.choice(len(known), 150, replace=False)]
    jdec = DistMult(r, 16)
    jax_metrics = [
        (filtered_ranking_metrics(jdec, {"rel_emb": rel_emb}, z, test, known,
                                  chunk=c),
         filtered_ranking_metrics(jdec, {"rel_emb": rel_emb}, z, test, known,
                                  chunk=c, mesh=mesh4))
        for c in CHUNKS]

    payload = dict(
        world=WORLD,
        typed=dict(dim=D, num_rel=r,
                   params=jax.tree_util.tree_map(np.asarray, params),
                   batch={f: getattr(batch, f) for f in batch._fields},
                   flat=np.asarray(flat), n_real=int(n_real),
                   negatives=negatives),
        ranking=dict(num_rel=r, z=z, rel_emb=rel_emb, test=test,
                     known=known, chunks=CHUNKS))
    return dict(typed=(float(loss), flat_params(
        jax.tree_util.tree_map(np.asarray, new))),
        ranking=jax_metrics, payload=payload)


@pytest.fixture(scope="module")
def ranks(setup):
    return run_local_ranks(WORLD, typed_rank_worker, (setup["payload"],),
                           timeout=240)


def test_typed_sharded_step_matches_jax(setup, ranks):
    loss, want = setup["typed"]
    for out in ranks:
        got_loss, got = out["typed"]
        assert abs(got_loss - loss) < 1e-5, (got_loss, loss)
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("i", range(len(CHUNKS)),
                         ids=[f"chunk{c}" for c in CHUNKS])
def test_sharded_ranking_matches_unsharded_and_jax(setup, ranks, i):
    jax_single, jax_sharded = setup["ranking"][i]
    for out in ranks:
        single, sharded = out["ranking"][i]
        assert sharded == single          # bit for bit
        for k, v in jax_single.items():
            np.testing.assert_allclose(sharded[k], v, rtol=1e-6,
                                       err_msg=k)
            np.testing.assert_allclose(jax_sharded[k], v, rtol=1e-6,
                                       err_msg=k)


def test_dryrun_multichip_on_four_ranks(ranks):
    """Every strategy of the dry run held against one device: the
    dry run raises on a miss; here its numbers are read back."""
    out = ranks[0]["dryrun"]
    assert out["n_devices"] == WORLD
    stats = out["graph_shard"]
    assert len(stats["real_edges_per_device"]) == WORLD
    # the balanced partition evens the edges out against the contiguous
    assert stats["edge_balance_max_over_min"] \
        < stats["edge_balance_contiguous_max_over_min"]
    assert stats["halo_rows_per_pair_padded"] > 1
    assert all(r["dryrun"]["spmd_dp_tp"] == out["spmd_dp_tp"]
               for r in ranks)
    # every training leg held its loss and its updated parameters
    for leg in ("spmd_dp_tp", "shard_map_dp", "dp_scan_fused",
                "graph_sharded", "halo_exchange", "typed_sharded"):
        assert sorted(out[f"{leg}_err"]) == ["loss", "params"], leg
