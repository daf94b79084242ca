"""The port's data-parallel steps (parallel/dp.py) on 4 gloo ranks against
the JAX package's on 4 devices of its virtual CPU mesh: one dp step, k = 2
dp steps in one call, a GRACE dp step, and the dp × tp step on a (2, 2)
mesh; and the Trainer with ``devices=4`` in a group of 4 ranks.

The ranks start once per fixture (tests/test_torch_parallel_ranks.py).
The JAX draws of each rank (its sorted negatives and dropout masks, GRACE's
feature, edge and dropout masks) are injected into the port's steps, as
tests/test_torch_train_step.py and tests/test_torch_gcl.py inject them.
Tolerances: the loss 1e-5; the parameters after the steps rtol 1e-5 /
atol 1e-6, Adam's eps 1e-3 on both sides (test_torch_parallel_ranks.EPS:
the update follows the gradient's size). GRACE's features are scaled by 30,
as tests/test_torch_gcl.py scales them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from biomedkg_tpu.data.node_encoders import RandomEncode
from biomedkg_tpu.data.synthetic import synthetic_triplets
from biomedkg_tpu.data.triplet import TripletGraph
from biomedkg_tpu.parallel.dp import (make_dp_train_step,
                                      make_dp_train_steps_scan,
                                      make_spmd_train_step, stack_batches,
                                      stack_batch_groups)
from biomedkg_tpu.parallel.mesh import make_mesh
from biomedkg_tpu.parallel.sharding import kge_param_shardings
from biomedkg_tpu.sampling.loaders import SaintRandomWalkLoader
from biomedkg_tpu.training import gcl_module as jax_gcl
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu.training.optim import warmup_schedule
from biomedkg_tpu_torch.parallel.launch import run_local_ranks
from test_torch_parallel_ranks import (EPS, dp_worker, flat_params,
                                       trainer_worker)

DIM, WORLD, STEPS = 16, 4, 10


def _hparams(num_relation):
    return dict(encoder_name="rgcn", decoder_name="dismult", in_dim=DIM,
                hidden_dim=DIM, out_dim=DIM, num_hidden_layers=1,
                num_relation=num_relation, num_heads=2,
                scheduler_type="cosine", learning_rate=1e-3,
                warm_up_ratio=0.0, fuse_method="none", neg_ratio=3,
                node_init_method="random")


def _tx(hp):
    """The JAX modules' optax chain with Adam's eps set to EPS."""
    return optax.chain(
        optax.clip_by_global_norm(1.0), optax.scale_by_adam(eps=EPS),
        optax.scale_by_schedule(warmup_schedule(
            hp["scheduler_type"], hp["learning_rate"], STEPS,
            hp["warm_up_ratio"])),
        optax.scale(-1.0))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fields(batch):
    return {f: np.asarray(getattr(batch, f)) for f in batch._fields}


def _kge_draws(jm, batch, rng):
    """The sorted negatives and dropout masks ``_forward_loss`` draws from
    ``rng`` (training/kge_module.py's key splits)."""
    _, r_enc, r_neg, r_perm, _ = jax.random.split(rng, 5)
    r_s, r_d = jax.random.split(r_neg)
    num_real = jnp.maximum(jnp.sum(batch.node_mask.astype(jnp.int32)), 1)
    ns, nd, off = jax_kge.sample_negatives_sorted(
        r_s, r_d, r_perm, jm.neg_ratio, batch.edge_type.shape[0], num_real)
    masks = []
    for _, dout in jm.model.encoder.dims[:-1]:
        r_enc, sub = jax.random.split(r_enc)
        masks.append(np.asarray(jax.random.bernoulli(
            sub, 0.8, (batch.node_mask.shape[0], dout))))
    return {"negatives": [np.asarray(a) for a in (ns, nd, off)],
            "masks": masks}


def _enc_masks(rng, num_nodes, dims):
    masks = []
    for _, dout in dims[:-1]:
        rng, sub = jax.random.split(rng)
        masks.append(np.asarray(jax.random.bernoulli(sub, 0.8,
                                                     (num_nodes, dout))))
    return masks


def _grace_draws(jm, batch, rng):
    """GRACE's draws from ``rng`` (tests/test_torch_gcl.py)."""
    _, r_model = jax.random.split(rng)
    rs = jax.random.split(r_model, 7)
    n = batch.node_mask.shape[0]
    return {"feat_keep": [np.asarray(jax.random.bernoulli(
                rs[i], 0.6, batch.x.shape)) for i in (0, 1)],
            "edge_keep": [np.asarray(jax.random.bernoulli(
                rs[i], 0.6, batch.edge_mask.shape)) for i in (2, 3)],
            "dropout": [_enc_masks(rs[i], n, jm.encoder.dims)
                        for i in (5, 6)]}


def _fresh(params):
    return jax.tree_util.tree_map(lambda a: jnp.array(np.asarray(a)), params)


@pytest.fixture(scope="module")
def setup():
    tg = TripletGraph(synthetic_triplets(num_gene=100, num_drug=40,
                                         num_disease=30, num_edges=1200,
                                         seed=5),
                      encoder=RandomEncode(embed_dim=DIM))
    loader = SaintRandomWalkLoader(tg.graph, batch_size=8, walk_length=4,
                                   num_steps=64, block_size=32, seed=0,
                                   edge_layout="dst")
    hp = _hparams(tg.num_edge_types)
    jm = jax_kge.KGEModule(**hp)
    jm.edge_layout = "dst"
    params = jm.init(jax.random.PRNGKey(0))
    jm.tx = _tx(hp)
    batches = [loader.sample()[0] for _ in range(3 * WORLD)]
    dp_batches, scan_batches = batches[:WORLD], batches[WORLD:]
    mesh4 = make_mesh(dp=WORLD, tp=1, devices=jax.devices()[:WORLD])
    out = {"hp": hp, "jm": jm, "params": params}

    # one dp step
    rngs = jax.random.split(jax.random.PRNGKey(1), WORLD)
    state = jax_kge.TrainState(_fresh(params), jm.tx.init(params),
                               jnp.zeros((), jnp.int32))
    state, loss = make_dp_train_step(jm, mesh4)(
        state, stack_batches(dp_batches), rngs)
    out["dp"] = (float(loss), _np_tree(state.params))
    dp_draws = [_kge_draws(jm, b, rngs[r]) for r, b in enumerate(dp_batches)]

    # k = 2 steps in one call: step j of rank r takes batch j·dp + r
    groups = [scan_batches[j * WORLD:(j + 1) * WORLD] for j in range(2)]
    rngs2 = jax.random.split(jax.random.PRNGKey(2), 2 * WORLD).reshape(
        2, WORLD, -1)
    state = jax_kge.TrainState(_fresh(params), jm.tx.init(params),
                               jnp.zeros((), jnp.int32))
    state, loss = make_dp_train_steps_scan(jm, mesh4, 2)(
        state, stack_batch_groups([stack_batches(g) for g in groups]), rngs2)
    out["scan"] = (float(loss), int(state.step), _np_tree(state.params))
    scan_draws = [[_kge_draws(jm, groups[j][r], rngs2[j, r])
                   for j in range(2)] for r in range(WORLD)]

    # dp × tp on (2, 2) with the package's tensor-parallel layout
    mesh22 = make_mesh(dp=2, tp=2, devices=jax.devices()[:WORLD])
    shardings = kge_param_shardings(params, mesh22)
    placed = jax.device_put(_fresh(params), shardings)
    state = jax_kge.TrainState(placed, jm.tx.init(placed),
                               jnp.zeros((), jnp.int32))
    rngs3 = jax.random.split(jax.random.PRNGKey(3), 2)
    state, loss = make_spmd_train_step(jm, mesh22, shardings)(
        state, stack_batches(dp_batches[:2]), rngs3)
    out["tp"] = (float(loss), _np_tree(state.params))
    tp_draws = [_kge_draws(jm, dp_batches[d], rngs3[d]) for d in range(2)]

    # GRACE, features scaled by 30
    ghp = dict(in_dim=DIM, hidden_dim=DIM, out_dim=DIM, num_hidden_layers=1,
               scheduler_type="cosine", learning_rate=1e-3,
               warm_up_ratio=0.0, fuse_method="none")
    gm = jax_gcl.GRACEModule(**ghp)
    gm.edge_layout = "dst"
    gparams = gm.init(jax.random.PRNGKey(4))
    gm.tx = _tx(ghp)
    gbatches = [b._replace(x=np.asarray(b.x) * 30.0) for b in dp_batches]
    rngs4 = jax.random.split(jax.random.PRNGKey(5), WORLD)
    state = jax_kge.TrainState(_fresh(gparams), gm.tx.init(gparams),
                               jnp.zeros((), jnp.int32))
    state, loss = make_dp_train_step(gm, mesh4)(
        state, stack_batches(gbatches), rngs4)
    out["grace"] = (float(loss), _np_tree(state.params))

    out["payload"] = dict(
        world=WORLD, hparams=hp, params=_np_tree(params),
        num_training_steps=STEPS, eps=EPS,
        dp_batches=[_fields(b) for b in dp_batches], dp_draws=dp_draws,
        scan_batches=[[_fields(groups[j][r]) for j in range(2)]
                      for r in range(WORLD)], scan_draws=scan_draws,
        tp_draws=tp_draws,
        grace=dict(hparams=ghp, params=_np_tree(gparams),
                   num_training_steps=STEPS,
                   batches=[_fields(b) for b in gbatches],
                   draws=[_grace_draws(gm, b, rngs4[r])
                          for r, b in enumerate(gbatches)]))
    return out


@pytest.fixture(scope="module")
def ranks(setup):
    return run_local_ranks(WORLD, dp_worker, (setup["payload"],),
                           timeout=240)


def _assert_params(got, want_tree, prefix=""):
    want = {prefix + k: v for k, v in flat_params(want_tree).items()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_dp_step_matches_jax(setup, ranks):
    loss, params = setup["dp"]
    for out in ranks:
        got_loss, got = out["dp"]
        assert abs(got_loss - loss) < 1e-5, (got_loss, loss)
        _assert_params({"model." + k: v for k, v in got.items()}, params)


def test_dp_scan_matches_jax(setup, ranks):
    loss, steps, params = setup["scan"]
    assert steps == 2
    for out in ranks:
        got_loss, got_steps, got = out["scan"]
        assert got_steps == steps
        assert abs(got_loss - loss) < 1e-5, (got_loss, loss)
        _assert_params({"model." + k: v for k, v in got.items()}, params)


def test_grace_dp_step_matches_jax(setup, ranks):
    loss, params = setup["grace"]
    for out in ranks:
        got_loss, got = out["grace"]
        assert abs(got_loss - loss) < 1e-5 * max(1.0, abs(loss)), \
            (got_loss, loss)
        _assert_params({"model." + k: v for k, v in got.items()}, params)


def test_dp_tp_step_matches_jax(setup, ranks):
    loss, params = setup["tp"]
    for out in ranks:
        got_loss, got = out["tp"]
        assert abs(got_loss - loss) < 1e-5, (got_loss, loss)
        _assert_params(got, params)


def test_trainer_devices_trains_data_parallel():
    """``devices=4`` in a group of 4 ranks: 8 batches an epoch make 2
    optimizer steps; every rank logs the same losses and ends with the
    same weights."""
    hp = dict(_hparams(0), warm_up_ratio=0.2)
    outs = run_local_ranks(WORLD, trainer_worker,
                           ({"world": WORLD, "hparams": hp, "steps": 8},),
                           timeout=240)
    assert all(o["global_step"] == 4 for o in outs)
    assert len({tuple(o["losses"]) for o in outs}) == 1
    assert all(np.isfinite(outs[0]["losses"]))
    assert len({o["checksum"] for o in outs}) == 1
