"""The port's dp × tp step (parallel/dp.py ``make_spmd_train_step``, the
modules' own ``_forward_loss`` over the tp rank's columns) on 4 gloo ranks
against the JAX package's GSPMD step (``make_spmd_train_step`` with
``kge_param_shardings``) on 4 devices of its virtual CPU mesh, one step
from the same weights, for every module the GSPMD step takes: RGCN and
RGAT, the four decoders with the "sorted", "sorted2" and iid samplers,
the module options (attention and ReDAF fusion of LM-style (N, 2, d)
features, cold-start dropout, filtered negatives, ``fix_edge_id``,
``dst_bwd`` "perm" and "agg", ``remat``), and GRACE, DGI and GGD.

The ranks start once per module (tests/test_torch_parallel_ranks.py's
``tp_worker``); each dp row's JAX draws are injected into its tp ranks, as
tests/test_torch_parallel_dp.py injects them. Tolerances: the loss 1e-5;
the gathered parameters after the step rtol 1e-5 / atol 1e-6, Adam's eps
1e-3 on both sides (test_torch_parallel_ranks.EPS); and the gradients the
optimizer took (after the dp mean, before the clip), each leaf within
GRAD_RTOL of its largest entry. The parameters alone would not show a
gradient off by a factor: the clip to norm 1 rescales a gradient that is
wrong alike everywhere, and Adam's first step moves a weight by about
±lr wherever |g| >> eps. The GCL features are scaled by 30, as
tests/test_torch_gcl.py scales them.

The hazards of the column split each have a case that would show them:
GRACE's InfoNCE runs on rows gathered whole on every rank and must enter
the gradient once (``grace``); ReDAF's ``modal_weights`` is replicated and
upstream of the split, so each rank holds part of its gradient
(``rgcn_distmult_redaf_filter_fixid_remat``); RGAT's attention logits
and TransE's L1 row norms are sums over tp that each rank uses with its
own columns, so their gradients are the sums of the ranks' parts
(``rgat_complex``, ``rgcn_transe_sorted2``); and every tp rank of a dp row must
take the same whole-width draws (``test_generator_draws_match_one_device``,
where the draws come from the generator).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from biomedkg_tpu.data.node_encoders import RandomEncode
from biomedkg_tpu.data.synthetic import synthetic_triplets
from biomedkg_tpu.data.triplet import TripletGraph
from biomedkg_tpu.models.gcl import _masked_permutation
from biomedkg_tpu.parallel.dp import make_spmd_train_step, stack_batches
from biomedkg_tpu.parallel.mesh import make_mesh
from biomedkg_tpu.parallel.sharding import kge_param_shardings
from biomedkg_tpu.sampling.loaders import SaintRandomWalkLoader
from biomedkg_tpu.training import gcl_module as jax_gcl
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu.training.optim import warmup_schedule
from biomedkg_tpu_torch.parallel.launch import run_local_ranks
from test_torch_parallel_ranks import EPS, flat_params, tp_worker

DIM, WORLD, STEPS, GCL_SCALE = 16, 4, 10, 30.0
GRAD_RTOL = 1e-4

# name → (mesh (dp, tp), KGE hparams over _hparams' or a GCL model name,
# edge layout, module attributes)
CASES = {
    "rgat_complex": ((2, 2), dict(encoder_name="rgat",
                                  decoder_name="complex"), "relation", {}),
    "rgcn_transe_sorted2": ((2, 2), dict(decoder_name="transe",
                                         neg_sampler="sorted2"), "dst", {}),
    "rgcn_rotate_1x4": ((1, 4), dict(decoder_name="rotate"), "dst", {}),
    "rgat_complex_1x4": ((1, 4), dict(encoder_name="rgat",
                                      decoder_name="complex"), "relation",
                         {}),
    "rgcn_distmult_attention_cold_perm": (
        (2, 2), dict(fuse_method="attention", node_init_method="lm",
                     cold_start_dropout=0.3), "dst", {"dst_bwd": "perm"}),
    "rgcn_distmult_redaf_filter_fixid_remat": (
        (2, 2), dict(fuse_method="redaf", node_init_method="lm",
                     remat=True), "dst",
        {"filter_negatives": True, "fix_edge_id": 1}),
    "rgcn_rotate_iid_agg": ((2, 2), dict(decoder_name="rotate",
                                         neg_sampler="iid"), "dst",
                            {"dst_bwd": "agg"}),
    "grace": ((2, 2), "grace", "dst", {}),
    "dgi": ((2, 2), "dgi", "dst", {}),
    "ggd": ((2, 2), "ggd", "dst", {}),
}
# the layouts gathered back after sharding, at tp 2 and 4
ROUND_TRIPS = {
    "rgcn_distmult": dict(fuse_method="attention", node_init_method="lm"),
    "rgat_complex": dict(encoder_name="rgat", decoder_name="complex"),
    "rgat_distmult": dict(encoder_name="rgat"),
    "rgcn_rotate": dict(decoder_name="rotate"),
    "rgcn_complex": dict(decoder_name="complex", fuse_method="redaf",
                         node_init_method="lm"),
}


def _hparams(num_relation, **over):
    return dict(dict(encoder_name="rgcn", decoder_name="dismult",
                     in_dim=DIM, hidden_dim=DIM, out_dim=DIM,
                     num_hidden_layers=1, num_relation=num_relation,
                     num_heads=2, scheduler_type="cosine",
                     learning_rate=1e-3, warm_up_ratio=0.0,
                     fuse_method="none", neg_ratio=3,
                     node_init_method="random"), **over)


def _gcl_hparams():
    return dict(in_dim=DIM, hidden_dim=DIM, out_dim=DIM,
                num_hidden_layers=1, scheduler_type="cosine",
                learning_rate=1e-3, warm_up_ratio=0.0, fuse_method="none")


def _kept_grads():
    """An identity transformation whose state is the last gradient."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _tx(hp):
    """The JAX modules' optax chain with Adam's eps set to EPS, keeping
    the gradient it took in its first state."""
    return optax.chain(
        _kept_grads(), optax.clip_by_global_norm(1.0),
        optax.scale_by_adam(eps=EPS),
        optax.scale_by_schedule(warmup_schedule(
            hp["scheduler_type"], hp["learning_rate"], STEPS,
            hp["warm_up_ratio"])),
        optax.scale(-1.0))


def _np(a):
    return np.asarray(a)


def _fields(batch):
    return {f: _np(getattr(batch, f)) for f in batch._fields}


def _masks(rng, num_nodes, dims):
    out = []
    for _, dout in dims[:-1]:
        rng, sub = jax.random.split(rng)
        out.append(_np(jax.random.bernoulli(sub, 0.8, (num_nodes, dout))))
    return out


def _kge_draws(jm, batch, rng):
    """Every draw JAX's ``_forward_loss`` takes from ``rng``
    (training/kge_module.py's key splits), as the port's keywords."""
    r_fuse, r_enc, r_neg, r_perm, r_cold = jax.random.split(rng, 5)
    r_s, r_d = jax.random.split(r_neg)
    n = batch.node_mask.shape[0]
    num_edges = batch.edge_type.shape[0]
    num_real = jnp.maximum(jnp.sum(batch.node_mask.astype(jnp.int32)), 1)
    out = {"dropout_masks": _masks(r_enc, n, jm.model.encoder.dims)}
    if jm.neg_sampler in ("sorted", "sorted2") and not jm.filter_negatives:
        ns, nd, off = jax_kge.sample_negatives_sorted(
            r_s, r_d, r_perm, jm.neg_ratio, num_edges, num_real,
            dual=jm.neg_sampler == "sorted2")
        out["negatives"] = [_np(ns), _np(nd), _np(off)]
    else:
        shape = (jm.neg_ratio, num_edges)
        out["negatives"] = [_np((jax.random.uniform(r, shape) * num_real)
                                .astype(jnp.int32)) for r in (r_s, r_d)]
    if jm.cold_start_dropout > 0.0:
        out["cold_keep"] = _np(jax.random.uniform(r_cold, (n,))
                               >= jm.cold_start_dropout)
    if jm.filter_negatives:
        rounds = []
        for i in range(3):
            rs2, rd2 = jax.random.split(jax.random.fold_in(r_perm, i))
            rounds.append([_np(jax.random.uniform(r, shape))
                           for r in (rs2, rd2)])
        out["filter_draws"] = rounds
    if jm.hparams["fuse_method"] == "redaf":
        out["fusion_keep"] = _np(jax.random.bernoulli(
            r_fuse, 0.9, batch.x.shape))
    return out


def _gcl_draws(name, jm, batch, rng):
    """The draws JAX's GCL ``_forward_loss`` takes from ``rng``
    (training/gcl_module.py, models/gcl.py)."""
    _, r_model = jax.random.split(rng)
    n, dims = batch.node_mask.shape[0], jm.encoder.dims
    x_shape, e_shape = batch.x.shape, batch.edge_mask.shape
    if name == "grace":
        rs = jax.random.split(r_model, 7)
        return {"feat_keep": [_np(jax.random.bernoulli(rs[i], 0.6, x_shape))
                              for i in (0, 1)],
                "edge_keep": [_np(jax.random.bernoulli(rs[i], 0.6, e_shape))
                              for i in (2, 3)],
                "dropout": [_masks(rs[i], n, dims) for i in (5, 6)]}
    if name == "dgi":
        r_perm, r1, r2 = jax.random.split(r_model, 3)
        return {"perm": _np(_masked_permutation(r_perm, batch.node_mask)),
                "dropout": [_masks(r, n, dims) for r in (r1, r2)]}
    rs = jax.random.split(r_model, 6)
    return {"do_aug": _np(jax.random.uniform(rs[0]) < 0.5),
            "feat_keep": _np(jax.random.bernoulli(rs[1], 0.6, x_shape)),
            "edge_keep": _np(jax.random.bernoulli(rs[2], 0.6, e_shape)),
            "perm": _np(_masked_permutation(rs[4], batch.node_mask)),
            "dropout": [_masks(rs[i], n, dims) for i in (3, 5)]}


def _jax_case(name, case, batches, num_relation, seed):
    """JAX's GSPMD step of one case: (its loss, params after the step) and
    the rank payload (the hyper-parameters, the initial params, each dp
    row's batch and draws)."""
    (dp, tp), spec, layout, attrs = case
    if isinstance(spec, str):
        hp = _gcl_hparams()
        jm = jax_gcl._GCL_CLASSES[spec](**hp)
    else:
        hp = _hparams(num_relation, **spec)
        jm = jax_kge.KGEModule(**hp)
    jm.edge_layout = layout
    for k, v in attrs.items():
        setattr(jm, k, v)
    params = jm.init(jax.random.PRNGKey(seed))
    jm.tx = _tx(hp)
    mesh = make_mesh(dp=dp, tp=tp, devices=jax.devices()[:WORLD])
    shardings = kge_param_shardings(params, mesh)
    fresh = jax.tree_util.tree_map(lambda a: jnp.array(_np(a)), params)
    placed = jax.device_put(fresh, shardings)
    state = jax_kge.TrainState(placed, jm.tx.init(placed),
                               jnp.zeros((), jnp.int32))
    rngs = jax.random.split(jax.random.PRNGKey(seed + 100), dp)
    rows = batches[:dp]
    state, loss = make_spmd_train_step(jm, mesh, shardings)(
        state, stack_batches(rows), rngs)
    if isinstance(spec, str):
        draws = [{"draws": _gcl_draws(spec, jm, b, rngs[d])}
                 for d, b in enumerate(rows)]
    else:
        draws = [_kge_draws(jm, b, rngs[d]) for d, b in enumerate(rows)]
    payload = dict(mesh=(dp, tp), model=spec, hparams=hp, layout=layout,
                   attrs=attrs, num_training_steps=STEPS,
                   params=jax.tree_util.tree_map(_np, params),
                   batches=[_fields(b) for b in rows], draws=draws)
    return (float(loss), jax.tree_util.tree_map(_np, state.params),
            jax.tree_util.tree_map(_np, state.opt_state[0])), payload


@pytest.fixture(scope="module")
def setup():
    tg = TripletGraph(synthetic_triplets(num_gene=100, num_drug=40,
                                         num_disease=30, num_edges=1200,
                                         seed=5),
                      encoder=RandomEncode(embed_dim=DIM))
    r = tg.num_edge_types
    batches = {}
    for layout in ("dst", "relation"):
        loader = SaintRandomWalkLoader(tg.graph, batch_size=8, walk_length=4,
                                       num_steps=8, block_size=32, seed=0,
                                       edge_layout=layout)
        batches[layout] = [loader.sample()[0] for _ in range(2)]
    rng = np.random.default_rng(7)
    lm = [b._replace(x=rng.standard_normal(
        (b.x.shape[0], 2, DIM)).astype(np.float32)) for b in batches["dst"]]
    gcl = [b._replace(x=_np(b.x) * GCL_SCALE) for b in batches["dst"]]
    want, payloads = {}, {}
    for seed, (name, case) in enumerate(CASES.items()):
        spec, layout = case[1], case[2]
        rows = (gcl if isinstance(spec, str) else
                lm if spec.get("node_init_method") == "lm" else
                batches[layout])
        want[name], payloads[name] = _jax_case(name, case, rows, r, seed)
    trips = {}
    for seed, (name, over) in enumerate(ROUND_TRIPS.items()):
        jm = jax_kge.KGEModule(**_hparams(r, **over))
        trips[name] = dict(hparams=_hparams(r, **over), params=jax.tree_util
                           .tree_map(_np, jm.init(jax.random.PRNGKey(seed))))
    generator = dict(trips["rgcn_complex"], batches=[_fields(b) for b in lm])
    generator["hparams"] = dict(generator["hparams"], cold_start_dropout=0.3)
    return want, dict(world=WORLD, cases=payloads, round_trips=trips,
                      generator=generator)


@pytest.fixture(scope="module")
def ranks(setup):
    return run_local_ranks(WORLD, tp_worker, (setup[1],), timeout=300)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_tp_module_step_matches_jax(setup, ranks, name):
    loss, params, grads = setup[0][name]
    want, want_grads = flat_params(params), flat_params(grads)
    for out in ranks:
        got_loss, got, got_grads = out["cases"][name]
        assert abs(got_loss - loss) < 1e-5 * max(1.0, abs(loss)), \
            (got_loss, loss)
        assert sorted(got) == sorted(want) == sorted(got_grads)
        fusion_scale = max([np.abs(w).max() for k, w in want_grads.items()
                            if k.startswith("fusion.")], default=0.0)
        for k, w in want_grads.items():
            # the attention's key bias: zero in exact arithmetic (a softmax
            # row is invariant to a shift), rounding noise in both
            # packages, held against the fuser's largest gradient
            scale = fusion_scale if k == "fusion.k.b" else np.abs(w).max()
            err = np.abs(got_grads[k] - w).max()
            assert err <= GRAD_RTOL * max(scale, 1e-30), (k, err)
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(ROUND_TRIPS))
def test_gather_undoes_shard(ranks, name, tp):
    """``gather_params(shard_params(m))`` is ``m``'s parameters, bit for
    bit, on every rank, and each split leaf's shard is 1/tp of its dim."""
    for out in ranks:
        same, shapes_ok = out["round_trips"][(name, tp)]
        assert same
        assert shapes_ok


def test_generator_draws_match_one_device(ranks):
    """With the draws from a generator (ReDAF's keep mask, dropout at
    whole width, the cold-start keep mask, the sorted negatives), each tp
    rank of a dp row seeded alike: the dp × tp step equals the dp mean of
    the module's own single-device steps with the same seeds."""
    for out in ranks:
        loss_err, params_close = out["generator"]
        assert loss_err <= 1e-5, loss_err
        assert params_close
