"""The unseen-node protocol of the port against the JAX package on the CPU:
the synthetic generators (``planted_triplets``, ``clustered_triplets``) and
the inductive split (``unseen_node_split``, ``node_pool_for_types``) byte
for byte; a cold-start training step (``cold_start_dropout``) with JAX's
draws and keep mask injected, in the "dst" layout (the segsum path) and
the "relation" layout's edge conv (the relmm path); ``filter_negatives``
with JAX's three rounds of uniforms injected; and ``inductive_eval`` with
the same weights.

Tolerances: float32 losses 1e-5 and gradients 5e-4 relative
(tests/test_parity.py's), each negative score 1e-4 relative. The inductive
metrics: ranking and counts 1e-6 absolute; the binary ones 1e-4, since
about 9 % of their scores tie exactly (a corruption drawn twice) and a
1-ulp difference in z (the packages sum in other orders) makes or breaks
such a tie, moving AUROC by 1/(P·N) a pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.data import inductive as jax_inductive
from biomedkg_tpu.data import synthetic as jax_synthetic
from biomedkg_tpu.data.triplet import TripletGraph as JaxTripletGraph
from biomedkg_tpu.eval.inductive import inductive_eval as jax_inductive_eval
from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu_torch.data import inductive, synthetic
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.eval.inductive import inductive_eval
from biomedkg_tpu_torch.interop.jax_params import flatten_tree, \
    load_jax_params
from biomedkg_tpu_torch.sampling.batch import batch_to_device, \
    pad_graph_batch
from biomedkg_tpu_torch.training import kge_module

N_REAL, R, D_IN, D_HID, K = 40, 4, 24, 16, 3
COLD = 0.3


def _same_columns(df, columns):
    for c in synthetic.COLUMNS:
        assert np.array_equal(df[c].to_numpy().astype(str), columns[c]), c


@pytest.mark.parametrize("seed", [0, 7])
def test_generators_match_jax(seed):
    df, u = jax_synthetic.planted_triplets(num_nodes=64, num_relations=3,
                                           latent_dim=4, edges_per_head=3,
                                           seed=seed)
    columns, u2 = synthetic.planted_triplets(num_nodes=64, num_relations=3,
                                             latent_dim=4, edges_per_head=3,
                                             seed=seed)
    _same_columns(df, columns)
    assert u.tobytes() == u2.tobytes()
    df, cluster, feats = jax_synthetic.clustered_triplets(
        num_nodes=120, num_clusters=5, num_relations=3, num_edges=1500,
        seed=seed)
    columns, cluster2, feats2 = synthetic.clustered_triplets(
        num_nodes=120, num_clusters=5, num_relations=3, num_edges=1500,
        seed=seed)
    _same_columns(df, columns)
    assert cluster.tobytes() == cluster2.tobytes()
    assert feats.tobytes() == feats2.tobytes()
    for c in range(30):
        assert synthetic.cluster_token(c) == jax_synthetic.cluster_token(c)


def _assert_same_arrays(a, b, path="split"):
    if hasattr(a, "_fields") or hasattr(a, "__dataclass_fields__"):
        names = a._fields if hasattr(a, "_fields") else [
            f for f in a.__dataclass_fields__ if not f.startswith("_")]
        for f in names:
            _assert_same_arrays(getattr(a, f), getattr(b, f), f"{path}.{f}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert a == b, path


def _clustered_graphs(types=("entity", "entity"), num_nodes=120, seed=1):
    df, _, feats = jax_synthetic.clustered_triplets(
        num_nodes=num_nodes, num_clusters=4, num_relations=3,
        num_edges=1200, seed=seed)
    columns, _, _ = synthetic.clustered_triplets(
        num_nodes=num_nodes, num_clusters=4, num_relations=3,
        num_edges=1200, seed=seed)
    df.loc[:, "x_type"], df.loc[:, "y_type"] = types
    columns["x_type"] = np.full(len(columns["x_type"]), types[0])
    columns["y_type"] = np.full(len(columns["y_type"]), types[1])

    # noisy one-hots, as the reference's tests use: exact one-hots would
    # give the isolated unseen nodes of a cluster one embedding, and their
    # scores exact ties that summation order may break either way
    feats = feats + 0.05 * np.random.default_rng(seed).standard_normal(
        feats.shape).astype(np.float32)

    def encoder(names):
        return feats[np.array([int(n.split("_")[1]) for n in names])]

    return (JaxTripletGraph(df, encoder=encoder),
            TripletGraph(columns, encoder=encoder))


@pytest.mark.parametrize("types,wanted", [
    (("entity", "entity"), None), (("drug", "gene"), ["drug"])])
def test_unseen_node_split_byte_identical(types, wanted):
    jg, pg = _clustered_graphs(types)
    _assert_same_arrays(jg.graph, pg.graph, "graph")
    pools = [None, None]
    if wanted:
        pools = [jax_inductive.node_pool_for_types(
            jg.node_type_of, jg.node_type_names, wanted),
            inductive.node_pool_for_types(pg.node_type_of,
                                          pg.node_type_names, wanted)]
        _assert_same_arrays(pools[0], pools[1], "pool")
        with pytest.raises(ValueError):
            inductive.node_pool_for_types(pg.node_type_of,
                                          pg.node_type_names, ["nosuch"])
    want = jax_inductive.unseen_node_split(jg.graph, 0.15, 0.1, 0.1, seed=3,
                                           node_pool=pools[0])
    got = inductive.unseen_node_split(pg.graph, 0.15, 0.1, 0.1, seed=3,
                                      node_pool=pools[1])
    _assert_same_arrays(want, got)
    um = got.unseen_mask
    s, d = got.train.graph.edge_index
    assert not (um[s] | um[d]).any()
    assert (um[got.test_edge_index[0]] | um[got.test_edge_index[1]]).all()


def _hparams(**over):
    return dict(dict(encoder_name="rgcn", decoder_name="dismult",
                     in_dim=D_IN, hidden_dim=D_HID, out_dim=D_HID,
                     num_hidden_layers=1, num_relation=R, num_heads=2,
                     scheduler_type="cosine", learning_rate=1e-3,
                     warm_up_ratio=0.2, fuse_method="none", neg_ratio=K,
                     node_init_method="random", cold_start_dropout=COLD),
                **over)


def _batches(layout, edge_budget, seed=0):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N_REAL, 200),
                   rng.integers(0, N_REAL, 200)])
    et = rng.integers(0, R, 200)
    x = rng.standard_normal((N_REAL, D_IN)).astype(np.float32)
    kw = dict(num_relations=R, node_budget=64, edge_budget=edge_budget,
              block_size=32, num_seed=N_REAL, layout=layout)
    return (jax.tree_util.tree_map(jnp.asarray, jax_pad(x, ei, et, **kw)),
            batch_to_device(pad_graph_batch(x, ei, et, **kw), "cpu"))


def _modules(layout, **over):
    jm = jax_kge.KGEModule(**_hparams(**over))
    jm.edge_layout = layout
    params = jm.init(jax.random.PRNGKey(0))
    module = kge_module.KGEModule(**_hparams(**over))
    module.edge_layout = layout
    load_jax_params(module.model, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, module


def _jax_draws(jm, jbatch, rng, sorted_negatives=True):
    """The draws JAX's ``_forward_loss`` takes from ``rng`` (its key
    splits): the negatives, the dropout masks, the cold-start keep mask and
    the three filter rounds' uniforms."""
    _, r_enc, r_neg, r_perm, r_cold = jax.random.split(rng, 5)
    r_s, r_d = jax.random.split(r_neg)
    num_edges = jbatch.edge_type.shape[0]
    num_real = jnp.maximum(jnp.sum(jbatch.node_mask.astype(jnp.int32)), 1)

    def t(a):
        return torch.from_numpy(np.asarray(a))

    if sorted_negatives:
        ns, nd, off = jax_kge.sample_negatives_sorted(
            r_s, r_d, r_perm, jm.neg_ratio, num_edges, num_real)
        negatives = (t(ns), t(nd), t(off).long())
    else:
        shape = (jm.neg_ratio, num_edges)
        negatives = tuple(t((jax.random.uniform(r, shape) * num_real)
                            .astype(jnp.int32)).long() for r in (r_s, r_d))
    masks = []
    for _, dout in jm.model.encoder.dims[:-1]:
        r_enc, sub = jax.random.split(r_enc)
        masks.append(t(jax.random.bernoulli(
            sub, 0.8, (jbatch.node_mask.shape[0], dout))))
    keep = t(jax.random.uniform(r_cold, (jbatch.node_mask.shape[0],))
             >= jm.cold_start_dropout)
    rounds = []
    for i in range(3):
        rs2, rd2 = jax.random.split(jax.random.fold_in(r_perm, i))
        rounds.append((t(jax.random.uniform(rs2, negatives[0].shape)),
                       t(jax.random.uniform(rd2, negatives[0].shape))))
    return dict(negatives=negatives, dropout_masks=masks, cold_keep=keep,
                filter_draws=rounds)


def _compare_step(jm, params, module, jbatch, batch, rng, draws,
                  training=True):
    (loss_jax, aux_jax), grads_jax = jax.value_and_grad(
        lambda p: jm._forward_loss(p, jbatch, rng, training=training),
        has_aux=True)(params)
    named = dict(module.named_parameters())
    loss, aux = module._forward_loss(batch, training=training, **draws)
    grads = torch.autograd.grad(loss, list(named.values()))
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-5,
                               atol=1e-7)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, grads_jax))
    for name, g in zip(named, grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=5e-4,
                                   atol=1e-6, err_msg=name)
    return aux, aux_jax


@pytest.mark.parametrize("layout,edge_budget", [("dst", 256),
                                                ("relation", 224)])
def test_cold_start_step_matches_jax(layout, edge_budget):
    """The keep mask drops about 30 % of the nodes; in "relation" with
    E_pad < R·N_pad the RGCN runs its edge conv (relmm)."""
    jm, params, module = _modules(layout)
    jbatch, batch = _batches(layout, edge_budget)
    rng = jax.random.PRNGKey(7)
    draws = _jax_draws(jm, jbatch, rng)
    keep = draws["cold_keep"]
    src, dst = batch.edge_index
    dropped = batch.edge_mask & ~(keep[src] & keep[dst])
    assert 0.3 < float(dropped.sum()) / float(batch.edge_mask.sum()) < 0.7
    _compare_step(jm, params, module, jbatch, batch, rng, draws)
    # the mask is what the encoder reads: keeping every node moves the loss
    loss, _ = module._forward_loss(batch, True, **draws)
    kept_all = dict(draws, cold_keep=torch.ones_like(keep))
    assert float(module._forward_loss(batch, True, **kept_all)[0]) \
        != float(loss)


def test_cold_start_draws_its_keep_mask_from_the_generator():
    jm, _, module = _modules("dst")
    jbatch, batch = _batches("dst", 256)
    gen = torch.Generator().manual_seed(0)
    losses = {float(module._forward_loss(batch, True, gen)[0])
              for _ in range(3)}
    assert len(losses) == 3
    draws = _jax_draws(jm, jbatch, jax.random.PRNGKey(0))
    del draws["cold_keep"], draws["filter_draws"]
    with pytest.raises(ValueError, match="cold_keep"):
        module._forward_loss(batch, True, **draws)


def _observed(batch, ns, nd):
    real = batch.edge_mask.numpy()
    edges = set(zip(batch.edge_index[0].numpy()[real].tolist(),
                    batch.edge_index[1].numpy()[real].tolist()))
    return np.array([(s, d) in edges for s, d in
                     zip(ns.reshape(-1).tolist(), nd.reshape(-1).tolist())]
                    ).reshape(ns.shape)


@pytest.mark.parametrize("training", [True, False])
def test_filter_negatives_matches_jax(training):
    """With JAX's initial negatives and three rounds of uniforms injected
    the port redraws the same slots: the loss, the gradients and every
    negative score equal JAX's, and the redrawn slots equal a plain loop
    over the rounds. The batch is dense (200 edges over 40 nodes), so about
    an eighth of the draws hit a real edge; training takes the iid path."""
    jm, params, module = _modules("dst", cold_start_dropout=0.0)
    jm.filter_negatives = module.filter_negatives = True
    jbatch, batch = _batches("dst", 256, seed=2)
    rng = jax.random.PRNGKey(11)
    draws = _jax_draws(jm, jbatch, rng, sorted_negatives=False)
    del draws["cold_keep"]
    ns, nd = draws["negatives"]
    hits = _observed(batch, ns, nd)
    assert hits.sum() > 20
    num_real = int(batch.node_mask.sum())
    for u_s, u_d in draws["filter_draws"]:
        ns = torch.where(torch.from_numpy(hits), (u_s * num_real).long(), ns)
        nd = torch.where(torch.from_numpy(hits), (u_d * num_real).long(), nd)
        hits = _observed(batch, ns, nd)
    got = module._redraw_observed(batch, *draws["negatives"],
                                  batch.node_mask.sum(),
                                  draws["filter_draws"])
    assert torch.equal(got[0], ns) and torch.equal(got[1], nd)
    if not training:
        draws.pop("dropout_masks")
    aux, aux_jax = _compare_step(jm, params, module, jbatch, batch, rng,
                                 draws, training=training)
    # z differs by summation order only; a slot redrawn differently would
    # score O(1) apart
    np.testing.assert_allclose(aux["pred"].detach().numpy(),
                               np.asarray(aux_jax["pred"]), rtol=1e-4,
                               atol=1e-5)


def test_inductive_eval_matches_jax():
    jg, pg = _clustered_graphs(num_nodes=150, seed=4)
    split = jax_inductive.unseen_node_split(jg.graph, 0.15, 0.1, 0.1, seed=3)
    hp = _hparams(in_dim=4, hidden_dim=16, out_dim=8, cold_start_dropout=0.0)
    jm = jax_kge.KGEModule(**hp)
    params = jm.init(jax.random.PRNGKey(1))
    module = kge_module.KGEModule(**hp)
    load_jax_params(module.model, jax.tree_util.tree_map(np.asarray, params))
    module.edge_layout = "dst"
    want = jax_inductive_eval(jm, params, split, jg.graph, neg_ratio=4,
                              seed=5, max_rank_triples=64)
    got = inductive_eval(module, inductive.unseen_node_split(
        pg.graph, 0.15, 0.1, 0.1, seed=3), pg.graph, neg_ratio=4, seed=5,
        max_rank_triples=64)
    assert set(got) == set(want) and "unseen_mrr" in got
    for k in want:
        tol = 1e-6 if "mrr" in k or "rank" in k or "hits" in k \
            or "num" in k else 1e-4
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
