"""The port's typed tables against the JAX package (biomedkg_tpu/models/
typed.py, sampling/typed_batch.py, training/typed_train.py) on
tests/test_typed.py's graph (80 genes, 40 drugs, 30 diseases, 1,500 edges,
D = 24).

Host arrays (``to_typed``, the typed SAINT batches, budgets, ``flat_real``
and ``dropped_edges``) are byte-identical; encodes hold to 2e-4 (as
tests/test_typed.py); a step's loss to 1e-5 and every gradient to 5e-4
relative, the parameters after clip + Adam to 1e-5, under JAX's
negatives and dropout masks replayed from its key splits.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from biomedkg_tpu.data.synthetic import synthetic_triplets as jax_synth
from biomedkg_tpu.data.triplet import TripletGraph as JaxTripletGraph
from biomedkg_tpu.models import typed as jax_typed
from biomedkg_tpu.models.decoders import DistMult as JaxDistMult
from biomedkg_tpu.models.encoders import RGCN as JaxRGCN
from biomedkg_tpu.sampling.typed_batch import \
    TypedSaintSampler as JaxTypedSampler
from biomedkg_tpu.training import typed_train as jax_train
from biomedkg_tpu_torch.data.synthetic import synthetic_triplets
from biomedkg_tpu_torch.data.triplet import TripletGraph
from biomedkg_tpu_torch.interop.jax_params import (flatten_tree,
                                                   tensors_from_tree)
from biomedkg_tpu_torch.models import typed
from biomedkg_tpu_torch.models.decoders import DistMult
from biomedkg_tpu_torch.models.encoders import RGCN
from biomedkg_tpu_torch.sampling.batch import batch_to_device
from biomedkg_tpu_torch.sampling.loaders import FullGraphLoader
from biomedkg_tpu_torch.sampling.typed_batch import TypedSaintSampler
from biomedkg_tpu_torch.train_kge import main as train_kge_main
from biomedkg_tpu_torch.training import typed_train

D = 24
SIZES = dict(num_gene=80, num_drug=40, num_disease=30, num_edges=1500,
             seed=9)
ENC = dict(in_dim=D, hidden_dim=32, out_dim=16, num_hidden_layers=1)
K = 4
LR = 1e-2


def _features():
    rng = np.random.default_rng(0)
    return lambda ns: rng.standard_normal((len(ns), D)).astype(np.float32)


@pytest.fixture(scope="module")
def graphs():
    jg = JaxTripletGraph(jax_synth(**SIZES), encoder=_features())
    tg = TripletGraph(synthetic_triplets(**SIZES), encoder=_features())
    np.testing.assert_array_equal(jg.graph.x, tg.graph.x)
    return jg, tg


def _models(num_relations, drop_out=False):
    """JAX's RGCN + DistMult params and the port's modules holding them."""
    jenc = JaxRGCN(**ENC, num_relations=num_relations, drop_out=drop_out)
    jdec = JaxDistMult(num_relations, ENC["out_dim"])
    r1, r2 = jax.random.split(jax.random.PRNGKey(0))
    params = {"encoder": jenc.init(r1), "decoder": jdec.init(r2)}
    enc = RGCN(**ENC, num_relations=num_relations, drop_out=drop_out)
    dec = DistMult(num_relations, ENC["out_dim"])
    np_params = jax.tree_util.tree_map(np.asarray, params)
    with torch.no_grad():
        for module, tree in ((enc, np_params["encoder"]),
                             (dec, np_params["decoder"])):
            tensors = tensors_from_tree(module, tree)
            for name, p in module.named_parameters():
                p.copy_(tensors[name])
    return jenc, jdec, params, enc, dec


def _named(enc, dec):
    return {**{f"encoder.{n}": p for n, p in enc.named_parameters()},
            **{f"decoder.{n}": p for n, p in dec.named_parameters()}}


def _jax_masks(rng, dims, sizes, order):
    """The keep masks JAX's typed encodes draw: a split per table, in
    ``order``, after each hidden conv."""
    masks = []
    for _, dout in dims[:-1]:
        layer = {}
        for t in order:
            rng, sub = jax.random.split(rng)
            layer[t] = torch.from_numpy(np.array(
                jax.random.bernoulli(sub, 0.8, (sizes[t], dout))))
        masks.append(layer)
    return masks


def _assert_step(loss, grads, named, jloss, jgrads):
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5,
                               atol=1e-7)
    want = {f"{part}.{k}": v for part in ("encoder", "decoder")
            for k, v in flatten_tree(jax.tree_util.tree_map(
                np.asarray, jgrads[part])).items()}
    assert set(want) == set(named)
    for (name, _), g in zip(named.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[name], rtol=5e-4,
                                   atol=1e-6, err_msg=name)


def _assert_params(named, jparams):
    want = {f"{part}.{k}": v for part in ("encoder", "decoder")
            for k, v in flatten_tree(jax.tree_util.tree_map(
                np.asarray, jparams[part])).items()}
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def _port_typed(tg):
    return typed.to_typed(tg.graph, tg.type_offset, tg.node_type_of)


def test_to_typed_is_byte_identical(graphs):
    jg, tg = graphs
    want, got = jax_typed.to_typed(jg), _port_typed(tg)
    assert got.type_names == want.type_names
    assert got.type_offset == want.type_offset
    assert got.num_relations == want.num_relations
    assert got.num_nodes == want.num_nodes == tg.graph.num_nodes
    for t in want.type_names:
        assert got.x[t].tobytes() == np.asarray(want.x[t]).tobytes()
        assert got.counts[t].tobytes() == want.counts[t].tobytes()
    assert list(got.sigs) == list(want.sigs)
    assert len(got.sigs) >= tg.graph.num_relations
    for key, (sl, dl) in want.sigs.items():
        assert got.sigs[key][0].dtype == sl.dtype
        assert got.sigs[key][0].tobytes() == sl.tobytes()
        assert got.sigs[key][1].tobytes() == dl.tobytes()
        assert (np.diff(dl) >= 0).all()


def _assert_batches_equal(got, want):
    assert list(got.x) == list(want.x)
    for t in want.x:
        for field in ("x", "nodes", "counts"):
            a, b = getattr(got, field)[t], getattr(want, field)[t]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
        assert int(got.num_nodes[t]) == int(want.num_nodes[t])
    assert list(got.sigs) == list(want.sigs)
    for k in want.sigs:
        assert got.sigs[k].tobytes() == want.sigs[k].tobytes(), k
    assert got.pos.tobytes() == want.pos.tobytes()


@pytest.mark.parametrize("squeeze", [False, True])
def test_typed_saint_sampler_is_byte_identical(graphs, squeeze):
    """Budgets, every batch of two epochs, ``flat_real`` and
    ``dropped_edges``; ``squeeze`` halves the signature and supervision
    budgets so the overflow subsets (``rng.choice``) are drawn."""
    jg, tg = graphs
    kw = dict(batch_size=24, walk_length=6, num_steps=3, seed=3)
    jax_s = JaxTypedSampler(jg.graph, jg.node_type_of, jg.node_type_names,
                            **kw)
    budgets = None
    if squeeze:
        budgets = {"nodes": dict(jax_s.node_budget),
                   "sigs": {k: max(8, v // 2)
                            for k, v in jax_s.sig_budget.items()},
                   "pos": max(128, jax_s.pos_budget // 2)}
        jax_s = JaxTypedSampler(jg.graph, jg.node_type_of,
                                jg.node_type_names, budgets=budgets, **kw)
    port_s = TypedSaintSampler(tg.graph, tg.node_type_of,
                               tg.node_type_names, budgets=budgets, **kw)
    assert port_s.node_budget == jax_s.node_budget
    assert port_s.sig_budget == jax_s.sig_budget
    assert port_s.pos_budget == jax_s.pos_budget
    assert port_s.type_base == jax_s.type_base
    for epoch in (0, 1):
        jax_s.set_epoch(epoch)
        port_s.set_epoch(epoch)
        for got, want in zip(port_s, jax_s):
            _assert_batches_equal(got, want)
            for a, b in zip(port_s.flat_real(got), jax_s.flat_real(want)):
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert port_s.dropped_edges == jax_s.dropped_edges
    assert (port_s.dropped_edges > 0) == squeeze


def test_typed_encode_matches_jax_with_dropout(graphs):
    jg, tg = graphs
    jenc, _, params, enc, _ = _models(tg.graph.num_relations, drop_out=True)
    jt, pt = jax_typed.to_typed(jg), _port_typed(tg)
    rng = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, r: jax_typed.typed_encode(
        p, jt, rng=r, training=True, drop_out=True))(params["encoder"], rng)
    sizes = {t: v.shape[0] for t, v in pt.x.items()}
    masks = _jax_masks(rng, jenc.dims, sizes, list(pt.x))
    got = typed.typed_encode(enc, typed.typed_to_device(pt, "cpu"),
                             training=True, drop_out=True,
                             dropout_masks=masks)
    for t in pt.type_names:
        np.testing.assert_allclose(got[t].detach().numpy(),
                                   np.asarray(want[t]), rtol=2e-4,
                                   atol=2e-4, err_msg=t)


def test_typed_encode_batch_matches_jax_with_dropout(graphs):
    jg, tg = graphs
    jenc, _, params, enc, _ = _models(tg.graph.num_relations, drop_out=True)
    kw = dict(batch_size=16, walk_length=4, num_steps=2, seed=3)
    jb = JaxTypedSampler(jg.graph, jg.node_type_of, jg.node_type_names,
                         **kw).sample()
    pb = TypedSaintSampler(tg.graph, tg.node_type_of, tg.node_type_names,
                           **kw).sample()
    rng = jax.random.PRNGKey(6)
    want = jax.jit(lambda p, r: jax_typed.typed_encode_batch(
        p, jb, rng=r, training=True, drop_out=True))(params["encoder"], rng)
    sizes = {t: v.shape[0] for t, v in pb.x.items()}
    masks = _jax_masks(rng, jenc.dims, sizes, sorted(pb.x))
    got = typed.typed_encode_batch(enc, typed.typed_batch_to_device(pb,
                                                                    "cpu"),
                                   training=True, drop_out=True,
                                   dropout_masks=masks)
    for t in pb.x:
        np.testing.assert_allclose(got[t].detach().numpy(),
                                   np.asarray(want[t]), rtol=2e-4,
                                   atol=2e-4, err_msg=t)


def test_typed_encode_matches_the_ports_homogeneous_rgcn(graphs):
    _, tg = graphs
    g = tg.graph
    enc = RGCN(**ENC, num_relations=g.num_relations, drop_out=False)
    enc.init(torch.Generator().manual_seed(0))
    enc.edge_layout = "dst"
    batch = batch_to_device(FullGraphLoader(g, edge_layout="dst").batch(),
                            "cpu")
    with torch.no_grad():
        ref = enc(batch.x, batch.edge_index, batch.edge_type,
                  batch.edge_mask)[:g.num_nodes]
        pt = typed.typed_to_device(_port_typed(tg), "cpu")
        z = typed.concat_tables(typed.typed_encode(enc, pt), pt.type_names)
    np.testing.assert_allclose(z.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def _jax_full_loss(jt, jenc, jdec, src, dst, rel, n):
    def loss_fn(p, rng):
        z = jax_typed.concat_tables(jax_typed.typed_encode(p["encoder"], jt),
                                    jt.type_names)
        pos = jdec.score(p["decoder"], z, src, dst, rel)
        r_s, r_d = jax.random.split(rng)
        ns = jax.random.randint(r_s, (K,) + rel.shape, 0, n)
        nd = jax.random.randint(r_d, (K,) + rel.shape, 0, n)
        neg = jdec.score_neg(p["decoder"], z, ns, nd, rel).reshape(-1)
        pred = jnp.concatenate([pos, neg])
        gt = jnp.concatenate([jnp.ones_like(pos), jnp.zeros_like(neg)])
        bce = jnp.mean(-(gt * jax.nn.log_sigmoid(pred)
                         + (1 - gt) * jax.nn.log_sigmoid(-pred)))
        reg = sum(jnp.mean(v ** 2)
                  for v in jax.tree_util.tree_leaves(p["decoder"]))
        return bce + 1e-2 * (jnp.mean(z ** 2) + reg)

    return loss_fn


def test_full_batch_step_matches_jax(graphs):
    """typed_full_train's step (the JAX loss of training/typed_train.py:
    57-73, written out) under JAX's negatives: loss, gradients, and the
    parameters after clip + Adam, twice."""
    jg, tg = graphs
    g = tg.graph
    jenc, jdec, params, enc, dec = _models(g.num_relations)
    jt = jax_typed.to_typed(jg)
    pt = typed.typed_to_device(_port_typed(tg), "cpu")
    src, dst, rel = (g.edge_index[0].astype(np.int32),
                     g.edge_index[1].astype(np.int32),
                     g.edge_type.astype(np.int32))
    n = pt.num_nodes
    loss_fn = _jax_full_loss(jt, jenc, jdec, *map(jnp.asarray,
                                                   (src, dst, rel)), n)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    opt = tx.init(params)
    port_tx = typed_train.typed_optimizer(LR)
    named = _named(enc, dec)
    port_opt = port_tx.init(list(named.values()))
    t_src, t_dst, t_rel = (torch.from_numpy(a).long()
                           for a in (src, dst, rel))
    key = jax.random.PRNGKey(2)
    for _ in range(2):
        key, r = jax.random.split(key)
        jloss, jgrads = value_and_grad(params, r)
        r_s, r_d = jax.random.split(r)
        ns = np.asarray(jax.random.randint(r_s, (K, len(rel)), 0, n))
        nd = np.asarray(jax.random.randint(r_d, (K, len(rel)), 0, n))
        loss = typed_train.full_batch_loss(
            enc, dec, pt, t_src, t_dst, t_rel,
            torch.from_numpy(ns).long(), torch.from_numpy(nd).long())
        grads = torch.autograd.grad(loss, list(named.values()),
                                    retain_graph=True)
        _assert_step(loss, grads, named, jloss, jgrads)
        updates, opt = tx.update(jgrads, opt, params)
        params = optax.apply_updates(params, updates)
        port_opt = typed_train.typed_update(loss, named, port_tx, port_opt)
        _assert_params(named, params)


def test_typed_saint_step_matches_jax(graphs):
    """make_typed_batch_loss with dropout (JAX's masks and negatives
    replayed from its key splits): loss, gradients and the parameters
    after clip + Adam."""
    jg, tg = graphs
    jenc, jdec, params, enc, dec = _models(tg.graph.num_relations,
                                           drop_out=True)
    kw = dict(batch_size=24, walk_length=6, num_steps=2, seed=1)
    jax_s = JaxTypedSampler(jg.graph, jg.node_type_of, jg.node_type_names,
                            **kw)
    port_s = TypedSaintSampler(tg.graph, tg.node_type_of,
                               tg.node_type_names, **kw)
    value_and_grad = jax.jit(jax.value_and_grad(
        jax_train.make_typed_batch_loss(jenc, jdec, K)))
    loss_fn = typed_train.make_typed_batch_loss(enc, dec, K)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(LR))
    opt = tx.init(params)
    port_tx = typed_train.typed_optimizer(LR)
    named = _named(enc, dec)
    port_opt = port_tx.init(list(named.values()))
    key = jax.random.PRNGKey(7)
    for jb, pb in zip(jax_s, port_s):
        flat, n_real = jax_s.flat_real(jb)
        key, rng = jax.random.split(key)
        jloss, jgrads = value_and_grad(params, rng, jb, jnp.asarray(flat),
                                       n_real)
        r_drop, r_s, r_d = jax.random.split(rng, 3)
        sizes = {t: v.shape[0] for t, v in pb.x.items()}
        masks = _jax_masks(r_drop, jenc.dims, sizes, sorted(pb.x))
        shape = (K, pb.pos.shape[1])
        negatives = tuple(torch.from_numpy(np.asarray(
            jax.random.randint(r, shape, 0, n_real))).long()
            for r in (r_s, r_d))
        pflat, pn = typed_train.flat_real_to_device(port_s, pb, "cpu")
        loss = loss_fn(typed.typed_batch_to_device(pb, "cpu"), pflat, pn,
                       negatives=negatives, dropout_masks=masks)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    retain_graph=True)
        _assert_step(loss, grads, named, jloss, jgrads)
        updates, opt = tx.update(jgrads, opt, params)
        params = optax.apply_updates(params, updates)
        port_opt = typed_train.typed_update(loss, named, port_tx, port_opt)
        _assert_params(named, params)


def test_batch_loss_refuses_without_draws(graphs):
    _, tg = graphs
    _, _, _, enc, dec = _models(tg.graph.num_relations, drop_out=True)
    s = TypedSaintSampler(tg.graph, tg.node_type_of, tg.node_type_names,
                          batch_size=8, walk_length=3, num_steps=1, seed=0)
    b = s.sample()
    flat, n = typed_train.flat_real_to_device(s, b, "cpu")
    with pytest.raises(ValueError, match="torch.Generator"):
        typed_train.make_typed_batch_loss(enc, dec, K)(
            typed.typed_batch_to_device(b, "cpu"), flat, n)


class _Split:
    def __init__(self, ei, et):
        self.label_edge_index, self.label_edge_type = ei, et


class _Data:
    def __init__(self, g):
        self.test_data = _Split(g.edge_index[:, ::3], g.edge_type[::3])


def test_binary_test_metrics_match_jax(graphs, capsys):
    """The same negatives (numpy ``default_rng(seed)``) and metrics; the
    scores agree to float32 rounding, which can reorder near-tied scores,
    so the metrics hold to 1e-4."""
    jg, tg = graphs
    jenc, jdec, params, enc, dec = _models(tg.graph.num_relations)
    want = jax_train._typed_binary_test(params, jax_typed.to_typed(jg),
                                        jenc, jdec, _Data(jg.graph), K, 4)
    got = typed_train._typed_binary_test(
        enc, dec, typed.typed_to_device(_port_typed(tg), "cpu"),
        _Data(tg.graph), K, 4)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-4,
                                   err_msg=k)
    assert "typed-table test metrics:" in capsys.readouterr().out


def test_typed_encode_refuses_rgat(graphs):
    from biomedkg_tpu_torch.models.encoders import RGAT

    _, tg = graphs
    rgat = RGAT(**ENC, num_relations=tg.graph.num_relations)
    with pytest.raises(ValueError, match="RGCN"):
        typed.typed_encode(rgat, typed.typed_to_device(_port_typed(tg),
                                                       "cpu"))


@pytest.mark.parametrize("loader", ["full", "saint"])
def test_train_kge_typed_tables_trains(tmp_path, monkeypatch, capsys,
                                       loader):
    """``train_kge typed_tables=true`` (and ``typed_loader=saint``) end to
    end on the CPU over the small default graph: the loss falls, the test
    metrics print, no checkpoint is written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BIOMEDKG_SYNTHETIC_SCALE", raising=False)
    steps = 30 if loader == "full" else 101
    # small ops on one thread: a thread pool a step would wait on the
    # other test workers' cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = train_kge_main([
            "typed_tables=true", f"typed_loader={loader}",
            f"typed_steps={steps}", "epochs=1", "device=cpu", "seed=3",
            "data.embed_dim=16", "model.hidden_dim=16", "model.out_dim=16",
            "model.num_hidden_layers=0", "model.learning_rate=0.01",
            "data.batch_size=32", f"ckpt_dir={tmp_path / 'ck'}"])
    finally:
        torch.set_num_threads(threads)
    text = capsys.readouterr().out
    losses = [float(v) for v in re.findall(r"loss=([0-9.]+)", text)]
    assert len(losses) == 2, text
    assert losses[-1] < losses[0] - 0.05, losses
    assert "typed-table test metrics:" in text
    assert 0.5 < out["test_AUROC"] <= 1.0, out
    assert not (tmp_path / "ck").exists()
