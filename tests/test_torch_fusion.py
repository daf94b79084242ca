"""Modality fusion in the port against the JAX package: AttentionFusion,
ReDAF (eval, and training with JAX's dropout keep mask injected) and
PositionalEncoding; the modality mean the modules take without a fuser
(features (N, 1, d) and (N, 2, d), ``fuse_method="none"``: z and the
loss); one KGE step (RGCN, LM features, attention / redaf / none) and one
GCL step (GGD and GRACE with attention fusion): the loss and every
gradient, the fusion parameters' included, with the weights carried by
interop/jax_params.py and the JAX package's draws replayed from its key
splits; and the fused ``encode`` of both modules.

Tolerances as tests/test_parity.py: z 1e-4 of max|z|, the loss 1e-5
relative, gradients 5e-4 of their max; the fusion modules alone 1e-5.
The GCL steps scale the features by 30, as tests/test_torch_gcl.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.models import fusion as jax_fusion
from biomedkg_tpu.models.gcl import _masked_permutation
from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.training import gcl_module as jax_gcl
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu_torch.interop.jax_params import flatten_tree, \
    load_jax_params, tensors_from_tree, to_jax_params
from biomedkg_tpu_torch.models import fusion
from biomedkg_tpu_torch.models.factory import FusionFactory
from biomedkg_tpu_torch.sampling.batch import batch_to_device, \
    pad_graph_batch
from biomedkg_tpu_torch.training import gcl_module, kge_module
from biomedkg_tpu_torch.training.stepping import param_grads

N_REAL, R, D_IN, D_HID = 40, 4, 24, 16
NODE_BUDGET = 64
NEG_RATIO = 3
GCL_SCALE = 30.0
Z_RTOL, LOSS_RTOL, GRAD_RTOL, FUSION_RTOL = 1e-4, 1e-5, 5e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (err, rtol)


# -- the fusion modules ------------------------------------------------------

def _fusers(method, d=D_IN, m=2):
    jf = (jax_fusion.AttentionFusion(d) if method == "attention"
          else jax_fusion.ReDAF(d, m))
    params = jf.init(jax.random.PRNGKey(7))
    pf = (fusion.AttentionFusion(d) if method == "attention"
          else fusion.ReDAF(d, m))
    with torch.no_grad():
        for name, p in pf.named_parameters():
            p.copy_(tensors_from_tree(pf, _np(params))[name])
    return jf, params, pf


@pytest.mark.parametrize("m", [1, 2])
def test_attention_fusion_matches_jax(m):
    jf, params, pf = _fusers("attention", m=m)
    x = np.random.default_rng(m).standard_normal(
        (N_REAL, m, D_IN)).astype(np.float32)
    want = jf.apply(params, jnp.asarray(x))
    _close(pf(_t(x)).detach().numpy(), want, FUSION_RTOL)
    assert pf(_t(x)).shape == (N_REAL, D_IN)


@pytest.mark.parametrize("training", [False, True])
def test_redaf_matches_jax(training):
    jf, params, pf = _fusers("redaf")
    with torch.no_grad():          # learned weights, not the init's ones
        pf.modal_weights.uniform_(0.5, 1.5,
                                  generator=torch.Generator().manual_seed(0))
    params = dict(params, modal_weights=jnp.asarray(
        pf.modal_weights.detach().numpy()))
    x = np.random.default_rng(3).standard_normal(
        (N_REAL, 2, D_IN)).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    want = jf.apply(params, jnp.asarray(x), rng=rng, training=training)
    keep = None
    if training:
        keep = _t(jax.random.bernoulli(rng, 0.9, (N_REAL, 2, D_IN)))
        assert tuple(pf.keep_shape(_t(x))) == (N_REAL, 2, D_IN)
    got = pf(_t(x), keep, training=training)
    _close(got.detach().numpy(), want, FUSION_RTOL)
    gen = torch.Generator().manual_seed(0)
    assert pf.draw_keep(_t(x), gen, False) is None
    drawn = pf.draw_keep(_t(x), gen, True)
    assert drawn.shape == (N_REAL, 2, D_IN) and 0.8 < drawn.float().mean() \
        < 0.97


@pytest.mark.parametrize("training", [False, True])
def test_positional_encoding_matches_jax(training):
    jpe = jax_fusion.PositionalEncoding(D_IN, max_len=64)
    pe = fusion.PositionalEncoding(D_IN, max_len=64)
    _close(pe.pe.numpy(), jpe.pe, 1e-6)
    x = np.random.default_rng(5).standard_normal(
        (3, 10, D_IN)).astype(np.float32)
    rng = jax.random.PRNGKey(2)
    want = jpe.apply(jnp.asarray(x), rng=rng, training=training)
    keep = (_t(jax.random.bernoulli(rng, 0.9, x.shape)) if training
            else None)
    _close(pe(_t(x), keep, training=training).numpy(), want, 1e-6)
    with pytest.raises(ValueError, match="even"):
        fusion.PositionalEncoding(7)


def test_fusion_factory():
    assert isinstance(FusionFactory.create_fuser("attention", 8),
                      fusion.AttentionFusion)
    assert isinstance(FusionFactory.create_fuser("redaf", 8), fusion.ReDAF)
    assert FusionFactory.create_fuser("none", 8) is None
    assert FusionFactory.create_fuser(None, 8) is None


# -- the modules -----------------------------------------------------------

def _batch(m, seed=0, scale=1.0, relations=R):
    """The same padded batch, features (N, m, D_IN), for both packages."""
    rng = np.random.default_rng(seed)
    num_edges = 200
    ei = rng.integers(0, N_REAL, (2, num_edges))
    et = rng.integers(0, relations, num_edges)
    x = (scale * rng.standard_normal((N_REAL, m, D_IN))).astype(np.float32)
    kw = dict(num_relations=relations, node_budget=NODE_BUDGET,
              edge_budget=256, block_size=32, num_seed=N_REAL, layout="dst")
    return (jax.tree_util.tree_map(jnp.asarray, jax_pad(x, ei, et, **kw)),
            batch_to_device(pad_graph_batch(x, ei, et, **kw), "cpu"))


def _kge_hparams(fuse, init):
    return dict(encoder_name="rgcn", decoder_name="dismult", in_dim=D_IN,
                hidden_dim=D_HID, out_dim=D_HID, num_hidden_layers=1,
                num_relation=R, num_heads=1, scheduler_type="cosine",
                learning_rate=1e-3, warm_up_ratio=0.2, fuse_method=fuse,
                neg_ratio=NEG_RATIO, node_init_method=init)


def _kge(fuse, init):
    jm = jax_kge.KGEModule(**_kge_hparams(fuse, init))
    jm.edge_layout = "dst"
    params = jm.init(jax.random.PRNGKey(0))
    module = kge_module.KGEModule(**_kge_hparams(fuse, init))
    module.edge_layout = "dst"
    load_jax_params(module.model, _np(params), module.fusion)
    return jm, params, module


def _kge_draws(jm, jbatch, rng, m):
    """The draws JAX's ``_forward_loss`` makes from ``rng``: the sorted
    negatives, the encoder's dropout masks and ReDAF's keep mask."""
    r_fuse, r_enc, r_neg, r_perm, _ = jax.random.split(rng, 5)
    r_s, r_d = jax.random.split(r_neg)
    num_edges = jbatch.edge_type.shape[0]
    num_real = jnp.maximum(jnp.sum(jbatch.node_mask.astype(jnp.int32)), 1)
    ns, nd, off = jax_kge.sample_negatives_sorted(
        r_s, r_d, r_perm, jm.neg_ratio, num_edges, num_real)
    masks = []
    for _, dout in jm.model.encoder.dims[:-1]:
        r_enc, sub = jax.random.split(r_enc)
        masks.append(_t(jax.random.bernoulli(sub, 0.8,
                                             (NODE_BUDGET, dout))))
    return dict(negatives=(_t(ns), _t(nd), _t(off).long()),
                dropout_masks=masks,
                fusion_keep=_t(jax.random.bernoulli(
                    r_fuse, 0.9, (NODE_BUDGET, m, D_IN))))


def _compare_step(jm, params, module, jbatch, batch, rng, draws):
    (loss_j, _), grads = jax.value_and_grad(
        lambda p: jm._forward_loss(p, jbatch, rng, training=True),
        has_aux=True)(params)
    want = flatten_tree(_np(grads))
    names = [n for n, _ in module.named_parameters()]
    loss, _ = module._forward_loss(batch, True, **draws)
    got = param_grads(loss, dict(module.named_parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=LOSS_RTOL)
    assert sorted(names) == sorted(want)
    fusion_scale = max([np.abs(want[n]).max() for n in want
                        if n.startswith("fusion.")], default=0.0)
    for n, g in zip(names, got):
        if n == "fusion.k.b":
            # zero in exact arithmetic (a softmax row is invariant to a
            # shift), so both packages hold rounding noise: held to the
            # tolerance of the fuser's largest gradient
            assert np.abs(g.numpy() - want[n]).max() <= \
                GRAD_RTOL * fusion_scale
        else:
            _close(g.numpy(), want[n], GRAD_RTOL)
    return names


@pytest.mark.parametrize("name", ["fusion.sub_type_emb.table",
                                  "fusion.transform.w"])
def test_param_grads_zero_fills_only_ungraded_leaves(name):
    """A leaf the loss does not reach gets zeros only where the reference
    leaves it ungraded (ReDAF's sub-type table); any other raises."""
    used = torch.ones(3, requires_grad=True)
    unused = torch.ones(2, requires_grad=True)
    params = {"used": used, name: unused}
    loss = (2.0 * used).sum()
    if name == "fusion.sub_type_emb.table":
        got = param_grads(loss, params)
        assert torch.equal(got[0], torch.full((3,), 2.0))
        assert torch.equal(got[1], torch.zeros(2))
    else:
        with pytest.raises(RuntimeError, match=name):
            param_grads(loss, params)


@pytest.mark.parametrize("init,m", [("gcl", 1), ("lm", 2)])
def test_kge_modality_mean_without_a_fuser(init, m):
    """The repair: (N, M, d) features with no fuser take the mean over the
    modality axis in the train step and in ``encode``, as JAX's
    ``fusion_fn`` does."""
    jbatch, batch = _batch(m)
    jm, params, module = _kge("none", init)
    assert module.fusion is None
    _close(module.encode(batch).numpy(), jm.encode(params, jbatch), Z_RTOL)
    rng = jax.random.PRNGKey(1)
    draws = _kge_draws(jm, jbatch, rng, m)
    draws.pop("fusion_keep")
    _compare_step(jm, params, module, jbatch, batch, rng, draws)


@pytest.mark.parametrize("m", [1, 2])
def test_gcl_modality_mean_without_a_fuser(m):
    jbatch, batch = _batch(m, scale=GCL_SCALE, relations=1)
    jm, params, module = _gcl("ggd", "none")
    _close(module.encode(batch).numpy(), jm.encode(params, jbatch), Z_RTOL)
    rng = jax.random.PRNGKey(1)
    _compare_step(jm, params, module, jbatch, batch, rng,
                  {"draws": _gcl_draws("ggd", jm, jbatch, rng, m)})


@pytest.mark.parametrize("fuse", ["attention", "redaf", "none"])
def test_kge_lm_step_matches_jax(fuse):
    jbatch, batch = _batch(2, seed=4)
    jm, params, module = _kge(fuse, "lm")
    rng = jax.random.PRNGKey(3)
    draws = _kge_draws(jm, jbatch, rng, 2)
    names = _compare_step(jm, params, module, jbatch, batch, rng, draws)
    assert any(n.startswith("fusion.") for n in names) == (fuse != "none")


@pytest.mark.parametrize("fuse", ["attention", "redaf"])
def test_kge_fused_encode_matches_jax(fuse):
    jbatch, batch = _batch(2, seed=6)
    jm, params, module = _kge(fuse, "lm")
    _close(module.encode(batch).numpy(), jm.encode(params, jbatch), Z_RTOL)
    # the eval step fuses too: no keep mask, no dropout
    gen = torch.Generator().manual_seed(0)
    loss, _ = module._forward_loss(batch, False, gen)
    assert np.isfinite(float(loss))


def test_kge_fuses_lm_features_only():
    """JAX builds the fuser only for LM features: GCL features take the
    mean whatever ``fuse_method`` says."""
    assert kge_module.KGEModule(**_kge_hparams("attention", "gcl")).fusion \
        is None
    assert jax_kge.KGEModule(**_kge_hparams("attention", "gcl")) \
        .modality_transform is None


def _gcl_hparams(fuse):
    return dict(in_dim=D_IN, hidden_dim=D_HID, out_dim=D_HID,
                num_hidden_layers=1, scheduler_type="cosine",
                learning_rate=1e-3, warm_up_ratio=0.2, fuse_method=fuse)


def _gcl(name, fuse):
    jm = jax_gcl._GCL_CLASSES[name](**_gcl_hparams(fuse))
    jm.edge_layout = "dst"
    params = jm.init(jax.random.PRNGKey(0))
    module = gcl_module.GCL_CLASSES[name](**_gcl_hparams(fuse))
    module.edge_layout = "dst"
    load_jax_params(module.model, _np(params), module.fusion)
    return jm, params, module


def _enc_masks(rng, dims):
    masks = []
    for _, dout in dims[:-1]:
        rng, sub = jax.random.split(rng)
        masks.append(_t(jax.random.bernoulli(sub, 0.8, (NODE_BUDGET,
                                                        dout))))
    return masks


def _gcl_draws(name, jm, jbatch, rng, m):
    """The draws JAX's GCL ``_forward_loss`` makes from ``rng``
    (training/gcl_module.py, models/gcl.py), over the fused features."""
    r_fuse, r_model = jax.random.split(rng)
    dims = jm.encoder.dims
    x_shape = (NODE_BUDGET, D_IN)
    e_shape = jbatch.edge_mask.shape
    keep = _t(jax.random.bernoulli(r_fuse, 0.9, (NODE_BUDGET, m, D_IN)))
    if name == "grace":
        rs = jax.random.split(r_model, 7)
        return {"fusion_keep": keep,
                "feat_keep": [_t(jax.random.bernoulli(rs[i], 0.6, x_shape))
                              for i in (0, 1)],
                "edge_keep": [_t(jax.random.bernoulli(rs[i], 0.6, e_shape))
                              for i in (2, 3)],
                "dropout": [_enc_masks(rs[i], dims) for i in (5, 6)]}
    rs = jax.random.split(r_model, 6)
    return {"fusion_keep": keep,
            "do_aug": _t(jax.random.uniform(rs[0]) < 0.5),
            "feat_keep": _t(jax.random.bernoulli(rs[1], 0.6, x_shape)),
            "edge_keep": _t(jax.random.bernoulli(rs[2], 0.6, e_shape)),
            "perm": _t(_masked_permutation(rs[4], jbatch.node_mask)).long(),
            "dropout": [_enc_masks(rs[i], dims) for i in (3, 5)]}


@pytest.mark.parametrize("name,fuse", [("ggd", "attention"),
                                       ("grace", "attention"),
                                       ("ggd", "redaf")])
def test_gcl_fused_step_matches_jax(name, fuse):
    jbatch, batch = _batch(2, seed=5, scale=GCL_SCALE, relations=1)
    jm, params, module = _gcl(name, fuse)
    rng = jax.random.PRNGKey(1)
    names = _compare_step(jm, params, module, jbatch, batch, rng,
                          {"draws": _gcl_draws(name, jm, jbatch, rng, 2)})
    assert sum(n.startswith("fusion.") for n in names) == 6


def test_gcl_fused_encode_and_generator_draws():
    jbatch, batch = _batch(2, seed=8, scale=GCL_SCALE, relations=1)
    jm, params, module = _gcl("ggd", "redaf")
    _close(module.encode(batch).numpy(), jm.encode(params, jbatch), Z_RTOL)
    loss, _ = module._forward_loss(batch, True,
                                   torch.Generator().manual_seed(0))
    assert np.isfinite(float(loss.detach()))
    back = to_jax_params(module.model, module.fusion)
    assert set(back) == {"model", "fusion"}
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           _np(params))
    with pytest.raises(ValueError, match="fusion"):
        load_jax_params(module.model, {"model": _np(params)["model"]},
                        module.fusion)
