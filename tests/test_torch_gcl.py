"""The port's Stage B against the JAX package: the GCN encoder's z, and
one training step's loss and every gradient of GRACE, DGI and GGD, with
the reference's draws replayed from its key splits and injected. float32:
loss 1e-5 relative, gradients 5e-4 of their max. bf16: every gradient
within 3e-2 of its max of JAX's bf16 gradient, and the loss no further from
JAX's float32 loss than JAX's own bf16 loss is, plus 1e-3 of it (DGI's and
GGD's bf16 losses stray 0.5-4 % from float32 in JAX itself, so a direct
1e-3 between the two bf16 runs would measure that noise). The features
are scaled by 30, as tests/test_torch_rgat.py does: at scale 1 the first
convs' gradients cancel to bf16 noise in both packages (JAX's own bf16
gradients stray up to 25 % of their max from float32). One GRACE case has
N >= 2048 node slots, so both packages take their blocked (flash) InfoNCE
route. Also the GCL checkpoints both ways through ``load_gcl_module`` and
``train_gcl`` on the CPU."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.models import encoders as jax_encoders
from biomedkg_tpu.models.gcl import _masked_permutation
from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.training import checkpoint as jax_ckpt
from biomedkg_tpu.training import gcl_module as jax_gcl
from biomedkg_tpu_torch.interop.jax_params import flatten_tree, \
    load_jax_params
from biomedkg_tpu_torch.models.encoders import GCNEncoder
from biomedkg_tpu_torch.sampling.batch import batch_to_device, \
    pad_graph_batch
from biomedkg_tpu_torch.train_gcl import main as train_gcl_main
from biomedkg_tpu_torch.training import gcl_module
from biomedkg_tpu_torch.training.checkpoint import load_train_state, \
    save_train_state

D_IN, D_HID = 24, 16
TOL = {"float32": (1e-5, 5e-4), "bfloat16": (1e-3, 3e-2)}
SCALE = 30.0


def _hparams(dtype="float32"):
    return dict(in_dim=D_IN, hidden_dim=D_HID, out_dim=D_HID,
                num_hidden_layers=1, scheduler_type="cosine",
                learning_rate=1e-3, warm_up_ratio=0.2, fuse_method="none",
                compute_dtype=dtype)


def _raw(seed=0, n_real=40, num_edges=200, node_budget=64, edge_budget=256,
         layout="dst", scale=SCALE):
    """The same padded batch for both packages."""
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n_real, (2, num_edges))
    et = np.zeros(num_edges, np.int32)
    x = (scale * rng.standard_normal((n_real, D_IN))).astype(np.float32)
    kw = dict(num_relations=1, node_budget=node_budget,
              edge_budget=edge_budget, block_size=64, num_seed=n_real,
              layout=layout)
    return (jax.tree_util.tree_map(jnp.asarray, jax_pad(x, ei, et, **kw)),
            batch_to_device(pad_graph_batch(x, ei, et, **kw), "cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _enc_masks(rng, num_nodes, dims):
    """The encoder's dropout masks from its key, as GCNEncoder.apply draws
    them."""
    masks = []
    for _, dout in dims[:-1]:
        rng, sub = jax.random.split(rng)
        masks.append(_t(jax.random.bernoulli(sub, 0.8, (num_nodes, dout))))
    return masks


def _jax_draws(name, jm, jbatch, rng):
    """The draws the JAX module's ``_forward_loss`` makes from ``rng``
    (training/gcl_module.py, models/gcl.py), as the port's draws dict."""
    _, r_model = jax.random.split(rng)
    n, dims = jbatch.node_mask.shape[0], jm.encoder.dims
    x_shape, e_shape = jbatch.x.shape, jbatch.edge_mask.shape
    if name == "grace":
        rs = jax.random.split(r_model, 7)
        return {"feat_keep": [_t(jax.random.bernoulli(rs[i], 0.6, x_shape))
                              for i in (0, 1)],
                "edge_keep": [_t(jax.random.bernoulli(rs[i], 0.6, e_shape))
                              for i in (2, 3)],
                "dropout": [_enc_masks(rs[i], n, dims) for i in (5, 6)]}
    if name == "dgi":
        r_perm, r1, r2 = jax.random.split(r_model, 3)
        return {"perm": _t(_masked_permutation(r_perm, jbatch.node_mask))
                .long(),
                "dropout": [_enc_masks(r, n, dims) for r in (r1, r2)]}
    rs = jax.random.split(r_model, 6)
    return {"do_aug": _t(jax.random.uniform(rs[0]) < 0.5),
            "feat_keep": _t(jax.random.bernoulli(rs[1], 0.6, x_shape)),
            "edge_keep": _t(jax.random.bernoulli(rs[2], 0.6, e_shape)),
            "perm": _t(_masked_permutation(rs[4], jbatch.node_mask)).long(),
            "dropout": [_enc_masks(rs[i], n, dims) for i in (3, 5)]}


def _modules(name, dtype):
    jm = jax_gcl._GCL_CLASSES[name](**_hparams(dtype))
    jm.edge_layout = "dst"
    params = jm.init(jax.random.PRNGKey(0))
    module = gcl_module.GCL_CLASSES[name](**_hparams(dtype))
    module.edge_layout = "dst"
    load_jax_params(module.model, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, module


def _jax_step(name, dtype, jbatch, rng):
    """JAX's (module, loss, {dotted name: gradient}) of one step."""
    jm, params, module = _modules(name, dtype)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jm._forward_loss(p, jbatch, rng, training=True),
        has_aux=True)(params)
    return (jm, module, float(loss),
            flatten_tree(jax.tree_util.tree_map(np.asarray, grads)))


def _check_step(name, dtype, jbatch, batch, seed=1):
    rng = jax.random.PRNGKey(seed)
    jm, module, loss_j, want = _jax_step(name, dtype, jbatch, rng)
    loss, _ = module._forward_loss(batch, True,
                                   draws=_jax_draws(name, jm, jbatch, rng))
    names = [n for n, _ in module.named_parameters()]
    grads = torch.autograd.grad(loss, list(module.parameters()))
    loss = float(loss.detach())
    loss_tol, grad_tol = TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(loss, loss_j, rtol=loss_tol)
        scale = want
    else:
        _, _, loss_32, scale = _jax_step(name, "float32", jbatch, rng)
        assert abs(loss - loss_32) <= abs(loss_j - loss_32) \
            + loss_tol * abs(loss_32), (loss, loss_j, loss_32)
    assert sorted(want) == sorted(names)
    for n, g in zip(names, grads):
        ref = np.asarray(want[n], np.float32)
        err = np.abs(g.float().numpy() - ref).max()
        assert err <= grad_tol * np.abs(scale[n]).max(), (n, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dst", "relation"])
def test_gcn_encoder_matches_jax(layout, dtype):
    """z of a training forward (JAX's dropout masks injected) in both
    layouts; the port's "dst" sums run through ops/segsum.py."""
    jbatch, batch = _raw(seed=2, layout=layout)
    enc = jax_encoders.GCNEncoder(D_IN, D_HID, D_HID, 1)
    enc.edge_layout = layout
    params = enc.init(jax.random.PRNGKey(3))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = jax.random.PRNGKey(4)
    z_j = enc.apply(jax.tree_util.tree_map(lambda a: a.astype(jdt), params),
                    jbatch.x.astype(jdt), jbatch.edge_index,
                    jbatch.edge_mask, rng=rng, training=True)
    port = GCNEncoder(D_IN, D_HID, D_HID, 1)
    port.edge_layout = layout
    with torch.no_grad():
        for layer, src in zip(port.layers, params["layers"]):
            layer.w.copy_(_t(src["w"]))
            layer.b.copy_(_t(src["b"]))
    z = port(batch.x, batch.edge_index, batch.edge_mask, training=True,
             compute_dtype=getattr(torch, dtype),
             dropout_masks=_enc_masks(rng, 64, enc.dims))
    ref = np.asarray(z_j, np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert np.abs(z.float().detach().numpy() - ref).max() \
        <= tol * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["grace", "dgi", "ggd"])
def test_gcl_step_matches_jax(name, dtype):
    jbatch, batch = _raw(seed=5)
    _check_step(name, dtype, jbatch, batch)


@pytest.mark.parametrize("seed", [1, 2])
def test_ggd_both_augmentation_branches(seed):
    """GGD's do_aug draw chooses augmented or clean inputs on the device;
    seeds 1 and 2 give the reference's both branches."""
    jbatch, batch = _raw(seed=6)
    jm, _, _ = _modules("ggd", "float32")
    rs = jax.random.split(jax.random.split(jax.random.PRNGKey(seed))[1], 6)
    assert bool(jax.random.uniform(rs[0]) < 0.5) == (seed == 1)
    _check_step("ggd", "float32", jbatch, batch, seed=seed)


def test_grace_blocked_route_matches_jax():
    """N = 2048 node slots: the reference streams the InfoNCE through its
    flash custom VJP (block 1024) and the port through the plain
    flash_denom Function over 1024-row tiles."""
    assert gcl_module.plain_block(2048) == 1024
    assert gcl_module.plain_block(2040) == 0
    jbatch, batch = _raw(seed=7, n_real=300, num_edges=1500,
                         node_budget=2048, edge_budget=2048)
    _check_step("grace", "float32", jbatch, batch)


def test_infonce_routes_agree():
    """The dense and blocked CPU routes compute the same loss and
    gradients."""
    rng = np.random.default_rng(8)
    h1, h2 = (torch.tensor(rng.standard_normal((2048, 8)),
                           dtype=torch.float32, requires_grad=True)
              for _ in range(2))
    mask = torch.tensor(rng.random(2048) < 0.8)
    blocked = gcl_module.infonce_intraview_loss(h1, h2, mask)
    g_b = torch.autograd.grad(blocked, (h1, h2))
    an, bn = gcl_module.l2_normalize(h1), gcl_module.l2_normalize(h2)
    col = torch.where(mask, 0.0, gcl_module.NEG).float()

    def direction(a, b):
        pos, den = gcl_module._direction_dense(a, b, col, 0.2)
        return gcl_module._masked_mean(-(pos - den), mask)
    dense = 0.5 * (direction(an, bn) + direction(bn, an))
    g_d = torch.autograd.grad(dense, (h1, h2))
    np.testing.assert_allclose(float(blocked), float(dense), rtol=1e-6)
    for a, b in zip(g_b, g_d):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("name", ["grace", "dgi", "ggd"])
def test_gcl_checkpoints_both_ways(name, tmp_path):
    """A JAX-written GCL checkpoint (optax state included) loads in the
    port's load_gcl_module; a port-written one (save_train_state) loads in
    JAX's load_gcl_module and resumes in the port; every encode agrees."""
    jbatch, batch = _raw(seed=9, scale=1.0)
    jm = jax_gcl._GCL_CLASSES[name](**_hparams())
    jm.configure_optimizers(num_training_steps=4)
    params = jm.init(jax.random.PRNGKey(1))
    jax_path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(jax_path, "gcl", jm.hparams, params,
                             opt_state=jm.tx.init(params), step=1,
                             extras={"model_name": name})
    jm.edge_layout = "dst"
    z_j = np.asarray(jm.encode(params, jbatch))
    port = gcl_module.load_gcl_module(jax_path, device="cpu")
    port.edge_layout = "dst"
    assert type(port).__name__ == type(jm).__name__
    np.testing.assert_allclose(port.encode(batch).numpy(), z_j, rtol=1e-5,
                               atol=1e-6)

    port.configure_optimizers(num_training_steps=4)
    state = port.init_state(torch.Generator().manual_seed(0))
    state, _ = port.train_step(state, batch,
                               torch.Generator().manual_seed(1))
    port_path = str(tmp_path / "port.ckpt")
    save_train_state(port_path, port, state, extras={"model_name": name})
    jm2, params2 = jax_gcl.load_gcl_module(port_path)
    jm2.edge_layout = "dst"
    z = port.encode(batch).numpy()
    np.testing.assert_allclose(np.asarray(jm2.encode(params2, jbatch)), z,
                               rtol=1e-5, atol=1e-6)
    resumed = gcl_module.GCL_CLASSES[name](**_hparams())
    resumed.configure_optimizers(num_training_steps=4)
    state2 = load_train_state(port_path, resumed)
    assert state2.step == 1 and state2.opt_state.count == 1
    for a, b in zip(state.opt_state.nu, state2.opt_state.nu):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_train_gcl_cli(tmp_path, monkeypatch):
    """train_gcl trains GRACE on the small default graph's gene/protein
    nodes on the CPU and writes a checkpoint where the reference's GCL
    node encoder looks; the config's three node types are refused."""
    monkeypatch.chdir(tmp_path)
    # 1,024 seeds a batch: the whole val and test epochs are 2 batches each
    path = train_gcl_main(["model.model_name=grace", "data.node_type=gene",
                           "data.batch_size=1024",
                           "steps=2", "epochs=1", "val_every_epoch=1",
                           "device=cpu", f"ckpt_dir={tmp_path}/ckpt",
                           f"log_dir={tmp_path}/log"])
    assert glob.glob(f"{tmp_path}/ckpt/gcl/gene/grace*none*/*.ckpt") \
        == [path]
    module = gcl_module.load_gcl_module(path, device="cpu")
    assert isinstance(module, gcl_module.GRACEModule)
    jm, params = jax_gcl.load_gcl_module(path)
    assert jm.hparams == module.hparams
    with pytest.raises(ValueError, match="only one node type"):
        train_gcl_main(["steps=1", "epochs=1", "device=cpu"])
