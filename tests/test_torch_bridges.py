"""The port's stage bridges against the JAX package, on the small synthetic
graph in a temporary working directory: checkpoints with a ``fusion``
subtree written by each package and loaded by the other (params,
hparams, Adam moments); the LM cache reader (hits, misses,
``random_init_ratio``, and the refusal to build it: Stage A is not
ported); ``GCLEncode`` over JAX-written GGD + attention checkpoints
against the JAX package's own ``GCLEncode``; the port's ``train_kge`` on
those GCL features (``data.node_init_method=gcl``, scripts/kge.sh's keys);
and ``KGEEncode`` of its checkpoint against one JAX encode of it.

The LM cache is seeded with deterministic vectors made from a seed, as
tests/test_bridges.py seeds it. Rows: 1e-4 of max|z| (tests/test_parity.py).
"""

import contextlib
import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.data import node_encoders as jax_nodes
from biomedkg_tpu.data import primekg as jax_primekg
from biomedkg_tpu.data.modules import PrimeKGModule as JaxPrimeKGModule
from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.sampling.loaders import FullGraphLoader as JaxFullLoader
from biomedkg_tpu.training import checkpoint as jax_ckpt
from biomedkg_tpu.training import gcl_module as jax_gcl
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu_torch.data import node_encoders
from biomedkg_tpu_torch.data.primekg import PrimeKG
from biomedkg_tpu_torch.interop.jax_params import flatten_tree
from biomedkg_tpu_torch.sampling.batch import batch_to_device, \
    pad_graph_batch
from biomedkg_tpu_torch.train_kge import main as train_kge_main
from biomedkg_tpu_torch.training import gcl_module, kge_module
from biomedkg_tpu_torch.training.checkpoint import load_train_state, \
    save_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, OUT = 16, 8
Z_RTOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=Z_RTOL):
    want = np.asarray(want, np.float32)
    assert np.abs(np.asarray(got) - want).max() <= \
        rtol * np.abs(want).max()


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A working directory with configs/ linked and an LM cache of (2, DIM)
    rows, L2-normalised over the modality axis, for every node."""
    tmp = tmp_path_factory.mktemp("bridges")
    os.symlink(os.path.join(ROOT, "configs"), tmp / "configs")
    names = PrimeKG(str(tmp / "data" / "primekg")).node_list
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((len(names), 2, DIM)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    os.makedirs(tmp / "data" / "embed")
    with open(tmp / "data" / "embed" / "primekg_modality_lm.pickle",
              "wb") as f:
        pickle.dump(dict(zip(names, rows)), f)
    return tmp, names


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


# -- checkpoints with a fusion subtree --------------------------------------

def _batch(m=2, seed=0, relations=4):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, 40, (2, 200))
    et = rng.integers(0, relations, 200)
    x = rng.standard_normal((40, m, DIM)).astype(np.float32)
    kw = dict(num_relations=relations, node_budget=64, edge_budget=256,
              block_size=32, num_seed=40, layout="dst")
    return (jax.tree_util.tree_map(jnp.asarray, jax_pad(x, ei, et, **kw)),
            batch_to_device(pad_graph_batch(x, ei, et, **kw), "cpu"))


KGE_HP = dict(encoder_name="rgcn", decoder_name="dismult", in_dim=DIM,
              hidden_dim=OUT, out_dim=OUT, num_hidden_layers=1,
              num_relation=4, num_heads=1, scheduler_type="cosine",
              learning_rate=1e-3, warm_up_ratio=0.2, neg_ratio=2,
              node_init_method="lm")
GCL_HP = dict(in_dim=DIM, hidden_dim=OUT, out_dim=OUT, num_hidden_layers=1,
              scheduler_type="cosine", learning_rate=1e-3,
              warm_up_ratio=0.2, fuse_method="attention")


def _jax_written(tmp_path, kind, fuse):
    """A JAX checkpoint after one Adam update with made-up gradients."""
    if kind == "kge":
        jm = jax_kge.KGEModule(**KGE_HP, fuse_method=fuse)
        extras = {}
    else:
        jm = jax_gcl.GGDModule(**dict(GCL_HP, fuse_method=fuse))
        extras = {"model_name": "ggd"}
    params = jm.init(jax.random.PRNGKey(1))
    jm.configure_optimizers(num_training_steps=4)
    grads = jax.tree_util.tree_map(lambda p: 0.1 * jnp.sin(p + 1.0), params)
    _, opt_state = jm.tx.update(grads, jm.tx.init(params), params)
    path = str(tmp_path / f"jax_{kind}.ckpt")
    jax_ckpt.save_checkpoint(path, kind, jm.hparams, params,
                             opt_state=opt_state, step=1, extras=extras)
    return jm, params, opt_state, path


@pytest.mark.parametrize("kind,fuse", [("kge", "attention"),
                                       ("kge", "redaf"), ("gcl", "attention")])
def test_jax_checkpoint_with_fusion_loads_in_the_port(kind, fuse, tmp_path):
    jm, params, opt_state, path = _jax_written(tmp_path, kind, fuse)
    if kind == "kge":
        module = kge_module.load_kge_module(path, "cpu")
    else:
        module = gcl_module.load_gcl_module(path, "cpu")
    assert module.hparams == jm.hparams
    assert module.hparams["fuse_method"] == fuse
    want = flatten_tree(_np(params))
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(want)
    assert any(n.startswith("fusion.") for n in named)
    for n, p in named.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[n])
    module.configure_optimizers(num_training_steps=4)
    state = load_train_state(path, module)
    adam = opt_state[1]
    for tree, got in ((adam.mu, state.opt_state.mu),
                      (adam.nu, state.opt_state.nu)):
        flat = flatten_tree(_np(tree))
        for n, t in zip(named, got):
            np.testing.assert_array_equal(t.numpy(), flat[n])
    assert state.opt_state.count == 1 and state.step == 1


@pytest.mark.parametrize("kind,fuse", [("kge", "redaf"),
                                       ("gcl", "attention")])
def test_port_checkpoint_with_fusion_loads_in_jax(kind, fuse, tmp_path):
    if kind == "kge":
        module = kge_module.KGEModule(**KGE_HP, fuse_method=fuse)
        jbatch, batch = _batch()
        extras = None
    else:
        module = gcl_module.GGDModule(**dict(GCL_HP, fuse_method=fuse))
        jbatch, batch = _batch(relations=1)
        extras = {"model_name": "ggd"}
    module.edge_layout = "dst"
    module.configure_optimizers(num_training_steps=4)
    state = module.init_state(torch.Generator().manual_seed(0))
    state, _ = module.train_step(state, batch,
                                 torch.Generator().manual_seed(1))
    path = str(tmp_path / "port.ckpt")
    save_train_state(path, module, state, extras=extras)
    if kind == "kge":
        jm, params = jax_kge.load_kge_module(path)
    else:
        jm, params = jax_gcl.load_gcl_module(path)
    jm.edge_layout = "dst"
    assert jm.hparams == module.hparams and "fusion" in params
    _close(module.encode(batch).numpy(), jm.encode(params, jbatch))
    raw = jax_ckpt.load_checkpoint(path)
    mu = flatten_tree(raw["opt_state"]["mu"])
    assert any(n.startswith("fusion.") for n in mu)
    for n, t in zip(state.params, state.opt_state.mu):
        np.testing.assert_array_equal(t.numpy(), mu[n])


# -- the node-feature caches ------------------------------------------------

def test_lm_cache_hit_and_miss(workspace):
    tmp, names = workspace
    with _cwd(tmp):
        enc = node_encoders.LMMultiModalsEncode(
            "configs/lm_modality/primekg_modality.yaml", embed_dim=DIM)
        want_enc = jax_nodes.LMMultiModalsEncode(
            "configs/lm_modality/primekg_modality.yaml", embed_dim=DIM)
    assert enc.conf == want_enc.conf
    query = names[:10] + ["__missing__"]
    got = enc(query)
    assert got.shape == (11, 2, DIM) and enc.random_init_ratio == 1 / 11
    np.testing.assert_array_equal(got, want_enc(query))
    assert want_enc.random_init_ratio == enc.random_init_ratio
    np.testing.assert_allclose(np.linalg.norm(got[:10], axis=1), 1.0,
                               rtol=1e-6)


def test_lm_cache_build_raises(tmp_path, monkeypatch):
    """Stage A (the LMs over the modality csvs) is not ported: a missing
    cache raises naming ROADMAP.md, read through the repository's modality
    yaml from any directory."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md.*item 8"):
        node_encoders.LMMultiModalsEncode(
            "configs/lm_modality/primekg_modality.yaml", embed_dim=DIM)


def _write_jax_gcl_checkpoints(root):
    """JAX GGD + attention checkpoints over LM features, one per node type,
    in the reference's layout."""
    for i, node_type in enumerate(["gene", "drug", "disease"]):
        jm = jax_gcl.GGDModule(**dict(GCL_HP, hidden_dim=OUT, out_dim=OUT))
        params = jm.init(jax.random.PRNGKey(10 + i))
        d = os.path.join(root, "ckpt", "gcl", node_type,
                         "ggd_attention_lm_0")
        os.makedirs(d)
        jax_ckpt.save_checkpoint(os.path.join(d, "best.ckpt"), "gcl",
                                 jm.hparams, params,
                                 extras={"model_name": "ggd"})


@pytest.fixture(scope="module")
def gcl_cache(workspace, tmp_path_factory):
    """The port's GCL cache, built by ``GCLEncode`` from JAX-written
    checkpoints, and the JAX package's built from the same files in a
    second directory."""
    tmp, names = workspace
    _write_jax_gcl_checkpoints(tmp)
    with _cwd(tmp):
        enc = node_encoders.GCLEncode("ggd", "attention", embed_dim=OUT,
                                      device="cpu")
    jax_dir = tmp_path_factory.mktemp("bridges_jax")
    os.symlink(os.path.join(ROOT, "configs"), jax_dir / "configs")
    os.symlink(tmp / "ckpt", jax_dir / "ckpt")
    os.makedirs(jax_dir / "data")
    os.symlink(tmp / "data" / "embed", jax_dir / "data" / "embed")
    with _cwd(jax_dir), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_primekg, "_download_csv", lambda path: False)
        want = jax_nodes.GCLEncode("ggd", "attention", embed_dim=OUT)
    return enc, want


def test_gcl_encode_matches_jax(gcl_cache, workspace):
    enc, want = gcl_cache
    assert os.path.exists(workspace[0] / "data" / "gcl_embed" /
                          "ggd_attention.pickle")
    assert sorted(enc.node_mapping) == sorted(want.node_mapping)
    names = sorted(want.node_mapping)
    got = np.concatenate([enc.node_mapping[n] for n in names])
    ref = np.concatenate([want.node_mapping[n] for n in names])
    assert got.shape == (len(names), OUT)
    _close(got, ref)
    out = enc(names[:5] + ["__missing__"])
    assert out.shape == (6, 1, OUT) and enc.random_init_ratio == 1 / 6
    ref = want(names[:5] + ["__missing__"])
    _close(out[:5], ref[:5])
    np.testing.assert_array_equal(out[5], ref[5])      # the miss's row


def test_train_kge_on_gcl_features_and_kge_encode(gcl_cache, workspace):
    """scripts/kge.sh with NODE_INIT_METHOD=gcl, cut to a few CPU steps:
    the model reads (N, 1, d) GCL rows, takes their modality mean, trains,
    validates and tests; ``KGEEncode`` of the checkpoint (the JAX
    package's stem rule) equals one JAX encode of it."""
    tmp, _ = workspace
    with _cwd(tmp), contextlib.redirect_stdout(io.StringIO()) as out:
        path = train_kge_main([
            "devices=[0]", "epochs=1", "neg_ratio=1", "gcl_model=ggd",
            "gcl_fuse_method=attention", "data.batch_size=64",
            f"data.embed_dim={OUT}", "data.node_init_method=gcl",
            f"model.in_dim={OUT}", "model.learning_rate=0.001",
            "model.fuse_method=none", "model.encoder_name=rgcn",
            "model.decoder_name=dismult", "model.hidden_dim=8",
            "model.out_dim=8", "steps=2", "val_every_epoch=1",
            "device=cpu", f"ckpt_dir={tmp}/ck", f"log_dir={tmp}/log"])
    assert "_gcl_ggd_attention" in path
    assert f"features (1, {OUT}) (gcl)" in out.getvalue()
    module = kge_module.load_kge_module(path, "cpu")
    assert module.hparams["node_init_method"] == "gcl"
    assert module.fusion is None

    with _cwd(tmp):
        enc = node_encoders.KGEEncode(path, "gcl", "ggd", "attention",
                                      out_dim=8, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_primekg, "_download_csv", lambda p: False)
            want_path = jax_nodes.KGEEncode(path, "gcl", "ggd", "attention",
                                            out_dim=8).artifact_path
            jdm = JaxPrimeKGModule(
                data_dir="./data/primekg", embed_dim=OUT,
                node_type=["gene/protein", "drug", "disease"],
                batch_size=64, val_ratio=0.2, test_ratio=0.2,
                node_init_method="gcl", gcl_model="ggd",
                gcl_fuse_method="attention")
            jdm.setup()
    assert enc.artifact_path == want_path
    jm, params = jax_kge.load_kge_module(path)
    z = np.asarray(jm.encode(params, JaxFullLoader(jdm.primekg.graph)
                             .batch()))[:jdm.graph.num_nodes]
    got = np.concatenate([enc.node_mapping[n]
                          for n in jdm.primekg.node_list])
    _close(got, z)
