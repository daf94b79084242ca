"""DPI fine-tuning in the port against the JAX package: ``DPIModule``
(ToUndirected and its dedup, the splits, the first SAINT batch, the
unseen-drug split; byte-identical arrays), the ``fix_edge_id`` training
step (loss and every gradient with JAX's negatives and dropout masks
injected; RGCN in the "dst" layout and RGAT in the "relation" layout; a
from-scratch R = 1 model and a warm-started R = 4 one pinned to relation
1; float32 and bf16), the eval step, its per-relation metrics and
``encode`` with ``fix_edge_id``, and the ``train_dpi`` / ``test_dpi``
entry points on the CPU.

Tolerances are tests/test_torch_train_step.py's: float32 loss 1e-5
relative and each gradient 5e-4 of its max; in bf16 the loss within 2e-2
and each gradient no further from JAX's float32 gradient than JAX's own
bf16 gradient is, plus 2e-2 of its max (3e-2 for RGAT, as
tests/test_torch_rgat.py); z from ``encode`` 1e-4 of its max.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.data import primekg as jax_primekg
from biomedkg_tpu.data.modules import DPIModule as JaxDPIModule
from biomedkg_tpu.models import encoders as jax_encoders
from biomedkg_tpu.ops import segment as jax_segment
from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu_torch import test_dpi, train_dpi
from biomedkg_tpu_torch.data.modules import DPIModule
from biomedkg_tpu_torch.interop.jax_params import flatten_tree, \
    load_jax_params, to_jax_params
from biomedkg_tpu_torch.sampling.batch import batch_to_device, \
    pad_graph_batch
from biomedkg_tpu_torch.training import kge_module
from biomedkg_tpu_torch.training.checkpoint import load_checkpoint, \
    save_checkpoint
from test_torch_lightning_ckpt import write_kge
from test_torch_train_step import _jax_draws

N_REAL, D_IN, D_HID, PINNED = 40, 16, 8, 1
DPI_NAME = "drug_protein_interaction"


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setattr(jax_primekg, "_download_csv", lambda path: False)
    for key in ("BIOMEDKG_DPI_CSV", "BIOMEDKG_KG_CSV",
                "BIOMEDKG_SYNTHETIC_SCALE"):
        monkeypatch.delenv(key, raising=False)


def _modules_kw(tmp_path, **over):
    return dict(dict(data_dir=str(tmp_path / "absent.csv"), embed_dim=8,
                     batch_size=16, val_ratio=0.2, test_ratio=0.2, seed=5),
                **over)


def _assert_arrays_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, what
    assert a.tobytes() == b.tobytes(), what


def _assert_graph_equal(a, b):
    assert a.num_nodes == b.num_nodes and a.num_relations == b.num_relations
    _assert_arrays_equal(a.edge_index, b.edge_index, "edge_index")
    _assert_arrays_equal(a.edge_type, b.edge_type, "edge_type")
    if a.x is not None:
        _assert_arrays_equal(a.x, b.x, "x")


def test_dpi_module_matches_jax(tmp_path):
    """The undirected, deduplicated DPI graph (byte for byte), its edge
    map, the splits (the reverse of a test edge may sit in train, as in
    the reference), and the first SAINT batch of each split in the "dst"
    layout."""
    jdm, dm = JaxDPIModule(**_modules_kw(tmp_path)), \
        DPIModule(**_modules_kw(tmp_path))
    jdm.setup("split")
    dm.setup("split")
    _assert_graph_equal(jdm.graph, dm.graph)
    assert dm.edge_map_index == jdm.edge_map_index == {0: DPI_NAME}
    assert dm.data.node_list == jdm.data.node_list
    assert dm.data.num_edge_types == 1
    # undirected: every edge's reverse is there, no (src, dst, type) twice
    ei = dm.graph.edge_index
    fwd = set(zip(ei[0].tolist(), ei[1].tolist()))
    assert fwd == set(zip(ei[1].tolist(), ei[0].tolist()))
    assert len(fwd) == ei.shape[1]
    for split in ("train_data", "val_data", "test_data"):
        _assert_graph_equal(getattr(jdm, split).graph,
                            getattr(dm, split).graph)
    for m in (jdm, dm):
        m.edge_layout = "dst"
        m.device_features = True
    for which in ("train", "val", "test"):
        jb = getattr(jdm, f"{which}_dataloader")("saint").sample()[0]
        b = getattr(dm, f"{which}_dataloader")("saint").sample()[0]
        for field in b._fields:
            _assert_arrays_equal(getattr(jb, field), getattr(b, field),
                                 f"{which} {field}")


def test_dpi_module_unseen_drug_split_matches_jax(tmp_path):
    kw = _modules_kw(tmp_path, unseen_node_ratio=0.1,
                     unseen_node_types=["drug"])
    jdm, dm = JaxDPIModule(**kw), DPIModule(**kw)
    jdm.setup("split")
    dm.setup("split")
    want, got = jdm.inductive, dm.inductive
    for field in ("unseen_nodes", "unseen_mask", "val_edge_index",
                  "val_edge_type", "test_edge_index", "test_edge_type"):
        _assert_arrays_equal(getattr(want, field), getattr(got, field),
                             field)
    _assert_graph_equal(want.eval_graph, got.eval_graph)
    for split in ("train", "val", "test"):
        _assert_graph_equal(getattr(want, split).graph,
                            getattr(got, split).graph)
    drugs = dm.data.type_offset["drug"]
    assert all(dm.data.node_list[i] .startswith("drug_")
               for i in got.unseen_nodes) and drugs >= 0


def _hparams(encoder, num_relation, dtype):
    return dict(encoder_name=encoder, decoder_name="dismult", in_dim=D_IN,
                hidden_dim=D_HID, out_dim=D_HID, num_hidden_layers=1,
                num_relation=num_relation, num_heads=2,
                scheduler_type="cosine", learning_rate=1e-3,
                warm_up_ratio=0.2, fuse_method="none", neg_ratio=2,
                node_init_method="random", compute_dtype=dtype)


def _dpi_batch(layout, seed=0, scale=1.0, num_edges=200):
    """A padded batch of a one-relation (DPI) graph, both packages, with
    N(0, scale²) features."""
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N_REAL, num_edges),
                   rng.integers(0, N_REAL, num_edges)])
    et = np.zeros(num_edges, np.int64)
    x = (scale * rng.standard_normal((N_REAL, D_IN))).astype(np.float32)
    kw = dict(num_relations=1, node_budget=64, edge_budget=256,
              block_size=32, num_seed=N_REAL, layout=layout)
    return (jax.tree_util.tree_map(jnp.asarray, jax_pad(x, ei, et, **kw)),
            batch_to_device(pad_graph_batch(x, ei, et, **kw), "cpu"))


def _pair(encoder, num_relation, dtype, fix):
    jm = jax_kge.KGEModule(**_hparams(encoder, num_relation, dtype))
    module = kge_module.KGEModule(**_hparams(encoder, num_relation, dtype))
    layout = "dst" if encoder == "rgcn" else "relation"
    jm.edge_layout = module.edge_layout = layout
    params = jm.init(jax.random.PRNGKey(0))
    load_jax_params(module.model, jax.tree_util.tree_map(np.asarray, params))
    jm.fix_edge_id = module.fix_edge_id = fix
    return jm, params, module, layout


def _step(encoder, num_relation, dtype, fix, monkeypatch):
    """(JAX loss, JAX grads, port loss, port grads) of one training step
    with JAX's draws injected."""
    if dtype == "bfloat16" and encoder == "rgat":
        # XLA's CPU runtime refuses the bf16 one-hot product of
        # take_rows_matbwd's backward; take_rows sums the same exactly
        monkeypatch.setattr(jax_encoders, "take_rows_matbwd",
                            jax_segment.take_rows)
    jm, params, module, layout = _pair(encoder, num_relation, dtype, fix)
    jbatch, batch = _dpi_batch(layout)
    rng = jax.random.PRNGKey(7)
    grad_fn = jax.value_and_grad(
        lambda p: jm._forward_loss(p, jbatch, rng, training=True),
        has_aux=True)
    if dtype == "float32":
        # compiled: the same float32 sums; bf16 runs op by op, each op
        # rounding where the JAX code says (as tests/test_torch_train_step)
        grad_fn = jax.jit(grad_fn)
    (loss_jax, _), grads_jax = grad_fn(params)
    negatives, masks = _jax_draws(jm, jbatch, rng)
    named = dict(module.named_parameters())
    loss, _ = module._forward_loss(batch, training=True, negatives=negatives,
                                   dropout_masks=masks)
    grads = torch.autograd.grad(loss, list(named.values()))
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, grads_jax))
    assert set(want) == set(named)
    got = {n: g.float().numpy() for n, g in zip(named, grads)}
    if fix is not None:
        # only the L2 term reaches the rows the batch no longer uses
        rel = named["model.decoder.rel_emb"].detach().numpy()
        others = np.arange(num_relation) != fix
        np.testing.assert_allclose(got["model.decoder.rel_emb"][others],
                                   2e-2 * rel[others] / rel.size, rtol=1e-5)
        data = got["model.decoder.rel_emb"][fix] - 2e-2 * rel[fix] / rel.size
        assert np.abs(data).max() > 1e-3 * np.abs(
            got["model.decoder.rel_emb"][fix]).max()
    return float(loss_jax), want, float(loss.detach()), got


def _rel_to_max(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


CASES = [("rgcn", 1, None), ("rgcn", 4, PINNED), ("rgat", 1, None),
         ("rgat", 4, PINNED)]


_FLOAT32 = {}


def _float32_step(encoder, num_relation, fix, monkeypatch):
    """_step in float32, once per case (the bf16 test reads its JAX
    gradients too)."""
    key = (encoder, num_relation, fix)
    if key not in _FLOAT32:
        _FLOAT32[key] = _step(encoder, num_relation, "float32", fix,
                              monkeypatch)
    return _FLOAT32[key]


@pytest.mark.parametrize("encoder, num_relation, fix", CASES)
def test_fix_edge_id_step_matches_jax(encoder, num_relation, fix,
                                      monkeypatch):
    loss_jax, want, loss, grads = _float32_step(encoder, num_relation, fix,
                                                monkeypatch)
    assert abs(loss - loss_jax) <= 1e-5 * abs(loss_jax)
    for name, g in grads.items():
        assert _rel_to_max(g, want[name]) <= 5e-4, name


@pytest.mark.parametrize("encoder, num_relation, fix", CASES)
def test_fix_edge_id_step_bf16_matches_jax(encoder, num_relation, fix,
                                           monkeypatch):
    _, f32, _, _ = _float32_step(encoder, num_relation, fix, monkeypatch)
    loss_jax, want, loss, grads = _step(encoder, num_relation, "bfloat16",
                                        fix, monkeypatch)
    tol = 2e-2 if encoder == "rgcn" else 3e-2
    assert abs(loss - loss_jax) <= 2e-2 * abs(loss_jax)
    for name, g in grads.items():
        err = _rel_to_max(g, f32[name])
        err_jax = _rel_to_max(want[name], f32[name])
        assert err <= err_jax + tol, (name, err, err_jax)


def test_fix_edge_id_eval_and_encode_match_jax():
    """The eval step with fix_edge_id: loss as JAX's, every real edge
    counted under the pinned relation, so the DPI map's own relation (id
    0) has no edge and its precision is 0.0 in both packages; encode
    reads the pinned relation as JAX's does (and differs from an unpinned
    encode)."""
    jm, params, module, _ = _pair("rgcn", 4, "float32", PINNED)
    jbatch, batch = _dpi_batch("dst")
    rng = jax.random.PRNGKey(3)
    loss_jax, aux_jax = jm._forward_loss(params, jbatch, rng, training=False)
    _, _, r_neg, _, _ = jax.random.split(rng, 5)
    r_s, r_d = jax.random.split(r_neg)
    num_real = int(np.sum(np.asarray(jbatch.node_mask)))
    shape = (jm.neg_ratio, jbatch.edge_type.shape[0])
    negatives = tuple(torch.from_numpy(np.asarray(
        (jax.random.uniform(r, shape) * num_real).astype(jnp.int32))).long()
        for r in (r_s, r_d))
    state = module.eval_step(batch, negatives=negatives)
    state_jax = jm._reduce_eval_aux(aux_jax)
    np.testing.assert_allclose(float(state["loss"]), float(loss_jax),
                               rtol=1e-5)
    real = float(np.asarray(jbatch.edge_mask).sum())
    for key in ("edge_counts", "edge_above"):
        np.testing.assert_array_equal(state[key].numpy(),
                                      np.asarray(state_jax[key]))
    assert state["edge_counts"].tolist() == [0.0, real, 0.0, 0.0]
    mapping = {0: DPI_NAME}
    jm.edge_mapping = module.edge_mapping = mapping
    got = module.eval_epoch([state], "test")
    want = jm.eval_epoch([state_jax], "test")
    assert set(got) == set(want)
    assert got[f"{DPI_NAME}_pre"] == want[f"{DPI_NAME}_pre"] == 0.0
    # the exact path (raw aux dicts) reads the pinned types the same way
    module.eval_impl = "exact"
    exact = module.eval_epoch([module.eval_step(batch, negatives=negatives)],
                              "test")
    assert exact[f"{DPI_NAME}_pre"] == 0.0

    z_jax = np.asarray(jm.encode(params, jbatch))
    z = module.encode(batch).numpy()
    assert _rel_to_max(z, z_jax) <= 1e-4
    module.fix_edge_id = None
    assert _rel_to_max(module.encode(batch).numpy(), z_jax) > 1e-3


def test_fix_edge_id_outside_the_table_raises():
    module = kge_module.KGEModule(**_hparams("rgcn", 1, "float32"))
    with pytest.raises(ValueError, match="outside the model's 1 relations"):
        module.fix_edge_id = 1
    module.fix_edge_id = 0
    assert module.fix_edge_id == 0


def _dpi_args(tmp_path, *extra):
    return ["device=cpu", "steps=2", "epochs=2", "val_every_epoch=1",
            "data.batch_size=16", f"ckpt_dir={tmp_path / 'ck'}",
            f"log_dir={tmp_path / 'log'}", *extra]


def _warm_native(tmp_path, d):
    """A port checkpoint of an R = 8 model (PrimeKG's relations)."""
    hp = _hparams("rgcn", 8, "float32")
    hp.update(in_dim=d, hidden_dim=d, out_dim=d)
    module = kge_module.KGEModule(**hp)
    module.init(torch.Generator().manual_seed(4))
    path = str(tmp_path / "native.ckpt")
    save_checkpoint(path, "kge", module.hparams, to_jax_params(module.model))
    return path


@pytest.mark.parametrize("start", ["scratch", "lightning", "native"])
def test_train_dpi_then_test_dpi(tmp_path, monkeypatch, capsys, start):
    """train_dpi from scratch and warm-started (a reference Lightning file
    and a port checkpoint: fix_edge_id 1, neg_ratio from the config), with
    the unseen-drug protocol; the top-3 + last checkpoints; the relation
    rows other than 1 moved only by the L2 term (towards 0); then test_dpi
    on the tested checkpoint."""
    monkeypatch.chdir(tmp_path)
    d = 8
    extra = [f"data.embed_dim={d}", f"model.in_dim={d}",
             f"model.hidden_dim={d}", f"model.out_dim={d}",
             "model.num_hidden_layers=1", "data.unseen_node_ratio=0.1",
             "data.unseen_node_types=[drug]"]
    init = None
    if start == "lightning":
        init = write_kge(tmp_path / "ref.ckpt", r=8, d=d, hidden_layers=0)
    elif start == "native":
        init = _warm_native(tmp_path, d)
    if init:
        extra.append(f"pretrained_path={init}")
    path = train_dpi.main(_dpi_args(tmp_path, *extra))
    out = capsys.readouterr().out
    assert out.startswith("train_dpi: ") and "unseen-node (inductive)" in out
    assert ("(fix_edge_id 1)" in out) == (start != "scratch")
    run = os.path.dirname(path)
    assert "/ck/dpi/rgcn_dismult_random" in run
    assert "last.ckpt" in os.listdir(run)
    assert f"  {DPI_NAME}_pre: " in out
    ckpt = load_checkpoint(path)
    rel = ckpt["params"]["model"]["decoder"]["rel_emb"]
    if init:
        before = load_checkpoint(init)["params"]["model"]["decoder"][
            "rel_emb"]
        assert ckpt["hparams"]["num_relation"] == 8
        delta = (rel - before)[np.arange(8) != PINNED]
        prev = before[np.arange(8) != PINNED]
        big = np.abs(prev) > 10 * 1e-3 * 4
        assert big.any() and np.all(delta[big] * prev[big] <= 0)
    else:
        assert rel.shape[0] == 1
    metrics = test_dpi.main(["device=cpu", "steps=10", "neg_ratio=3",
                             "filter_neg=true", f"data.embed_dim={d}",
                             "data.batch_size=16", f"pretrained_path={path}",
                             "data.unseen_node_ratio=0.1"])
    assert np.isfinite(metrics["test_loss"]) and "unseen_mrr" in metrics
    assert "Neg Ratio: 3" in capsys.readouterr().out


def test_train_dpi_pretrained_path_rules(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="neither a .ckpt file"):
        train_dpi.main(_dpi_args(tmp_path, "pretrained_path=weights.pt"))
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        train_dpi.main(_dpi_args(tmp_path, f"pretrained_path="
                                           f"{tmp_path / 'orbax'}"))
    for none in ("none", "null"):
        cfg = train_dpi.load_config(train_dpi.CONFIG_DIR, "dpi",
                                    [f"pretrained_path={none}"])
        assert train_dpi.warm_start_path(cfg) is None
