"""The port's KGE training step against the JAX package: the negative
samplers' helpers and distributions, ``_forward_loss`` with the
reference's negatives and dropout masks injected, the schedule, three
optimizer steps, checkpoints both ways (DistMult, RotatE and ComplEx),
and the ``train_kge`` entry point (RGCN). tests/test_torch_train_decoders.py
holds the step of every decoder and sorted sampler against JAX's,
tests/test_torch_train_rgat.py RGAT's checkpoints and ``train_kge`` run.

Tolerances: float32 loss 1e-5 and gradients 5e-4 relative (as
tests/test_parity.py; only summation orders differ); bfloat16 2e-2
(the two frameworks round bf16 intermediates at different places);
parameters after Adam steps 1e-5. The port's own sampler gets
distribution tests: JAX's random streams cannot be reproduced in torch.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.sampling.batch import pad_graph_batch as jax_pad
from biomedkg_tpu.training import checkpoint as jax_ckpt
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu.training.optim import warmup_schedule as jax_schedule
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.interop.jax_params import flatten_tree, \
    load_jax_params
from biomedkg_tpu_torch.models import decoders, encoders
from biomedkg_tpu_torch.sampling.batch import batch_to_device, \
    pad_graph_batch
from biomedkg_tpu_torch.serve import PRIMEKG_DATA
from biomedkg_tpu_torch.serving import KGEScorer
from biomedkg_tpu_torch.train_kge import main as train_kge_main
from biomedkg_tpu_torch.training import kge_module
from biomedkg_tpu_torch.training.checkpoint import load_train_state, \
    save_train_state
from biomedkg_tpu_torch.training.optim import warmup_schedule

N_REAL, R, D_IN, D_HID = 40, 4, 24, 16
NEG_RATIO = 3
STEPS = 10


def _hparams(dtype="float32"):
    return dict(encoder_name="rgcn", decoder_name="dismult", in_dim=D_IN,
                hidden_dim=D_HID, out_dim=D_HID, num_hidden_layers=1,
                num_relation=R, num_heads=2, scheduler_type="cosine",
                learning_rate=1e-3, warm_up_ratio=0.2, fuse_method="none",
                neg_ratio=NEG_RATIO, node_init_method="random",
                compute_dtype=dtype)


def _raw(seed=0, scale=1.0, num_edges=200, edge_budget=256, layout="dst"):
    rng = np.random.default_rng(seed)
    ei = np.stack([rng.integers(0, N_REAL, num_edges),
                   rng.integers(0, N_REAL, num_edges)])
    et = rng.integers(0, R, num_edges)
    x = (scale * rng.standard_normal((N_REAL, D_IN))).astype(np.float32)
    kw = dict(num_relations=R, node_budget=64, edge_budget=edge_budget,
              block_size=32, num_seed=N_REAL, layout=layout)
    return (jax.tree_util.tree_map(jnp.asarray, jax_pad(x, ei, et, **kw)),
            batch_to_device(pad_graph_batch(x, ei, et, **kw), "cpu"))


def _modules(dtype="float32"):
    jm = jax_kge.KGEModule(**_hparams(dtype))
    jm.edge_layout = "dst"
    params = jm.init(jax.random.PRNGKey(0))
    module = kge_module.KGEModule(**_hparams(dtype))
    module.edge_layout = "dst"
    load_jax_params(module.model, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, module


def _jax_draws(jm, jbatch, rng, dual=False):
    """The negatives and dropout masks ``_forward_loss`` draws from
    ``rng`` (its key splits, training/kge_module.py); ``dual`` for the
    "sorted2" sampler."""
    _, r_enc, r_neg, r_perm, _ = jax.random.split(rng, 5)
    r_s, r_d = jax.random.split(r_neg)
    num_edges = jbatch.edge_type.shape[0]
    num_real = jnp.maximum(jnp.sum(jbatch.node_mask.astype(jnp.int32)), 1)
    ns, nd, off = jax_kge.sample_negatives_sorted(
        r_s, r_d, r_perm, jm.neg_ratio, num_edges, num_real, dual=dual)
    masks = []
    for din, dout in jm.model.encoder.dims[:-1]:
        r_enc, sub = jax.random.split(r_enc)
        masks.append(torch.from_numpy(np.asarray(jax.random.bernoulli(
            sub, 0.8, (jbatch.node_mask.shape[0], dout)))))
    negatives = (torch.from_numpy(np.asarray(ns)),
                 torch.from_numpy(np.asarray(nd)),
                 torch.from_numpy(np.asarray(off)).long())
    return negatives, masks


def _port_grads(module, batch, negatives, masks):
    params = dict(module.named_parameters())
    loss, _ = module._forward_loss(batch, training=True, negatives=negatives,
                                   dropout_masks=masks)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss), {n: g.numpy() for n, g in zip(params, grads)}


def test_mix_factor_matches_jax():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for e in range(1, 5001):
            assert kge_module._mix_factor(e) == jax_kge._mix_factor(e), e


def test_rolled_index_matches_jax_pairing():
    """``rolled_index`` is the reference's dynamic-slice + transpose
    pairing, written as one index."""
    num_edges, a_dim = 48, 6
    off = np.array([0, 5, 47, 13])
    v = np.arange(num_edges)
    dbl = np.concatenate([v, v])
    want = np.concatenate([
        dbl[o:o + num_edges].reshape(a_dim, -1).T.reshape(-1) for o in off])
    got = kge_module.rolled_index(torch.from_numpy(off), num_edges, a_dim)
    np.testing.assert_array_equal(got.numpy(), want)


def _chi2_uniform(values, n):
    counts = np.bincount(values, minlength=n)
    expected = len(values) / n
    return float(((counts - expected) ** 2 / expected).sum())


def test_sorted_sampler_distribution():
    """Sorted, in range, offsets in [0, E); each batch edge's K negatives
    stratify over K source bands (row k's sources grow with k), and pooled
    over k each edge's negative source and destination are uniform over
    the real nodes."""
    gen = torch.Generator().manual_seed(0)
    num_edges, n_real, draws = 12, 8, 3000
    a_dim = kge_module._mix_factor(num_edges)
    nreal = torch.tensor(n_real)
    src = np.empty((draws, NEG_RATIO, num_edges), np.int64)
    dst = np.empty_like(src)
    for i in range(draws):
        ns, nd, off = kge_module.sample_negatives_sorted(
            gen, NEG_RATIO, num_edges, nreal)
        assert ns.dtype == nd.dtype == torch.int32
        assert bool(torch.all(ns[1:] >= ns[:-1]))
        assert 0 <= int(ns.min()) and int(ns.max()) < n_real
        assert 0 <= int(nd.min()) and int(nd.max()) <= n_real
        assert 0 <= int(off.min()) and int(off.max()) < num_edges
        edge = kge_module.rolled_index(off, num_edges, a_dim).numpy()
        for k in range(NEG_RATIO):
            row = slice(k * num_edges, (k + 1) * num_edges)
            src[i, k, edge[row]] = ns[row].numpy()
            dst[i, k, edge[row]] = nd[row].numpy()
    # 99.99 % quantile of chi-square with 7 degrees of freedom
    limit = 29.88
    for e in range(num_edges):
        assert _chi2_uniform(src[:, :, e].ravel(), n_real) < limit, e
        assert _chi2_uniform(np.minimum(dst[:, :, e].ravel(), n_real - 1),
                             n_real) < limit, e
    band_means = src.mean(axis=(0, 2))
    assert np.all(np.diff(band_means) > 1.0), band_means


def _both_losses(dtype):
    """(JAX loss, JAX grads, port loss, port grads) of one training batch
    with JAX's draws injected."""
    jm, params, module = _modules(dtype)
    jbatch, batch = _raw()
    rng = jax.random.PRNGKey(7)
    (loss_jax, _), grads_jax = jax.value_and_grad(
        lambda p: jm._forward_loss(p, jbatch, rng, training=True),
        has_aux=True)(params)
    negatives, masks = _jax_draws(jm, jbatch, rng)
    loss, grads = _port_grads(module, batch, negatives, masks)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, grads_jax))
    assert set(want) == set(grads)
    return float(loss_jax), want, loss, grads


def test_forward_loss_matches_jax():
    loss_jax, want, loss, grads = _both_losses("float32")
    np.testing.assert_allclose(loss, loss_jax, rtol=1e-5, atol=1e-7)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], rtol=5e-4, atol=1e-6,
                                   err_msg=name)


def test_forward_loss_bf16_matches_jax(monkeypatch):
    """bf16 compute: the loss within 2e-2 of JAX's. JAX's own bf16
    gradients stray up to ~8 % of their max from the float32 gradients at
    this size (it rounds other intermediates than torch does), so each port
    gradient is held to be no further from the float32 gradient than
    JAX's, plus 2e-2 of its max. The port's run must really be bf16 where
    the reference's is: the encoder's messages and output (so its weights,
    x and the aggregation cast back), and the negatives' z; the positive
    path decodes from float32 z."""
    _, f32, _, _ = _both_losses("float32")
    seen = {}

    def spy(owner, name, key, pick):
        fn = getattr(owner, name)

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.setdefault(key, set()).add(pick(args, out).dtype)
            return out
        monkeypatch.setattr(owner, name, wrapped)

    spy(encoders, "sorted_segment_sum", "summed", lambda a, o: a[0])
    spy(encoders.RGCN, "forward", "encoder output", lambda a, o: o)
    spy(decoders, "take_rows_sorted", "positive z", lambda a, o: a[0])
    spy(decoders, "distmult_neg_scores", "negative z", lambda a, o: a[0])
    loss_jax, want, loss, grads = _both_losses("bfloat16")
    # the count table sums float32 ones; the messages are bf16
    assert seen == {"summed": {torch.float32, torch.bfloat16},
                    "encoder output": {torch.bfloat16},
                    "positive z": {torch.float32},
                    "negative z": {torch.bfloat16}}, seen
    assert abs(loss - loss_jax) <= 2e-2 * abs(loss_jax)
    errs = []
    for name, g in grads.items():
        scale = np.abs(f32[name]).max() + 1e-12
        err_jax = np.abs(want[name] - f32[name]).max() / scale
        err = np.abs(g - f32[name]).max() / scale
        assert err <= err_jax + 2e-2, (name, err, err_jax)
        errs.append((err, err_jax))
    # bf16 rounding shows: float32 runs agree to ~1e-6
    assert max(e for e, _ in errs) >= 0.1 * max(j for _, j in errs), errs


def test_eval_loss_matches_jax():
    """training=False: no dropout and the iid (K, E) negatives."""
    jm, params, module = _modules()
    jbatch, batch = _raw()
    rng = jax.random.PRNGKey(3)
    loss_jax, _ = jm._forward_loss(params, jbatch, rng, training=False)
    _, _, r_neg, _, _ = jax.random.split(rng, 5)
    r_s, r_d = jax.random.split(r_neg)
    num_real = int(np.sum(np.asarray(jbatch.node_mask)))
    shape = (NEG_RATIO, jbatch.edge_type.shape[0])
    negatives = tuple(torch.from_numpy(np.asarray(
        (jax.random.uniform(r, shape) * num_real).astype(jnp.int32))).long()
        for r in (r_s, r_d))
    loss, _ = module._forward_loss(batch, training=False,
                                   negatives=negatives)
    np.testing.assert_allclose(float(loss), float(loss_jax), rtol=1e-5)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedule_matches_jax(kind):
    ours = warmup_schedule(kind, 1e-3, 50, 0.2)
    ref = jax_schedule(kind, 1e-3, 50, 0.2)
    for step in range(60):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                   atol=1e-12)
    assert ours(0) == 0.0


def _jax_steps(jm, state, jbatch, keys):
    for key in keys:
        state, _ = jm._grad_update(state, jbatch, key)
    return state


def _port_steps(jm, module, state, jbatch, batch, keys):
    for key in keys:
        negatives, masks = _jax_draws(jm, jbatch, key)
        state, _ = module.train_step(state, batch, negatives=negatives,
                                     dropout_masks=masks)
    return state


def _assert_params_equal(module, jax_params):
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_params))
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_three_optimizer_steps_match_jax():
    """Three Adam steps (the first at schedule(0) = 0) from the same
    weights, the first with a gradient norm above the clip."""
    jm, params, module = _modules()
    jbatch, batch = _raw(scale=30.0)
    jm.configure_optimizers(STEPS)
    module.configure_optimizers(STEPS)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    negatives, masks = _jax_draws(jm, jbatch, keys[0])
    _, grads = _port_grads(module, batch, negatives, masks)
    assert np.sqrt(sum(float((g ** 2).sum()) for g in grads.values())) > 1.0
    jstate = _jax_steps(jm, jax.jit(jm.init_state)(jax.random.PRNGKey(0)),
                        jbatch, keys)
    state = _port_steps(jm, module, module.init_state(), jbatch, batch, keys)
    assert state.step == 3 and state.opt_state.count == 3
    _assert_params_equal(module, jstate.params)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    """A JAX checkpoint (params, optax Adam moments and counts) resumes in
    the port to the same next step."""
    jm, _, _ = _modules()
    jbatch, batch = _raw()
    jm.configure_optimizers(STEPS)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    jstate = _jax_steps(jm, jm.init_state(jax.random.PRNGKey(0)), jbatch,
                        keys[:2])
    path = str(tmp_path / "jax.ckpt")
    jax_ckpt.save_checkpoint(path, "kge", jm.hparams, jstate.params,
                             opt_state=jstate.opt_state, step=2)
    jstate = _jax_steps(jm, jstate, jbatch, keys[2:])

    module = kge_module.KGEModule(**_hparams())
    module.edge_layout = "dst"
    module.configure_optimizers(STEPS)
    state = load_train_state(path, module)
    assert state.step == 2 and state.opt_state.count == 2
    state = _port_steps(jm, module, state, jbatch, batch, keys[2:])
    _assert_params_equal(module, jstate.params)


def test_port_checkpoint_loads_in_jax_and_resumes(tmp_path):
    jm, _, module = _modules()
    _, batch = _raw()
    module.configure_optimizers(STEPS)
    gen = torch.Generator().manual_seed(0)
    state, _ = module.train_steps(module.init_state(), [batch, batch], gen)
    path = str(tmp_path / "port.ckpt")
    save_train_state(path, module, state)

    loaded, params = jax_kge.load_kge_module(path)
    assert loaded.hparams == module.hparams
    _assert_params_equal(module, params)
    assert jax_ckpt.load_checkpoint(path)["step"] == 2

    again = kge_module.KGEModule(**_hparams())
    again.configure_optimizers(STEPS)
    resumed = load_train_state(path, again)
    assert resumed.step == 2 and resumed.opt_state.count == 2
    for a, b in zip(resumed.opt_state.nu, state.opt_state.nu):
        assert torch.equal(a, b)


def test_training_raises_on_paths_not_ported():
    _, batch = _raw()
    module = kge_module.KGEModule(**dict(_hparams(),
                                         cold_start_dropout=0.1))
    with pytest.raises(NotImplementedError, match="cold_start"):
        module._forward_loss(batch, True, torch.Generator())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        module.filter_negatives = True
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        module.fix_edge_id = 0


def test_train_kge_cli_writes_a_checkpoint_the_scorer_serves(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BIOMEDKG_SYNTHETIC_SCALE", raising=False)
    path = train_kge_main(["steps=2", "epochs=1", "val_every_epoch=1",
                           "device=cpu", f"ckpt_dir={tmp_path / 'ck'}",
                           f"log_dir={tmp_path / 'log'}", "seed=3",
                           "model.compute_dtype=bfloat16"])
    assert os.path.exists(path)
    dm = PrimeKGModule(**dict(PRIMEKG_DATA, data_dir=str(tmp_path / "d")),
                       seed=3)
    scorer = KGEScorer(path, dm, device="cpu")
    p = scorer.score("gene_000000", "protein_protein", "gene_000001")
    assert 0.0 < p < 1.0
    assert scorer.module.hparams["compute_dtype"] == "bfloat16"


def test_dual_sampler_distribution():
    """The "sorted2" draws (tests/test_negatives.py:231-290 for the
    reference's): every BLOCK chunk of nd lies in a circular band of at
    most N/nc + 1 ids, each slot's marginal is uniform across steps, dst is
    independent of src, and the band placements vary; the sources stay the
    sorted sampler's."""
    block = kge_module.BLOCK
    k, n, steps = 4, 200, 200
    num_edges = block // 2
    ke = k * num_edges
    nc = ke // block
    gen = torch.Generator().manual_seed(11)
    probe = [0, 137, block + 17, ke - 1]
    slot_vals = {j: [] for j in probe}
    src137, dst137, band_mins = [], [], []
    counts = np.zeros(n)
    for _ in range(steps):
        ns, nd, off = kge_module.sample_negatives_sorted(
            gen, k, num_edges, torch.tensor(n), dual=True)
        assert ns.dtype == nd.dtype == torch.int32
        assert bool(torch.all(ns[1:] >= ns[:-1]))
        nd = nd.numpy()
        assert nd.min() >= 0 and nd.max() < n
        for c in range(nc):
            chunk = np.unique(nd[c * block:(c + 1) * block])
            gaps = np.diff(np.concatenate([chunk, [chunk[0] + n]]))
            assert n - gaps.max() <= n // nc + 1
            if c == 0:
                band_mins.append(int(chunk.min()))
        np.add.at(counts, nd, 1)
        for j in probe:
            slot_vals[j].append(int(nd[j]))
        src137.append(int(ns[137]))
        dst137.append(int(nd[137]))
    for j, vals in slot_vals.items():
        hist = np.bincount(np.asarray(vals) * 8 // n, minlength=8)
        z = (hist - steps / 8) / np.sqrt(steps / 8)
        assert np.abs(z).max() < 5.0, (j, hist)
    assert (counts > 0).all()
    assert abs(np.corrcoef(src137, dst137)[0, 1]) < 0.3
    assert len(set(band_mins)) > 20
    # K·E not a multiple of BLOCK: one chunk, iid over the whole range
    _, nd, _ = kge_module.sample_negatives_sorted(
        gen, 3, 1000, torch.tensor(n), dual=True)
    assert nd.max() - nd.min() > n // 2


def _decoder_hparams(decoder):
    return dict(_hparams(), decoder_name=decoder)


def test_jax_rotate_checkpoint_resumes_in_port(tmp_path):
    """A JAX RotatE checkpoint (its (R, d/2) phases, Adam moments and
    counts) resumes in the port to the same next step."""
    jm = jax_kge.KGEModule(**_decoder_hparams("rotate"))
    jm.edge_layout = "dst"
    jbatch, batch = _raw()
    jm.configure_optimizers(STEPS)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    jstate = _jax_steps(jm, jm.init_state(jax.random.PRNGKey(0)), jbatch,
                        keys[:2])
    path = str(tmp_path / "jax_rotate.ckpt")
    jax_ckpt.save_checkpoint(path, "kge", jm.hparams, jstate.params,
                             opt_state=jstate.opt_state, step=2)
    jstate = _jax_steps(jm, jstate, jbatch, keys[2:])

    module = kge_module.KGEModule(**_decoder_hparams("rotate"))
    module.edge_layout = "dst"
    module.configure_optimizers(STEPS)
    state = load_train_state(path, module)
    assert state.step == 2 and state.opt_state.count == 2
    assert module.model.decoder.rel_emb.shape == (R, D_HID // 2)
    state = _port_steps(jm, module, state, jbatch, batch, keys[2:])
    _assert_params_equal(module, jstate.params)


def test_port_complex_params_load_in_jax(tmp_path):
    module = kge_module.KGEModule(**_decoder_hparams("complex"))
    module.edge_layout = "dst"
    module.configure_optimizers(STEPS)
    _, batch = _raw()
    state, _ = module.train_steps(module.init_state(
        torch.Generator().manual_seed(0)), [batch],
        torch.Generator().manual_seed(1))
    path = str(tmp_path / "port_complex.ckpt")
    save_train_state(path, module, state)
    loaded, params = jax_kge.load_kge_module(path)
    assert loaded.hparams["decoder_name"] == "complex"
    assert type(loaded.model.decoder).__name__ == "ComplEx"
    _assert_params_equal(module, params)


def test_train_kge_cli_rotate_sorted2_checkpoint_is_served(
        tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BIOMEDKG_SYNTHETIC_SCALE", raising=False)
    path = train_kge_main(["steps=2", "epochs=1", "val_every_epoch=1",
                           "device=cpu", f"ckpt_dir={tmp_path / 'ck'}",
                           f"log_dir={tmp_path / 'log'}", "seed=3",
                           "model.decoder_name=rotate",
                           "model.neg_sampler=sorted2"])
    assert "rgcn_rotate_" in path
    dm = PrimeKGModule(**dict(PRIMEKG_DATA, data_dir=str(tmp_path / "d")),
                       seed=3)
    scorer = KGEScorer(path, dm, device="cpu")
    assert scorer.module.hparams["neg_sampler"] == "sorted2"
    assert type(scorer.decoder).__name__ == "RotatE"
    p = scorer.score("gene_000000", "protein_protein", "gene_000001")
    assert 0.0 < p < 1.0
    top = scorer.topk_tails("gene_000000", "protein_protein", 3)
    assert len(top) == 3 and top[0][1] >= top[-1][1]
