"""The port's held-out evaluation against the JAX package: the KGE eval
step (``_forward_loss(training=False)`` with JAX's iid negatives
injected), its device reduction ``_reduce_eval_aux``, ``eval_epoch`` on
both impls ("histogram" and "exact"), TransE's F1 of exactly 0 (hazard
H5) and the GCL eval step and ``eval_epoch``.

Tolerances: the eval step's ``pred``, ``pos_pred`` and loss within 1e-5
relative in float32 (only summation orders differ), 2e-2 in bfloat16
(the two frameworks round bf16 intermediates at different places, as
tests/test_torch_train_step.py); ``_reduce_eval_aux`` on the same aux
arrays: ``hist``, ``f1_counts``, ``edge_counts`` and ``edge_above``
identical, with no bin-move allowance (torch's and XLA's float32 sigmoids
put every slot of these batches in the same bin); ``eval_epoch`` on the
same states or aux arrays: the same keys, values within 1e-12; the GCL
eval loss within 1e-5 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu_torch.interop.jax_params import load_jax_params
from biomedkg_tpu_torch.training import kge_module

from test_torch_gcl import _jax_draws as _gcl_draws
from test_torch_gcl import _modules as _gcl_modules
from test_torch_gcl import _raw as _gcl_raw
from test_torch_train_step import NEG_RATIO, _hparams, _raw

MAPPING = {0: "drug_drug", 1: "indication", 2: "off-label use",
           3: "disease_protein"}
BATCHES = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _modules(dtype="float32", decoder="dismult"):
    hp = dict(_hparams(dtype), decoder_name=decoder)
    jm = jax_kge.KGEModule(**hp)
    jm.edge_layout = "dst"
    jm.edge_mapping = MAPPING
    params = jm.init(jax.random.PRNGKey(0))
    module = kge_module.KGEModule(**hp)
    module.edge_layout = "dst"
    module.edge_mapping = MAPPING
    load_jax_params(module.model, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, module


def _iid_negatives(jbatch, rng):
    """The iid (K, E) negatives JAX's eval ``_forward_loss`` draws from
    ``rng`` (its key splits, training/kge_module.py)."""
    _, _, r_neg, _, _ = jax.random.split(rng, 5)
    r_s, r_d = jax.random.split(r_neg)
    num_edges = jbatch.edge_type.shape[0]
    num_real = jnp.maximum(jnp.sum(jbatch.node_mask.astype(jnp.int32)), 1)

    def draw(r):
        return _t((jax.random.uniform(r, (NEG_RATIO, num_edges)) * num_real)
                  .astype(jnp.int32)).long()

    return draw(r_s), draw(r_d)


def _eval_pair(jm, params, module, seed):
    """(JAX aux, port aux) of one eval batch on the same inputs."""
    jbatch, batch = _raw(seed=seed)
    rng = jax.random.PRNGKey(100 + seed)
    _, jaux = jm._forward_loss(params, jbatch, rng, training=False)
    module.eval_impl = "exact"
    aux = module.eval_step(batch, negatives=_iid_negatives(jbatch, rng))
    return jax.tree_util.tree_map(np.asarray, jaux), aux


@pytest.mark.parametrize("decoder", ["dismult", "transe", "rotate"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_eval_step_matches_jax(dtype, decoder):
    jm, params, module = _modules(dtype, decoder)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for seed in range(2):
        jaux, aux = _eval_pair(jm, params, module, seed)
        for key in ("pred", "pos_pred", "loss"):
            want = np.asarray(jaux[key], np.float32)
            got = aux[key].float().numpy()
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= tol * scale, key
        for key in ("gt", "weights", "edge_type", "edge_mask"):
            np.testing.assert_array_equal(aux[key].numpy(),
                                          np.asarray(jaux[key]))
        assert not aux["pred"].requires_grad


def _jax_states_and_port(decoder="dismult"):
    """JAX's aux of BATCHES eval batches, and the port's reduction of the
    same arrays."""
    jm, params, module = _modules(decoder=decoder)
    auxes = [_eval_pair(jm, params, module, seed)[0]
             for seed in range(BATCHES)]
    return jm, module, auxes


def test_reduce_eval_aux_matches_jax():
    jm, module, auxes = _jax_states_and_port()
    for jaux in auxes:
        want = jax.tree_util.tree_map(
            np.asarray, jm._reduce_eval_aux(
                jax.tree_util.tree_map(jnp.asarray, jaux)))
        got = module._reduce_eval_aux({k: _t(v) for k, v in jaux.items()})
        assert set(got) == set(want)
        for key in ("hist", "f1_counts", "edge_counts", "edge_above"):
            assert got[key].dtype == torch.float32
            np.testing.assert_array_equal(got[key].numpy(), want[key])
        assert float(got["loss"]) == float(want["loss"])
        assert float(got["hist"].sum()) == float(jaux["weights"].sum())


@pytest.mark.parametrize("impl", ["histogram", "exact"])
def test_eval_epoch_matches_jax(impl):
    """The same outputs through both packages' ``eval_epoch``: reduced
    states (each package's own reduction of the same aux) or the aux
    arrays themselves."""
    jm, module, auxes = _jax_states_and_port()
    if impl == "histogram":
        jouts = [jm._reduce_eval_aux(jax.tree_util.tree_map(jnp.asarray, a))
                 for a in auxes]
        outs = [module._reduce_eval_aux({k: _t(v) for k, v in a.items()})
                for a in auxes]
    else:
        jouts = auxes
        outs = [{k: _t(v) for k, v in a.items()} for a in auxes]
    for split in ("val", "test"):
        want = jm.eval_epoch(jouts, split)
        got = module.eval_epoch(outs, split)
        assert sorted(got) == sorted(want)
        assert {f"{v}_pre" for v in MAPPING.values()} <= set(got)
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-12, key


def test_eval_epoch_sums_states_in_float64(monkeypatch):
    """A bin past 2^24 over an epoch stays exact: the float32 states are
    summed in float64 (a float32 sum would drop the second state's 1)."""
    _, module, auxes = _jax_states_and_port()
    state = module._reduce_eval_aux({k: _t(v) for k, v in auxes[0].items()})
    hist = torch.zeros_like(state["hist"])
    big, one = hist.clone(), hist.clone()
    big[1, 100], one[1, 100] = 2.0 ** 24, 1.0
    merged = []
    merge = kge_module.HistogramBinaryMetrics.merge_state
    monkeypatch.setattr(kge_module.HistogramBinaryMetrics, "merge_state",
                        lambda self, h, c: (merged.append(h.copy()),
                                            merge(self, h, c)))
    module.eval_epoch([dict(state, hist=big), dict(state, hist=one)], "val")
    assert merged[0][1, 100] == 2.0 ** 24 + 1.0


def test_transe_test_f1_is_zero():
    """Hazard H5: TransE scores are negative distances, so no prediction
    clears the 0.5 threshold and the port's test F1 is exactly 0, as the
    reference's; its per-relation precisions are 0 too."""
    jm, params, module = _modules(decoder="transe")
    module.eval_impl = "histogram"
    outs, jouts = [], []
    for seed in range(BATCHES):
        jaux, _ = _eval_pair(jm, params, module, seed)
        module.eval_impl = "histogram"
        jbatch, batch = _raw(seed=seed)
        rng = jax.random.PRNGKey(100 + seed)
        outs.append(module.eval_step(batch,
                                     negatives=_iid_negatives(jbatch, rng)))
        jouts.append(jm._reduce_eval_aux(
            jax.tree_util.tree_map(jnp.asarray, jaux)))
    got = module.eval_epoch(outs, "test")
    want = jm.eval_epoch(jouts, "test")
    assert got["test_F1"] == want["test_F1"] == 0.0
    assert all(got[f"{v}_pre"] == 0.0 for v in MAPPING.values())


@pytest.mark.parametrize("name", ["grace", "dgi", "ggd"])
def test_gcl_eval_matches_jax(name):
    """The GCL eval step's loss (JAX's draws injected; no dropout in
    eval) and ``eval_epoch`` over a few batches."""
    jm, params, module = _gcl_modules(name, "float32")
    jlosses, outs = [], []
    for seed in range(BATCHES):
        jbatch, batch = _gcl_raw(seed=seed)
        rng = jax.random.PRNGKey(7 + seed)
        jloss, jaux = jm._forward_loss(params, jbatch, rng, training=False)
        out = module.eval_step(batch,
                               draws=_gcl_draws(name, jm, jbatch, rng))
        np.testing.assert_allclose(float(out["loss"]), float(jloss),
                                   rtol=1e-5)
        jlosses.append({"loss": np.asarray(jaux["loss"])})
        outs.append(out)
    for split in ("val", "test"):
        want = jm.eval_epoch(jlosses, split)
        got = module.eval_epoch(
            [{"loss": _t(o["loss"])} for o in jlosses], split)
        assert got == want
        assert set(module.eval_epoch(outs, split)) == {f"{split}_loss"}
    assert module.eval_epoch([], "val") == jm.eval_epoch([], "val")
