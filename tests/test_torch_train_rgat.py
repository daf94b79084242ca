"""RGAT in the port's KGE training against the JAX package: a JAX RGAT
checkpoint resumes in the port to the same next step, a port RGAT
checkpoint loads in JAX and resumes, and ``train_kge
model.encoder_name=rgat`` writes a checkpoint that ``KGEScorer`` serves in
the relation layout. The helpers and tolerances are
tests/test_torch_train_step.py's (parameters after Adam steps 1e-5).
"""

import jax
import torch
from test_torch_train_step import (R, D_HID, D_IN, STEPS, _assert_params_equal,
                                   _hparams, _jax_steps, _port_steps, _raw)

from biomedkg_tpu.training import checkpoint as jax_ckpt
from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu_torch.data.modules import PrimeKGModule
from biomedkg_tpu_torch.serve import PRIMEKG_DATA
from biomedkg_tpu_torch.serving import KGEScorer
from biomedkg_tpu_torch.train_kge import main as train_kge_main
from biomedkg_tpu_torch.training import kge_module
from biomedkg_tpu_torch.training.checkpoint import load_train_state, \
    save_train_state


def _rgat_hparams():
    return dict(_hparams(), encoder_name="rgat")


def test_jax_rgat_checkpoint_resumes_in_port(tmp_path):
    """A JAX RGAT checkpoint (its head-major w_rel, attention vectors, Adam
    moments and counts) resumes in the port to the same next step on a
    relation-layout batch."""
    jm = jax_kge.KGEModule(**_rgat_hparams())
    jbatch, batch = _raw(edge_budget=512, layout="relation")
    jm.configure_optimizers(STEPS)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    jstate = _jax_steps(jm, jm.init_state(jax.random.PRNGKey(0)), jbatch,
                        keys[:2])
    path = str(tmp_path / "jax_rgat.ckpt")
    jax_ckpt.save_checkpoint(path, "kge", jm.hparams, jstate.params,
                             opt_state=jstate.opt_state, step=2)
    jstate = _jax_steps(jm, jstate, jbatch, keys[2:])

    module = kge_module.KGEModule(**_rgat_hparams())
    module.configure_optimizers(STEPS)
    state = load_train_state(path, module)
    assert state.step == 2 and state.opt_state.count == 2
    assert module.model.encoder.layers[0].w_rel.shape == (R, D_IN, 2 * D_HID)
    state = _port_steps(jm, module, state, jbatch, batch, keys[2:])
    _assert_params_equal(module, jstate.params)


def test_port_rgat_checkpoint_loads_in_jax_and_resumes(tmp_path):
    module = kge_module.KGEModule(**_rgat_hparams())
    module.configure_optimizers(STEPS)
    _, batch = _raw(edge_budget=512, layout="relation")
    state, _ = module.train_steps(module.init_state(
        torch.Generator().manual_seed(0)), [batch, batch],
        torch.Generator().manual_seed(1))
    path = str(tmp_path / "port_rgat.ckpt")
    save_train_state(path, module, state)
    loaded, params = jax_kge.load_kge_module(path)
    assert type(loaded.model.encoder).__name__ == "RGAT"
    _assert_params_equal(module, params)

    again = kge_module.KGEModule(**_rgat_hparams())
    again.configure_optimizers(STEPS)
    resumed = load_train_state(path, again)
    assert resumed.step == 2 and resumed.opt_state.count == 2
    for a, b in zip(resumed.opt_state.mu + resumed.opt_state.nu,
                    state.opt_state.mu + state.opt_state.nu):
        assert torch.equal(a, b)


def test_train_kge_cli_rgat_checkpoint_is_served(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BIOMEDKG_SYNTHETIC_SCALE", raising=False)
    path = train_kge_main(["steps=1", "epochs=1", "device=cpu",
                           f"ckpt_dir={tmp_path / 'ck'}", "seed=3",
                           "model.encoder_name=rgat"])
    assert "rgat_dismult_" in path
    dm = PrimeKGModule(**dict(PRIMEKG_DATA, data_dir=str(tmp_path / "d")),
                       seed=3)
    scorer = KGEScorer(path, dm, device="cpu")
    encoder = scorer.module.model.encoder
    assert type(encoder).__name__ == "RGAT" and encoder.num_heads == 2
    assert scorer.module.edge_layout == "relation"
    p = scorer.score("gene_000000", "protein_protein", "gene_000001")
    assert 0.0 < p < 1.0
    top = scorer.topk_tails("gene_000000", "protein_protein", 3)
    assert len(top) == 3 and top[0][1] >= top[-1][1]
