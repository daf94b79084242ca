"""The port's KGE training step with each decoder (DistMult, ComplEx,
TransE, RotatE) and each sorted sampler ("sorted", "sorted2") against the
JAX package: ``_forward_loss`` with the reference's negatives and dropout
masks injected (its key splits replayed), in float32 and in bf16.

The batch's K·E = 4,096 negative slots are two chunks of ``BLOCK``, so the
"sorted2" draws band. Tolerances: float32 loss 1e-5 and gradients 5e-4
relative (as tests/test_torch_train_step.py; only summation orders
differ). bf16: the loss within 2e-2 of JAX's, and each gradient no further
from the float32 gradient than JAX's own bf16 gradient is, plus 2e-2 of
its max (the frameworks round bf16 intermediates at different places).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from biomedkg_tpu.training import kge_module as jax_kge
from biomedkg_tpu_torch.interop.jax_params import flatten_tree, \
    load_jax_params
from biomedkg_tpu_torch.models import decoders, encoders
from biomedkg_tpu_torch.ops import negscore
from biomedkg_tpu_torch.training import kge_module
from test_torch_train_step import N_REAL, _hparams, _jax_draws, _raw

NEG_RATIO, EDGE_BUDGET = 4, 1024
DECODERS = ["dismult", "complex", "transe", "rotate"]
MODE = {"dismult": "distmult", "complex": "complex", "transe": "transe",
        "rotate": "rotate"}
CASES = [(d, s) for d in DECODERS for s in ("sorted", "sorted2")]


def _both(decoder, sampler, dtype):
    """(JAX loss, JAX grads, port loss, port grads) of one training batch
    with JAX's draws injected."""
    hp = dict(_hparams(dtype), decoder_name=decoder, neg_sampler=sampler,
              neg_ratio=NEG_RATIO)
    jm = jax_kge.KGEModule(**hp)
    jm.edge_layout = "dst"
    params = jm.init(jax.random.PRNGKey(0))
    module = kge_module.KGEModule(**hp)
    module.edge_layout = "dst"
    load_jax_params(module.model, jax.tree_util.tree_map(np.asarray, params))
    jbatch, batch = _raw(num_edges=300, edge_budget=EDGE_BUDGET)
    rng = jax.random.PRNGKey(7)
    (loss_jax, _), grads_jax = jax.jit(jax.value_and_grad(
        lambda p: jm._forward_loss(p, jbatch, rng, training=True),
        has_aux=True))(params)
    negatives, masks = _jax_draws(jm, jbatch, rng, sampler == "sorted2")
    named = dict(module.named_parameters())
    loss, _ = module._forward_loss(batch, training=True, negatives=negatives,
                                   dropout_masks=masks)
    grads = torch.autograd.grad(loss, list(named.values()))
    grads = {n: g.numpy() for n, g in zip(named, grads)}
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, grads_jax))
    assert set(want) == set(grads)
    return float(loss_jax), want, float(loss.detach()), grads, negatives


_float32 = functools.lru_cache(maxsize=None)(
    lambda decoder, sampler: _both(decoder, sampler, "float32"))


@pytest.mark.parametrize("decoder,sampler", CASES)
def test_forward_loss_matches_jax(decoder, sampler):
    loss_jax, want, loss, grads, negatives = _float32(decoder, sampler)
    if sampler == "sorted2":     # the injected draws band per chunk
        nd = negatives[1].numpy().reshape(-1, negscore.BLOCK)
        assert (nd.max(1) - nd.min(1) <= N_REAL // 2 + 1).sum() >= 1
    np.testing.assert_allclose(loss, loss_jax, rtol=1e-5, atol=1e-7)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], rtol=5e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("decoder,sampler", CASES)
def test_forward_loss_bf16_matches_jax(decoder, sampler, monkeypatch):
    """bf16 compute, held as tests/test_torch_train_step.py holds DistMult
    with "sorted": the encoder's messages and output and the negatives' z
    are bf16, the positive path decodes float32 z, and the negatives go
    through the decoder's mode and the sampler's family."""
    _, f32, _, _, _ = _float32(decoder, sampler)
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
    spy(decoders, negscore.kernel_name(MODE[decoder], sampler == "sorted2"),
        "negative z", lambda a, o: a[0])
    loss_jax, want, loss, grads, _ = _both(decoder, sampler, "bfloat16")
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
