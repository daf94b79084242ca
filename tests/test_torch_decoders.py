"""The port's TransE, ComplEx and RotatE decoders against the JAX package's
in float32 on the CPU: per-edge ``score`` (both tail layouts) with its
gradients, the iid ``score_neg``, ``score_all_tails`` and
``score_all_heads``, and the init rules' shapes and norms.

Tolerance: 1e-5 (float32 on both sides; summation order differs).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.models import decoders as jax_decoders
from biomedkg_tpu_torch.models import decoders
from biomedkg_tpu_torch.models.factory import DECODERS, KGEModelFactory

N, D, R, E, K = 60, 16, 5, 40, 3
NAMES = ["transe", "complex", "rotate"]


def _pair(name):
    """(port decoder, JAX decoder, JAX params) sharing one relation
    parameter drawn with numpy."""
    port = DECODERS[name](R, D)
    jdec = {"transe": jax_decoders.TransE, "complex": jax_decoders.ComplEx,
            "rotate": jax_decoders.RotatE}[name](R, D)
    rng = np.random.default_rng(len(name))
    rel_emb = rng.standard_normal(tuple(port.rel_emb.shape)).astype(
        np.float32)
    with torch.no_grad():
        port.rel_emb.copy_(torch.from_numpy(rel_emb))
    return port, jdec, {"rel_emb": jnp.asarray(rel_emb)}


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((N, D)).astype(np.float32)
    head = rng.integers(0, N, E)
    tail = np.sort(rng.integers(0, N, E))
    rel = rng.integers(0, R, E)
    return z, head, tail, rel


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("tail_sorted", [False, True])
def test_score_and_gradients_match_jax(name, tail_sorted):
    port, jdec, params = _pair(name)
    z, head, tail, rel = _graph(1)
    cot = np.random.default_rng(2).standard_normal(E).astype(np.float32)
    zt = _t(z).requires_grad_(True)
    got = port.score(zt, _t(head), _t(tail), _t(rel), tail_sorted=tail_sorted)
    gz, gr = torch.autograd.grad(got, (zt, port.rel_emb), _t(cot))

    def f(p, zz):
        return jdec.score(p, zz, jnp.asarray(head), jnp.asarray(tail),
                          jnp.asarray(rel), tail_sorted=tail_sorted)

    want = f(params, jnp.asarray(z))
    jgr, jgz = jax.grad(lambda p, zz: jnp.sum(f(p, zz) * cot), (0, 1))(
        params, jnp.asarray(z))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gz.numpy(), jgz, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gr.numpy(), jgr["rel_emb"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_iid_score_neg_matches_jax(name):
    port, jdec, params = _pair(name)
    z, _, _, rel = _graph(3)
    rng = np.random.default_rng(4)
    neg_src, neg_dst = (rng.integers(0, N, (K, E)) for _ in range(2))
    got = port.score_neg(_t(z), _t(neg_src), _t(neg_dst), _t(rel))
    want = jdec.score_neg(params, jnp.asarray(z), jnp.asarray(neg_src),
                          jnp.asarray(neg_dst), jnp.asarray(rel))
    assert got.shape == (K, E) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("side", ["tails", "heads"])
def test_score_all_matches_jax(name, side):
    port, jdec, params = _pair(name)
    z, head, _, rel = _graph(5)
    fn = f"score_all_{side}"
    got = getattr(port, fn)(_t(z), _t(head[:7]), _t(rel[:7]))
    want = getattr(jdec, fn)(params, jnp.asarray(z), jnp.asarray(head[:7]),
                             jnp.asarray(rel[:7]))
    assert got.shape == (7, N)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_score_all_tails_agrees_with_score():
    """Column t of ``score_all_tails`` is the per-edge score of (h, r, t)."""
    z, head, _, rel = _graph(6)
    for name in NAMES:
        port, _, _ = _pair(name)
        every = port.score_all_tails(_t(z), _t(head), _t(rel))
        tails = torch.arange(E) % N
        one = port.score(_t(z), _t(head), tails, _t(rel))
        np.testing.assert_allclose(every[torch.arange(E), tails].detach(),
                                   one.detach(), rtol=1e-5, atol=1e-5)


def test_init_rules():
    """TransE: rows of unit L2 norm (uniform ±6/√d before normalising);
    ComplEx: xavier (R, d); RotatE: phases (R, d/2) in [−π, π], γ 12 a
    constructor argument and not a parameter."""
    gen = torch.Generator().manual_seed(0)
    transe = decoders.TransE(R, D)
    transe.init(gen)
    norms = transe.rel_emb.detach().norm(dim=1)
    np.testing.assert_allclose(norms.numpy(), np.ones(R), rtol=1e-6)
    complex_ = decoders.ComplEx(R, D)
    complex_.init(gen)
    bound = math.sqrt(6.0 / (R + D))
    assert complex_.rel_emb.shape == (R, D)
    assert float(complex_.rel_emb.detach().abs().max()) <= bound
    rotate = decoders.RotatE(R, D)
    rotate.init(gen)
    assert rotate.rel_emb.shape == (R, D // 2)
    assert float(rotate.rel_emb.detach().abs().max()) <= math.pi
    assert float(rotate.rel_emb.detach().std()) > 1.0   # spread out
    assert rotate.gamma == 12.0 and decoders.RotatE(R, D, gamma=3.0).gamma \
        == 3.0
    assert [n for n, _ in rotate.named_parameters()] == ["rel_emb"]
    for name, dec in (("transe", transe), ("complex", complex_),
                      ("rotate", rotate)):
        want = jax.tree_util.tree_map(
            np.shape, {"transe": jax_decoders.TransE,
                       "complex": jax_decoders.ComplEx,
                       "rotate": jax_decoders.RotatE}[name](R, D).init(
                jax.random.PRNGKey(0)))
        assert want == {"rel_emb": tuple(dec.rel_emb.shape)}


@pytest.mark.parametrize("name", ["dismult", "distmult", "transe", "complex",
                                  "rotate"])
def test_factory_builds_every_decoder(name):
    model = KGEModelFactory.get_model("rgcn", name, 8, 8, 8, 1, 4)
    assert type(model.decoder) is DECODERS[name]
    model.init(torch.Generator().manual_seed(0))
    assert torch.isfinite(model.decoder.rel_emb).all()
    with pytest.raises(ValueError, match="Unknown decoder"):
        KGEModelFactory.get_model("rgcn", "nope", 8, 8, 8, 1, 4)
