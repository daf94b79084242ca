"""The port's fused DistMult negative scoring (its plain torch version,
which CPU tensors run, differentiated by autograd) against the JAX
package: the unfused ``DistMult.score_neg_sorted`` on the CPU and the
Pallas ``negscore.distmult_neg_scores`` in interpret mode, as
tests/test_ops.py runs it.

Tolerances: float32 1e-5 (summation order only); bfloat16 2e-2 on values
and 3e-2 of the max on gradients, the figures tests/test_ops.py uses for
the JAX kernel (the two frameworks round bf16 products and cotangents at
different places; the Pallas kernel rounds h·t and its cotangents to bf16).

Out-of-range ``nd`` are clipped into [0, N) forward and backward, as the
JAX kernel does (``safe_nd`` in its backward); the reference's unfused
path clips them forward but drops them from its scatter, so it gets the
ids clipped beforehand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biomedkg_tpu.models.decoders import DistMult as JaxDistMult
from biomedkg_tpu.ops.pallas import negscore as jax_negscore
from biomedkg_tpu_torch.models.decoders import DistMult
from biomedkg_tpu_torch.ops import negscore

M, R, D = 2 * 2048, 5, 128


def _inputs(n, seed):
    """z (n, D), ns ascending, nd with out-of-range values to clip, rel,
    rel_emb and an upstream gradient, as numpy."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, D)).astype(np.float32)
    ns = np.sort(rng.integers(0, n, M)).astype(np.int32)
    nd = rng.integers(0, n, M).astype(np.int32)
    nd[rng.choice(M, 40, replace=False)] = n + 3        # clipped to n - 1
    nd[rng.choice(M, 40, replace=False)] = -2           # clipped to 0
    rel = rng.integers(0, R, M).astype(np.int32)
    re = rng.standard_normal((R, D)).astype(np.float32)
    cot = rng.standard_normal(M).astype(np.float32)
    return z, ns, nd, rel, re, cot


def _port(z, ns, nd, rel, re, cot, dtype):
    zt = torch.from_numpy(z).to(dtype).requires_grad_(True)
    ret = torch.from_numpy(re).requires_grad_(True)
    s = negscore.distmult_neg_scores(zt, torch.from_numpy(ns),
                                     torch.from_numpy(nd),
                                     torch.from_numpy(rel), ret)
    assert s.dtype == torch.float32 and s.shape == (M,)
    gz, gr = torch.autograd.grad(s, (zt, ret), torch.from_numpy(cot))
    assert gz.dtype == dtype and gr.dtype == torch.float32
    return (s.detach().numpy(), gz.float().numpy(), gr.numpy())


def _jax(fn, z, ns, nd, rel, re, cot, dtype):
    def f(z, re):
        return jnp.sum(fn(z.astype(dtype), jnp.asarray(ns), jnp.asarray(nd),
                          jnp.asarray(rel), re) * cot)

    s = fn(jnp.asarray(z).astype(dtype), jnp.asarray(ns), jnp.asarray(nd),
           jnp.asarray(rel), jnp.asarray(re))
    gz, gr = jax.grad(f, (0, 1))(jnp.asarray(z), jnp.asarray(re))
    return (np.asarray(s, np.float32), np.asarray(gz, np.float32),
            np.asarray(gr, np.float32))


def _unfused(z, ns, nd, rel, re):
    return JaxDistMult(R, D).score_neg_sorted({"rel_emb": re}, z, ns, nd,
                                              rel)


def _assert_close(got, want, value_tol, grad_tol):
    s, gz, gr = got
    ws, wgz, wgr = want
    if grad_tol is None:
        np.testing.assert_allclose(s, ws, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gz, wgz, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(gr, wgr, rtol=1e-5, atol=1e-4)
        return
    np.testing.assert_allclose(s, ws, rtol=value_tol, atol=value_tol)
    for a, b in ((gz, wgz), (gr, wgr)):
        assert np.abs(a - b).max() <= grad_tol * np.abs(b).max()


@pytest.mark.parametrize("n", [100, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_unfused(n, dtype):
    inputs = _inputs(n, seed=n)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    got = _port(*inputs, tdt)
    z, ns, nd, rel, re, cot = inputs
    want = _jax(_unfused, z, ns, np.clip(nd, 0, n - 1), rel, re, cot, jdt)
    if dtype == "float32":
        _assert_close(got, want, None, None)
    else:
        _assert_close(got, want, 2e-2, 3e-2)


@pytest.mark.parametrize("n", [100, 300])
def test_plain_matches_jax_pallas_interpret(n):
    """The Pallas kernel (bf16 internals) against the port's plain version
    on the same bf16 inputs."""
    inputs = _inputs(n, seed=n + 1)
    got = _port(*inputs, torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = _jax(jax_negscore.distmult_neg_scores, *inputs, jnp.bfloat16)
    s, gz, gr = got
    ws, wgz, wgr = want
    assert np.abs(s - ws).max() <= 2e-2 * np.abs(ws).max()
    for a, b in ((gz, wgz), (gr, wgr)):
        assert np.abs(a - b).max() <= 3e-2 * np.abs(b).max()


def test_decoder_scores_through_negscore():
    """``DistMult.score_neg_sorted`` is the fused function of z and the
    decoder's rel_emb."""
    z, ns, nd, rel, re, _ = _inputs(100, seed=3)
    dec = DistMult(R, D)
    with torch.no_grad():
        dec.rel_emb.copy_(torch.from_numpy(re))
    args = (torch.from_numpy(z), torch.from_numpy(ns), torch.from_numpy(nd),
            torch.from_numpy(rel))
    got = dec.score_neg_sorted(*args)
    want = negscore.distmult_neg_scores_plain(*args, dec.rel_emb)
    assert torch.equal(got, want)
    ndc = np.clip(nd, 0, 99)
    brute = np.sum(z[ns] * re[rel] * z[ndc], axis=1)
    np.testing.assert_allclose(got.detach().numpy(), brute, rtol=1e-5,
                               atol=1e-5)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never compute on the CPU; only the dispatch in
    distmult_neg_scores sends CPU tensors to the plain version."""
    z, ns, nd, rel, re, cot = (torch.from_numpy(a) for a in _inputs(50, 0))
    fwd = negscore.KERNELS["distmult_neg_scores"]
    bwd = negscore.KERNELS["distmult_neg_scores_bwd"]
    before = (fwd.launches, bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        fwd(z, ns, nd, rel, re)
    with pytest.raises(ValueError, match="CUDA"):
        bwd(z, ns, nd, rel, re, cot)
    assert (fwd.launches, bwd.launches) == before


@pytest.mark.parametrize("change,err", [
    (dict(z=torch.ones(4, 3, dtype=torch.float64)), TypeError),
    (dict(ns=torch.zeros(6, dtype=torch.int64)), TypeError),
    (dict(nd=torch.zeros(5, dtype=torch.int32)), ValueError),
    (dict(rel_emb=torch.ones(2, 4)), ValueError),
    (dict(rel=torch.zeros(6, dtype=torch.int16)), TypeError),
])
def test_rejects_bad_inputs(change, err):
    args = dict(z=torch.ones(4, 3), ns=torch.zeros(6, dtype=torch.int32),
                nd=torch.zeros(6, dtype=torch.int32),
                rel=torch.zeros(6, dtype=torch.int32),
                rel_emb=torch.ones(2, 3))
    args.update(change)
    with pytest.raises(err):
        negscore.distmult_neg_scores(**args)
