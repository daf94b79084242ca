"""The port's negative scoring in modes "complex", "transe" and "rotate",
streamed and dual-sorted (the plain torch version, which CPU tensors run,
differentiated by autograd), against the JAX package: the decoders'
unfused ``score_neg_sorted`` on the CPU, and the Pallas
``{mode}_neg_scores`` and ``{mode}_neg_scores_ds`` in interpret mode, as
tests/test_ops.py runs them.

Tolerances. Against the unfused path in float32: values 1e-5, gradients
5e-4 of their max (summation order only). In bf16 the two JAX paths round
differently (the unfused path takes cos and sin of the bf16-rounded phases
and normalises TransE's bf16 rows in bf16; the fused path, which the port
follows, rounds cos and sin of the float32 phases and normalises the
float32 table before rounding): values 2e-2 of their max, gradients 3e-2,
TransE's gradients 8e-2 (JAX's own figure for its dz; the same L1 signs
flip in d(rel_emb)). Against the interpret-mode kernels (bf16 internals) the
figures of tests/test_ops.py:534-628: values 2e-2, gradients 3e-2 for
ComplEx and 4e-2 for the distance modes, TransE's dz 8e-2. The dual-sorted
kernels clip nd to their padded table, so their inputs keep nd < N.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biomedkg_tpu.models import decoders as jax_decoders
from biomedkg_tpu.ops.pallas import negscore as jax_negscore
from biomedkg_tpu_torch.ops import negscore

R = 5
JAX_DECODER = {"complex": jax_decoders.ComplEx,
               "transe": jax_decoders.TransE,
               "rotate": jax_decoders.RotatE}


def _inputs(mode, n, d, m, seed):
    """z (n, d), ns ascending, nd, rel, the relation parameter ((R, d/2)
    phases for rotate) and an upstream gradient, as numpy."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, d)).astype(np.float32)
    ns = np.sort(rng.integers(0, n, m)).astype(np.int32)
    nd = rng.integers(0, n, m).astype(np.int32)
    rel = rng.integers(0, R, m).astype(np.int32)
    width = d // 2 if mode == "rotate" else d
    re = rng.standard_normal((R, width)).astype(np.float32)
    cot = rng.standard_normal(m).astype(np.float32)
    return z, ns, nd, rel, re, cot


def _port(fn, z, ns, nd, rel, re, cot, dtype):
    zt = torch.from_numpy(z).to(dtype).requires_grad_(True)
    ret = torch.from_numpy(re).requires_grad_(True)
    s = fn(zt, torch.from_numpy(ns), torch.from_numpy(nd),
           torch.from_numpy(rel), ret)
    assert s.dtype == torch.float32 and s.shape == ns.shape
    gz, gr = torch.autograd.grad(s, (zt, ret), torch.from_numpy(cot))
    assert gz.dtype == dtype and gr.dtype == torch.float32
    assert gr.shape == re.shape
    return s.detach().numpy(), gz.float().numpy(), gr.numpy()


def _jax(fn, z, ns, nd, rel, re, cot, dtype):
    args = (jnp.asarray(ns), jnp.asarray(nd), jnp.asarray(rel))

    def f(z, re):
        return jnp.sum(fn(z.astype(dtype), *args, re) * cot)

    s = fn(jnp.asarray(z).astype(dtype), *args, jnp.asarray(re))
    gz, gr = jax.grad(f, (0, 1))(jnp.asarray(z), jnp.asarray(re))
    return (np.asarray(s, np.float32), np.asarray(gz, np.float32),
            np.asarray(gr, np.float32))


def _unfused(mode, d):
    """JAX's unfused ``score_neg_sorted`` (γ taken off RotatE's, as the
    port's negscore functions leave it to the decoder)."""
    dec = JAX_DECODER[mode](R, d)
    offset = dec.gamma if mode == "rotate" else 0.0

    def fn(z, ns, nd, rel, re):
        return dec.score_neg_sorted({"rel_emb": re}, z, ns, nd, rel) - offset
    return fn


def _assert_rel(got, want, tols):
    for name, a, b, tol in zip(("scores", "dz", "d(rel)"), got, want, tols):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, (name, err, tol)


@pytest.mark.parametrize("mode", ["complex", "transe", "rotate"])
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_unfused(mode, dual, dtype):
    d = 64
    inputs = _inputs(mode, 100, d, 2048, seed=len(mode) + dual)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    fn = getattr(negscore, negscore.kernel_name(mode, dual))
    got = _port(fn, *inputs, tdt)
    want = _jax(_unfused(mode, d), *inputs, jdt)
    if dtype == "float32":
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        _assert_rel(got, want, (1e-5, 5e-4, 5e-4))
    else:   # TransE's L1 signs flip at bf16 eps in both gradients
        grad_tol = 8e-2 if mode == "transe" else 3e-2
        _assert_rel(got, want, (2e-2, grad_tol, grad_tol))


@pytest.mark.parametrize("mode,dual", [
    ("complex", False), ("transe", False), ("rotate", False),
    ("distmult", True), ("complex", True), ("transe", True),
    ("rotate", True)])
def test_plain_matches_jax_pallas_interpret(mode, dual):
    """The Pallas kernels (bf16 internals) against the port's plain version
    on the same bf16 inputs; the dual-sorted ones on the "sorted2"
    sampler's banded nd over two chunks."""
    d = 256 if mode in ("complex", "rotate") else 128
    m = 2 * jax_negscore.BLOCK if dual else jax_negscore.BLOCK
    z, ns, nd, rel, re, cot = _inputs(mode, 100, d, m, seed=7 + dual)
    if dual:
        band = 100 // (m // negscore.BLOCK)
        starts = np.random.default_rng(3).integers(0, 100, m // 2048)
        nd = ((np.repeat(starts, 2048) + nd % band) % 100).astype(np.int32)
    inputs = (z, ns, nd, rel, re, cot)
    got = _port(getattr(negscore, negscore.kernel_name(mode, dual)), *inputs,
                torch.bfloat16)
    jfn = getattr(jax_negscore, f"{mode}_neg_scores{'_ds' if dual else ''}")
    with pltpu.force_tpu_interpret_mode():
        want = _jax(jfn, *inputs, jnp.bfloat16)
    grad_tol = 3e-2 if mode in ("complex", "distmult") else 4e-2
    _assert_rel(got, want, (2e-2, 8e-2 if mode == "transe" else grad_tol,
                            grad_tol))


def test_rotate_gradient_is_the_phases():
    """RotatE's relation gradient comes back as dθ (R, d/2), equal to the
    chain rule through the [cos θ | sin θ] table."""
    z, ns, nd, rel, th, cot = _inputs("rotate", 50, 16, 300, seed=1)
    _, _, dtheta = _port(negscore.rotate_neg_scores, z, ns, nd, rel, th, cot,
                         torch.float32)
    table = torch.cat([torch.cos(torch.from_numpy(th)),
                       torch.sin(torch.from_numpy(th))], 1)
    table.requires_grad_(True)
    s = negscore.slot_terms(
        "rotate", torch.from_numpy(z[ns]), torch.from_numpy(z[nd]),
        table[torch.from_numpy(rel).long()]).sum(1)
    (dtab,) = torch.autograd.grad(s, (table,), torch.from_numpy(cot))
    c, sn = table.detach()[:, :8], table.detach()[:, 8:]
    want = -sn * dtab[:, :8] + c * dtab[:, 8:]
    assert dtheta.shape == (R, 8)
    np.testing.assert_allclose(dtheta, want.numpy(), rtol=1e-5, atol=1e-5)


def test_rotate_gradient_below_the_distance_clamp():
    """Where a pair's |h∘e^{iθ} − t| is below 1e-6 (the distance's clamp
    at 1e-12), the plain version's gradients follow the reference's Pallas
    backward, ``_distance_bwd``: du = −ds·u / max(|u|, 1e-6), not the zero
    that autograd through the clamp gives. Slot 0's pair 1 has θ = 0 and
    t = h + 2⁻²² there (|u| = 2.4e-7, exact in float32); slot 1 meets its
    tail in every pair that has θ = 0; slot 2 is far from the clamp."""
    rng = np.random.default_rng(3)
    d, half = 8, 4
    th = rng.uniform(-np.pi, np.pi, (R, half)).astype(np.float32)
    th[0, 1] = th[1, :2] = 0.0
    z = rng.uniform(0.25, 0.5, (6, d)).astype(np.float32)
    ns = np.array([0, 2, 4], np.int32)
    nd = np.array([1, 3, 5], np.int32)
    rel = np.array([0, 1, 2], np.int32)
    z[1, [1, half + 1]] = z[0, [1, half + 1]]
    z[1, 1] += np.float32(2.0 ** -22)
    z[3, [0, 1, half, half + 1]] = z[2, [0, 1, half, half + 1]]
    cot = np.array([0.7, -1.3, 0.4], np.float32)
    _, gz, gth = _port(negscore.rotate_neg_scores, z, ns, nd, rel, th, cot,
                       torch.float32)
    r_rows = np.concatenate([np.cos(th), np.sin(th)], 1)[rel]
    dh, dt, dth = (np.asarray(x) for x in jax_negscore._distance_bwd(
        "rotate", jnp.asarray(z[ns]), jnp.asarray(z[nd]),
        jnp.asarray(r_rows), jnp.asarray(cot[:, None])))
    assert abs(dh[0, 1]) > 0.1     # the clamp's pair: not autograd's zero
    np.testing.assert_allclose(gz[ns], dh, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gz[nd], dt, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gth[rel], dth, rtol=1e-5, atol=1e-6)


def test_transe_normalises_the_table_first():
    """TransE's plain version is the L1-normalised table through the
    kernels' arithmetic: z to float32, rows over max(Σ|row|, 1e-12), back
    to z's type."""
    z, ns, nd, rel, re, _ = _inputs("transe", 40, 8, 200, seed=2)
    z[3] = 0.0                                   # the 1e-12 floor
    zt = torch.from_numpy(z).bfloat16()
    got = negscore.transe_neg_scores_plain(
        zt, torch.from_numpy(ns), torch.from_numpy(nd),
        torch.from_numpy(rel), torch.from_numpy(re))
    zf = zt.float().numpy()
    zn = zf / np.maximum(np.abs(zf).sum(1, keepdims=True), 1e-12)
    zn = torch.from_numpy(zn).bfloat16().float().numpy()
    reb = torch.from_numpy(re).bfloat16().float().numpy()
    want = -np.abs(zn[ns] + reb[rel] - zn[nd]).sum(1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_every_kernel_wrapper_refuses_cpu_tensors():
    """The 16 kernel wrappers never compute on the CPU; only the
    dispatchers send CPU tensors to the plain version."""
    assert len(negscore.KERNELS) == 16
    before = {name: k.launches for name, k in negscore.KERNELS.items()}
    for mode in negscore.MODES:
        z, ns, nd, rel, _, cot = (torch.from_numpy(a) for a in
                                  _inputs(mode, 20, 8, 50, seed=0))
        re = torch.ones(R, 8)
        for dual in (False, True):
            name = negscore.kernel_name(mode, dual)
            with pytest.raises(ValueError, match="CUDA"):
                negscore.KERNELS[name](z, ns, nd, rel, re)
            with pytest.raises(ValueError, match="CUDA"):
                negscore.KERNELS[name + "_bwd"](z, ns, nd, rel, re, cot)
    assert {name: k.launches for name, k in
            negscore.KERNELS.items()} == before


@pytest.mark.parametrize("mode,z_shape,rel_shape,match", [
    ("complex", (4, 5), (2, 5), "even d"),
    ("rotate", (4, 5), (2, 2), "even d"),
    ("rotate", (4, 6), (2, 6), "d/2"),       # RotatE takes (R, d/2) phases
    ("transe", (4, 6), (2, 3), "rel_emb"),
])
def test_rejects_bad_shapes(mode, z_shape, rel_shape, match):
    """The dispatchers check the relation parameter's width; the wrappers
    (which take the (R, d) table) refuse an odd d for the paired modes
    before anything else."""
    idx = torch.zeros(6, dtype=torch.int32)
    for dual in (False, True):
        name = negscore.kernel_name(mode, dual)
        with pytest.raises(ValueError, match=match):
            getattr(negscore, name)(torch.ones(z_shape), idx, idx, idx,
                                    torch.ones(rel_shape))
        if z_shape[1] % 2:
            with pytest.raises(ValueError, match="even d"):
                negscore.KERNELS[name](torch.ones(z_shape), idx, idx, idx,
                                       torch.ones(2, z_shape[1]))
