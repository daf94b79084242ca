"""The redesigned forward of the port's negscore kernels (ops/negscore.py:
"run", for the streamed and the dual-sorted family), on the CPU: which
design a call takes, which features a lane takes, and the plain version
of the kernel's order of sums (``lane_scores_plain``) against an
independent float32 emulation, the port's plain version and
the JAX package's forward kernels (``_fwd_call`` and ``_fwd_call_ds`` in
interpret mode, as tests/test_ops.py runs them).

Tolerances: float32 sums that differ only in order, each slot within 1e-5
of the sum of its terms' magnitudes; bf16 2e-2 of the max, as
tests/test_torch_negscore.py holds the plain version against JAX. Against
the JAX kernels the lane order takes the JAX kernels' own per-unit terms
(the bilinear modes round h∘t to bf16 before their projection), so that
the comparison is of the sums alone; RotatE's inputs lie on a lattice where
every float32 step of the distance is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biomedkg_tpu.ops.pallas import negscore as jax_negscore
from biomedkg_tpu_torch.ops import negscore

R = 5
SUM_RTOL = 1e-5


def _inputs(mode, n, d, m, seed, lo=0, hi=None, sort_ns=True):
    """z (n, d), ns, nd, rel and the kernels' (R, d) float32 table ([cos |
    sin] of random phases for rotate), as numpy."""
    rng = np.random.default_rng(seed)
    hi = n if hi is None else hi
    z = rng.standard_normal((n, d)).astype(np.float32)
    ns = rng.integers(lo, hi, m).astype(np.int32)
    if sort_ns:
        ns = np.sort(ns)
    nd = rng.integers(lo, hi, m).astype(np.int32)
    rel = rng.integers(min(lo, 0), R + max(hi - n, 0), m).astype(np.int32)
    if mode == "rotate":
        th = rng.uniform(-np.pi, np.pi, (R, d // 2)).astype(np.float32)
        table = np.concatenate([np.cos(th), np.sin(th)], 1)
    else:
        table = rng.standard_normal((R, d)).astype(np.float32)
    return z, ns, nd, rel, table


def _terms(mode, z, ns, nd, rel, table):
    n, r = z.shape[0], table.shape[0]
    return negscore.slot_terms(mode, z[ns.long().clamp(0, n - 1)].float(),
                               z[nd.long().clamp(0, n - 1)].float(),
                               table[rel.long().clamp(0, r - 1)])


def _assert_sums(got, want, magnitude, what):
    got, want, magnitude = (np.asarray(x, np.float64)
                            for x in (got, want, magnitude))
    assert got.shape == want.shape, what
    ratio = np.abs(got - want) / np.maximum(magnitude, 1e-30)
    assert ratio.max() <= SUM_RTOL, (what, ratio.max())


@pytest.mark.parametrize("mode", negscore.MODES)
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_design_is_run_for_every_call(mode, dual, dtype):
    widths = (2, 6, 100, 256) if mode in negscore.PAIRED else (1, 7, 100, 256)
    for d in widths:
        assert negscore.negscore_fwd_design(mode, dual, dtype, d) == "run"
    assert negscore.FWD_DESIGNS == ("first", "run")


@pytest.mark.parametrize("mode,dtype,d,match", [
    ("complex", torch.float32, 7, "even d"),
    ("rotate", torch.bfloat16, 5, "even d"),
    ("distmult", torch.float16, 8, "no kernel"),
    ("bilinear", torch.float32, 8, "no kernel"),
])
@pytest.mark.parametrize("dual", [False, True])
def test_fwd_design_refuses_what_no_kernel_takes(mode, dtype, d, match,
                                                 dual):
    with pytest.raises(ValueError, match=match):
        negscore.negscore_fwd_design(mode, dual, dtype, d)


@pytest.mark.parametrize("units,features", [
    (256, 8), (128, 4), (512, 8), (384, 8), (100, 1), (64, 1), (7, 1),
    (3, 1), (136, 4)])
def test_lane_features(units, features):
    """8 features a lane where the (half-)width leaves the 32 lanes a pack
    each, else 4, else 1: d = 256 gives every lane 16 bytes of a bf16 row
    in each mode (8 features, or 4 of each half)."""
    assert negscore.fwd_lane_features(units) == features


def _emulated(terms: np.ndarray) -> np.ndarray:
    """The kernels' order in float32 numpy, written out lane by lane."""
    m, units = terms.shape
    v = negscore.fwd_lane_features(units)
    packs = units // v
    out = np.zeros(m, np.float32)
    for p0 in range(0, packs, 32):
        lanes = np.zeros((m, 32), np.float32)
        for lane in range(32):
            p = p0 + lane
            if p < packs:
                acc = np.zeros(m, np.float32)
                for k in range(v):
                    acc = (acc + terms[:, p * v + k]).astype(np.float32)
                lanes[:, lane] = acc
        for width in (16, 8, 4, 2, 1):
            lanes = (lanes[:, :width] + lanes[:, width:2 * width]).astype(
                np.float32)
        out = lanes[:, 0] if p0 == 0 else (out + lanes[:, 0]).astype(
            np.float32)
    return out


@pytest.mark.parametrize("units", [7, 100, 128, 256, 320])
def test_lane_order_is_the_kernels_order(units):
    """``lane_scores_plain`` sums exactly as the lanes, the transpose
    reduction and the passes do (one, two and four passes)."""
    rng = np.random.default_rng(units)
    terms = (rng.standard_normal((64, units))
             * 10.0 ** rng.integers(-3, 4, (64, units))).astype(np.float32)
    z = torch.zeros(1, units)
    ids = torch.zeros(64, dtype=torch.int32)
    got = negscore.lane_scores_plain("distmult", z, ids, ids, ids,
                                     torch.zeros(1, units),
                                     terms=torch.from_numpy(terms))
    np.testing.assert_array_equal(got.numpy(), _emulated(terms))


@pytest.mark.parametrize("mode", negscore.MODES)
@pytest.mark.parametrize("d", [6, 100, 256])
@pytest.mark.parametrize("case", ["clipped, ns sorted", "clipped, ns any"])
def test_lane_order_equals_the_plain_version(mode, d, case):
    """The kernels' order of sums against ``plain_scores``: float32 within
    1e-5 of Σ|terms| per slot, bf16 within 2e-2 of the max."""
    d = d + 1 if mode not in negscore.PAIRED and d == 6 else d
    n, m = 37, 3000
    z, ns, nd, rel, table = (torch.from_numpy(a) for a in _inputs(
        mode, n, d, m, seed=d + len(mode) + len(case), lo=-3, hi=n + 3,
        sort_ns=case.endswith("sorted")))
    rel_emb = (torch.atan2(table[:, d // 2:], table[:, :d // 2])
               if mode == "rotate" else table)
    for dtype in (torch.float32, torch.bfloat16):
        zt = z.to(dtype)
        re = negscore.relation_table(mode, rel_emb, dtype)
        got = negscore.lane_scores_plain(mode, zt, ns, nd, rel, re)
        want = negscore.plain_scores(mode, zt, ns, nd, rel, rel_emb)
        assert got.dtype == torch.float32 and got.shape == (m,)
        if dtype == torch.float32:
            mag = _terms(mode, zt, ns, nd, rel, re).abs().sum(1)
            _assert_sums(got, want, mag, f"{mode} d = {d} {case}")
        else:
            assert float((got - want).abs().max()) <= \
                2e-2 * float(want.abs().max())


def _lattice_inputs(n, d, m, seed):
    """RotatE inputs on which the distance's float32 steps are exact:
    coordinates in {0, ±1, ±2, ±4}, phases multiples of 90 degrees."""
    rng = np.random.default_rng(seed)
    z = rng.choice(np.float32([0, 1, -1, 2, -2, 4, -4]), (n, d))
    ns = np.sort(rng.integers(0, n, m)).astype(np.int32)
    nd = rng.integers(0, n, m).astype(np.int32)
    rel = rng.integers(0, R, m).astype(np.int32)
    quarter = rng.integers(0, 4, (R, d // 2))
    cos = np.float32([1, 0, -1, 0])[quarter]
    sin = np.float32([0, 1, 0, -1])[quarter]
    return z, ns, nd, rel, np.concatenate([cos, sin], 1)


def _jax_unit_terms(mode, z, ns, nd, rel, table):
    """The JAX forward kernels' per-unit terms on the bf16 rows and table:
    the bilinear modes' h∘t combination in bf16 times the table row (exact
    in float32), the distance modes' float32 terms."""
    zb = jnp.asarray(z).astype(jnp.bfloat16)
    tb = jnp.asarray(table).astype(jnp.bfloat16).astype(jnp.float32)
    h, t, r = zb[ns], zb[nd], tb[rel]
    if mode in jax_negscore.BILINEAR_MODES:
        g = jax_negscore._combine_fwd(mode, h, t).astype(jnp.float32)
        if mode == "complex":
            half = g.shape[1] // 2
            terms = g[:, :half] * r[:, :half] + g[:, half:] * r[:, half:]
        else:
            terms = g * r
    else:
        terms = _terms(mode, torch.from_numpy(np.array(
            zb.astype(jnp.float32))), torch.from_numpy(ns),
            torch.from_numpy(nd), torch.from_numpy(rel),
            torch.from_numpy(np.array(tb))).numpy()
    return torch.from_numpy(np.array(terms, np.float32))


@pytest.mark.parametrize("mode", negscore.MODES)
@pytest.mark.parametrize("dual", [False, True])
def test_lane_order_equals_the_jax_kernels(mode, dual):
    """The JAX forward kernels in interpret mode against the kernels'
    order of sums over the same per-unit terms, float32."""
    n, d, m = 100, 128, jax_negscore.BLOCK
    if mode == "rotate":
        z, ns, nd, rel, table = _lattice_inputs(n, d, m, seed=dual)
    else:
        z, ns, nd, rel, table = _inputs(mode, n, d, m, seed=5 + dual)
    args = [jnp.asarray(a) for a in (z, ns, nd, rel, table)]
    with pltpu.force_tpu_interpret_mode():
        if dual:
            want = jax_negscore._fwd_call_ds(mode, *args)
        else:
            t_rows = jnp.take(args[0], args[2], axis=0).astype(jnp.bfloat16)
            want = jax_negscore._fwd_call(mode, args[0], args[1], t_rows,
                                          args[3], args[4])
    terms = _jax_unit_terms(mode, z, ns, nd, rel, table)
    tz, tns, tnd, trel, ttab = (torch.from_numpy(np.asarray(a))
                                for a in (z, ns, nd, rel, table))
    got = negscore.lane_scores_plain(mode, tz, tns, tnd, trel, ttab,
                                     terms=terms)
    _assert_sums(got, np.asarray(want), terms.abs().sum(1), mode)
    assert np.abs(np.asarray(want)).max() > 0


@pytest.mark.parametrize("dual", [False, True])
def test_forward_wrappers_refuse_cpu_tensors(dual):
    """The forward kernels run on the card only; on the CPU the plain
    version is called by name, never by the wrapper, and no launch is
    counted."""
    z = torch.zeros(4, 8)
    ids = torch.zeros(6, dtype=torch.int32)
    for mode in negscore.MODES:
        fwd = negscore.KERNELS[negscore.kernel_name(mode, dual)]
        fwd.reset()
        with pytest.raises(ValueError, match="CUDA"):
            fwd(z, ids, ids, ids, torch.zeros(2, 8))
        assert fwd.launches == 0
        assert fwd.by_design == dict.fromkeys(negscore.FWD_DESIGNS, 0)
