"""The owner design of the port's negscore backward (ops/negscore.py), on
the CPU: which design a call takes, the plain version of its bucket build,
and its per-bucket sums in the owner's order, against numpy, the port's
plain backward and the JAX package's backward kernels (``_bwd_call`` and
``_bwd_call_ds`` in interpret mode, as tests/test_ops.py runs them).

Tolerances: every sum is held to 1e-5 of the sum of its terms' magnitudes,
element by element (float32 sums that differ only in order). Against the
JAX kernels the owner sums take the JAX kernels' own per-slot terms
(``_chunk_grads``' pieces on the bf16 rows, as the kernels round them), so
that the comparison is of the sums alone; RotatE's inputs lie on a lattice
(rotations by multiples of 90 degrees, coordinates in {0, ±1, ±2, ±4}) where
every float32 operation of ``_distance_bwd`` is exact or a single rounding,
so a fused multiply-add inside the kernel cannot move a term by a bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biomedkg_tpu.ops.pallas import negscore as jax_negscore
from biomedkg_tpu_torch.ops import negscore

R = 5
SUM_RTOL = 1e-5


def _assert_sums(got, want, magnitude, what):
    got, want, magnitude = (np.asarray(x, np.float64)
                            for x in (got, want, magnitude))
    assert got.shape == want.shape, what
    ratio = np.abs(got - want) / np.maximum(magnitude, 1e-30)
    assert ratio.max() <= SUM_RTOL, (what, ratio.max())


@pytest.mark.parametrize("mode", negscore.MODES)
@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_design_is_owner_for_every_call_the_kernels_take(mode, dual, dtype):
    widths = (2, 6, 100, 256) if mode in negscore.PAIRED else (1, 7, 100, 256)
    for d in widths:
        assert negscore.negscore_design(mode, dual, dtype, d) == "owner"
    assert negscore.DESIGNS == ("first", "owner")


@pytest.mark.parametrize("mode,dtype,d,match", [
    ("complex", torch.float32, 7, "even d"),
    ("rotate", torch.bfloat16, 5, "even d"),
    ("distmult", torch.float16, 8, "no kernel"),
    ("bilinear", torch.float32, 8, "no kernel"),
])
def test_design_refuses_what_no_kernel_takes(mode, dtype, d, match):
    with pytest.raises(ValueError, match=match):
        negscore.negscore_design(mode, False, dtype, d)


def _numpy_buckets(ns, nd, n):
    offsets, order = [], []
    for ids in (ns, nd):
        keys = np.clip(ids.astype(np.int64), 0, n - 1)
        counts = np.bincount(keys, minlength=n)
        offsets.append(np.concatenate([[0], np.cumsum(counts)]))
        order.append(np.argsort(keys, kind="stable"))
    return np.stack(offsets), np.stack(order)


@pytest.mark.parametrize("m,n,lo,hi,sort_ns", [
    (5000, 37, -3, 40, True),          # ids out of range, clipped
    (5000, 37, -3, 40, False),         # ns in any order
    (300, 1000, 0, 1000, True),        # most buckets empty
    (300, 1000, 0, 1000, False),
    (1, 1, -5, 5, True),
    (2048, 3, 0, 3, False),            # buckets far above a warp
])
def test_plain_buckets_match_numpy(m, n, lo, hi, sort_ns):
    rng = np.random.default_rng(m + n)
    ns = rng.integers(lo, hi, m).astype(np.int32)
    if sort_ns:
        ns = np.sort(ns)
    nd = rng.integers(lo, hi, m).astype(np.int32)
    offsets, order = negscore.buckets_plain(torch.from_numpy(ns),
                                            torch.from_numpy(nd), n)
    want_off, want_ord = _numpy_buckets(ns, nd, n)
    assert offsets.dtype == torch.int32 and order.dtype == torch.int32
    assert offsets.shape == (2, n + 1) and order.shape == (2, m)
    np.testing.assert_array_equal(offsets.numpy(), want_off)
    np.testing.assert_array_equal(order.numpy(), want_ord)


def _inputs(mode, n, d, m, seed, lo=0, hi=None, sort_ns=True):
    """z (n, d), ns, nd, rel, the kernels' (R, d) float32 table ([cos |
    sin] of random phases for rotate) and ds, as numpy."""
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
    ds = rng.standard_normal(m).astype(np.float32)
    return z, ns, nd, rel, table, ds


def _magnitudes(mode, z, ns, nd, rel, table, ds, terms):
    """Σ|terms| per element of dz and the relation gradient."""
    return negscore.owner_grads_plain(
        mode, z, ns, nd, rel, table, ds, terms=[t.abs() for t in terms])


def _product_bounds(mode, h, t, r, g):
    """Per slot, bounds on the magnitudes of the products each unit
    gradient sums (|dh|, |dt|, |relation-row gradient|): two ways of
    forming the same gradient differ by rounding relative to these, not
    to the gradient, which may cancel."""
    h, t, r, g = h.abs(), t.abs(), r.abs(), g.abs()[:, None]
    if mode == "distmult":
        return g * r * t, g * r * h, g * h * t
    if mode == "transe":
        return (g.expand_as(h),) * 3
    half = h.shape[1] // 2

    def pair_sum(x):
        s = x[:, :half] + x[:, half:]
        return torch.cat([s, s], 1)
    if mode == "complex":
        return (g * pair_sum(r) * pair_sum(t), g * pair_sum(r) * pair_sum(h),
                g * pair_sum(h) * pair_sum(t))
    rotated = pair_sum(h) * pair_sum(r)
    return (g * pair_sum(r), g.expand_as(h),
            (g * rotated)[:, :half])


@pytest.mark.parametrize("mode", negscore.MODES)
@pytest.mark.parametrize("case", ["clipped, ns sorted", "clipped, ns any",
                                  "empty buckets"])
def test_owner_sums_equal_the_plain_backward(mode, case):
    """Per-bucket sums of ``unit_grads`` in the owner's order equal the
    plain version's dz and relation gradient (autograd through
    ``plain_scores``), float32."""
    n, d, m = (37, 12, 3000) if case != "empty buckets" else (400, 12, 300)
    lo, hi = (-3, n + 3) if case.startswith("clipped") else (0, n)
    z, ns, nd, rel, table, ds = (torch.from_numpy(a) for a in _inputs(
        mode, n, d, m, seed=len(mode) + len(case), lo=lo, hi=hi,
        sort_ns=case != "clipped, ns any"))
    if mode == "rotate":                       # the phases behind the table
        rel_emb = torch.atan2(table[:, d // 2:], table[:, :d // 2])
    else:
        rel_emb = table
    zp = z.clone().requires_grad_(True)
    rp = rel_emb.clone().requires_grad_(True)
    s = negscore.plain_scores(mode, zp, ns, nd, rel, rp)
    want_dz, want_dr = torch.autograd.grad(s, (zp, rp), ds)
    table = negscore.relation_table(mode, rel_emb, torch.float32)
    got_dz, got_dr = negscore.owner_grads_plain(mode, z, ns, nd, rel, table,
                                                ds)
    rows = torch.clamp(rel.long(), 0, R - 1)
    bounds = _product_bounds(
        mode, z[ns.long().clamp(0, n - 1)], z[nd.long().clamp(0, n - 1)],
        table[rows], ds)
    mag_dz, mag_dr = negscore.owner_grads_plain(mode, z, ns, nd, rel, table,
                                                ds, terms=bounds)
    _assert_sums(got_dz, want_dz, mag_dz, f"{mode} {case} dz")
    _assert_sums(got_dr, want_dr, mag_dr, f"{mode} {case} d(rel)")
    if case == "empty buckets":     # ids in no slot keep a zero row
        used = set(ns.tolist()) | set(nd.tolist())
        empty = [i for i in range(n) if i not in used]
        assert empty and not got_dz[empty].any()


def _lattice_inputs(n, d, m, seed):
    """RotatE inputs on which _distance_bwd's float32 steps are exact or
    single roundings: coordinates in {0, ±1, ±2, ±4}, phases multiples of
    90 degrees, ds small integers."""
    rng = np.random.default_rng(seed)
    z = rng.choice(np.float32([0, 1, -1, 2, -2, 4, -4]), (n, d))
    ns = np.sort(rng.integers(0, n, m)).astype(np.int32)
    nd = rng.integers(0, n, m).astype(np.int32)
    rel = rng.integers(0, R, m).astype(np.int32)
    quarter = rng.integers(0, 4, (R, d // 2))
    cos = np.float32([1, 0, -1, 0])[quarter]
    sin = np.float32([0, 1, 0, -1])[quarter]
    table = np.concatenate([cos, sin], 1)
    ds = rng.integers(-3, 4, m).astype(np.float32)
    return z, ns, nd, rel, table, ds


def _jax_slot_terms(mode, z, ns, nd, rel, table, ds):
    """The JAX kernels' per-slot (dh, dt, relation-row gradient): the
    pieces of ``_chunk_grads`` on the bf16 rows, rounded to bf16 as the
    kernels round them before their one-hot sums."""
    zb = jnp.asarray(z).astype(jnp.bfloat16)
    h, t = zb[ns], zb[nd]
    r = jnp.asarray(table).astype(jnp.bfloat16)[rel]
    g = jnp.asarray(ds).astype(jnp.bfloat16)[:, None]
    if mode in jax_negscore.BILINEAR_MODES:
        terms = (g * jax_negscore._combine_dh(mode, r, t),
                 g * jax_negscore._combine_dt(mode, r, h),
                 g * jax_negscore._combine_fwd(mode, h, t))
    else:
        terms = tuple(x.astype(jnp.bfloat16) for x in
                      jax_negscore._distance_bwd(mode, h, t, r, g))
    return [torch.from_numpy(np.array(x, np.float32)) for x in terms]


@pytest.mark.parametrize("mode", negscore.MODES)
@pytest.mark.parametrize("dual", [False, True])
def test_owner_sums_equal_the_jax_kernels(mode, dual):
    """The JAX backward kernels in interpret mode (the streamed one's dt
    scattered as its custom VJP does) against the owner's per-bucket sums
    of the same per-slot terms, float32."""
    n, d, m = 100, 128, jax_negscore.BLOCK
    if mode == "rotate":
        z, ns, nd, rel, table, ds = _lattice_inputs(n, d, m, seed=dual)
    else:
        z, ns, nd, rel, table, ds = _inputs(mode, n, d, m, seed=3 + dual)
    args = [jnp.asarray(a) for a in (z, ns, nd, rel, table, ds)]
    with pltpu.force_tpu_interpret_mode():
        if dual:
            dz, dre = jax_negscore._bwd_call_ds(mode, *args)
        else:
            t_rows = jnp.take(args[0], args[2], axis=0).astype(jnp.bfloat16)
            dz_src, dre, dt = jax_negscore._bwd_call(
                mode, args[0], args[1], t_rows, args[3], args[4], args[5])
            dz = dz_src + jax.ops.segment_sum(dt.astype(jnp.float32),
                                              args[2], num_segments=n)
    terms = _jax_slot_terms(mode, z, ns, nd, rel, table, ds)
    tz, tns, tnd, trel, ttab, tds = (torch.from_numpy(np.asarray(a))
                                     for a in (z, ns, nd, rel, table, ds))
    got_dz, got_dr = negscore.owner_grads_plain(mode, tz, tns, tnd, trel,
                                                ttab, tds, terms=terms)
    mag_dz, mag_dr = _magnitudes(mode, tz, tns, tnd, trel, ttab, tds, terms)
    _assert_sums(got_dz, np.asarray(dz), mag_dz, f"{mode} dz")
    _assert_sums(got_dr, np.asarray(dre), mag_dr, f"{mode} d(rel)")
    assert np.abs(np.asarray(dre)).max() > 0


def test_bucket_wrapper_refuses_cpu_tensors():
    """The bucket build runs on the card only; on the CPU the plain
    version is called by name, never by the wrapper."""
    before = negscore.BUCKETS.launches
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        negscore.BUCKETS(ids, ids, 4)
    assert negscore.BUCKETS.launches == before
    backward = negscore.KERNELS["distmult_neg_scores_bwd"]
    assert backward.by_design == dict.fromkeys(negscore.DESIGNS, 0)
