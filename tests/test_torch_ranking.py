"""The port's filtered ranking (biomedkg_tpu_torch/eval/ranking.py) against
the JAX package's (biomedkg_tpu/eval/ranking.py) on the CPU.

The same z and decoder weights (JAX's init, carried across by
interop/jax_params.py) go through both: per direction the ranks must be
equal, and MRR, mean rank and Hits@K within 1e-6, for DistMult, ComplEx,
TransE and RotatE. The host arrays (the filter and the flat pair table) must
be byte-identical. Also, as tests/test_ranking.py holds JAX's: ranks equal
to a float64 brute force, the floor at rank 1 under an injected skew
between the two passes, MRR 1 for a perfect model; and the paths that must
not move a rank: a hub key's pairs crossing several pair tiles (the tile
narrowed alike in both packages), the per-chunk fallback, and the chunk
cap of the distance decoders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from biomedkg_tpu.eval import ranking as jax_ranking
from biomedkg_tpu.models import decoders as jax_decoders
from biomedkg_tpu_torch.eval import ranking
from biomedkg_tpu_torch.interop.jax_params import tensors_from_tree
from biomedkg_tpu_torch.models import decoders
from biomedkg_tpu_torch.parallel.mesh import make_mesh

DECODERS = ["DistMult", "ComplEx", "TransE", "RotatE"]
N, R, D = 64, 4, 16
METRIC_TOL = 1e-6


def _decoders(name, seed=0):
    jdec = getattr(jax_decoders, name)(num_relations=R, hidden_channels=D)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(seed)))
    dec = getattr(decoders, name)(num_relations=R, hidden_channels=D)
    with torch.no_grad():
        for n, t in tensors_from_tree(dec, params).items():
            getattr(dec, n).copy_(t)
    return jdec, params, dec


def _graph(seed=0, n=N, count=900, num_test=150):
    rng = np.random.default_rng(seed)
    known = np.unique(rng.integers(0, [n, R, n], size=(count, 3)), axis=0)
    test = known[rng.permutation(len(known))[:num_test]]
    z = rng.standard_normal((n, D)).astype(np.float32)
    return z, test, known


def _filters(test, known, n):
    num_keys = int(known[:, 1].max()) + 1
    return num_keys, {
        "tail": (test[:, 0], test[:, 1], test[:, 2],
                 jax_ranking._build_filter(known, n, num_keys)),
        "head": (test[:, 2], test[:, 1], test[:, 0],
                 jax_ranking._build_filter(known[:, [2, 1, 0]], n,
                                           num_keys))}


def _jax_ranks(jdec, params, z, test, known, chunk):
    num_keys, sides = _filters(test, known, z.shape[0])
    fns = {"tail": (jdec.score_all_tails,
                    lambda p, zz, h, t, r: jdec.score(p, zz, h, t, r)),
           "head": (jdec.score_all_heads,
                    lambda p, zz, t, h, r: jdec.score(p, zz, h, t, r))}
    return {side: jax_ranking._direction_ranks(
        *fns[side], params, jnp.asarray(z), *sides[side], chunk, num_keys)
        for side in sides}


def _port_ranks(dec, z, test, known, chunk, timings=None):
    num_keys, sides = _filters(test, known, z.shape[0])
    fns = {"tail": (dec.score_all_tails,
                    lambda zz, h, t, r: dec.score(zz, h, t, r)),
           "head": (dec.score_all_heads,
                    lambda zz, t, h, r: dec.score(zz, h, t, r))}
    zt = torch.from_numpy(z)
    clock = ranking.Clock(timings, zt.device)
    chunk = min(chunk, ranking._chunk_cap(dec, z.shape[0], z.shape[1]))
    with torch.inference_mode():
        return {side: ranking._direction_ranks(
            *fns[side], zt, *sides[side], chunk, num_keys, clock, side)
            for side in sides}


def _assert_metrics_close(got, want):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= METRIC_TOL * max(1.0, abs(want[k])), \
            (k, got[k], want[k])


@pytest.mark.parametrize("name", DECODERS)
def test_ranks_and_metrics_match_jax(name):
    jdec, params, dec = _decoders(name)
    z, test, known = _graph()
    want = _jax_ranks(jdec, params, z, test, known, chunk=32)
    got = _port_ranks(dec, z, test, known, chunk=32)
    for side in want:
        np.testing.assert_array_equal(got[side], np.asarray(want[side]),
                                      err_msg=side)
    assert got["tail"].dtype == np.float32
    _assert_metrics_close(
        ranking.filtered_ranking_metrics(dec, z, test, known, chunk=32),
        jax_ranking.filtered_ranking_metrics(jdec, params, z, test, known,
                                             chunk=32))


def _brute_force(dec, z, test, known, side):
    """Float64 filtered ranks: every candidate scored on its own, the
    known triples other than the test triple itself left out."""
    dec64 = type(dec)(num_relations=R, hidden_channels=D).double()
    with torch.no_grad():
        dec64.rel_emb.copy_(dec.rel_emb.double())
    z64 = torch.from_numpy(z).double()
    known_set = set(map(tuple, known.tolist()))
    n = z.shape[0]
    cand = torch.arange(n)
    ranks = []
    for h, r, t in test.tolist():
        target = t if side == "tail" else h
        heads = torch.full((n,), h) if side == "tail" else cand
        tails = cand if side == "tail" else torch.full((n,), t)
        with torch.no_grad():
            s = dec64.score(z64, heads, tails, torch.full((n,), r)).numpy()
        trips = [(h, r, c) if side == "tail" else (c, r, t)
                 for c in range(n)]
        drop = np.array([c != target and trip in known_set
                         for c, trip in enumerate(trips)])
        s = np.where(drop, -np.inf, s)
        ranks.append(1 + np.sum(s > s[target])
                     + 0.5 * (np.sum(s == s[target]) - 1))
    return np.array(ranks)


@pytest.mark.parametrize("name", DECODERS)
def test_ranks_match_float64_brute_force(name):
    _, _, dec = _decoders(name, seed=1)
    z, test, known = _graph(seed=1, n=24, count=120, num_test=16)
    got = _port_ranks(dec, z, test, known, chunk=5)
    for side in ("tail", "head"):
        np.testing.assert_array_equal(
            got[side], _brute_force(dec, z, test, known, side),
            err_msg=side)


class _SkewedDecoder:
    """The reference's regression stub (tests/test_ranking.py:79-119): its
    candidate pass scores everything 1e-3 below its elementwise pass.
    ``flip`` reverses the elementwise pass's order too, so the filtered
    pairs scan 2 counts as higher are those scan 1 counted as lower, and
    ranks fall below 1 until the floor."""

    def __init__(self, n, r, flip=False):
        self.n, self.r = n, r
        self.sign = -1.0 if flip else 1.0
        self.base = torch.linspace(0.0, 1.0, n * r * n)

    def _score(self, h, t, r, skew):
        return self.base[(h * self.r + r) * self.n + t] - skew

    def score(self, z, h, t, r):
        return self.sign * self._score(h, t, r, 0.0)

    def score_all_tails(self, z, h, r):
        cand = torch.arange(self.n)
        return self._score(h[:, None], cand[None, :], r[:, None], 1e-3)

    def score_all_heads(self, z, t, r):
        cand = torch.arange(self.n)
        return self._score(cand[None, :], t[:, None], r[:, None], 1e-3)


@pytest.mark.parametrize("flip", [False, True])
def test_rank_floor_survives_cross_path_score_skew(flip):
    n, r = 12, 2
    rng = np.random.default_rng(0)
    known = np.unique(rng.integers(0, [n, r, n], size=(80, 3)), axis=0)
    test = known[:12]
    dec = _SkewedDecoder(n, r, flip)
    z = torch.zeros(n, 4)
    num_keys, sides = _filters(test, known, n)
    clock = ranking.Clock(None, z.device)
    raw = ranking._ranks_before_floor(
        dec.score_all_tails, lambda zz, h, t, rr: dec.score(zz, h, t, rr),
        z, *sides["tail"], 4, num_keys, clock, "tail")
    # a uniform skew cancels (each pass compares like with like); a
    # reversed one pushes ranks below 1, which the floor must absorb
    assert (raw.min() < 1.0) == flip
    metrics = ranking.filtered_ranking_metrics(dec, z, test, known, chunk=4)
    assert np.isfinite(metrics["mrr"])
    assert 0.0 < metrics["mrr"] <= 1.0
    assert metrics["mean_rank"] >= 1.0


def test_perfect_model_gets_mrr_one():
    n = 8
    dec = decoders.DistMult(num_relations=2, hidden_channels=n)
    with torch.no_grad():
        dec.rel_emb.fill_(1.0)
    z = np.eye(n, dtype=np.float32)
    test = np.array([[i, 0, i] for i in range(4)])
    metrics = ranking.filtered_ranking_metrics(dec, z, test, test, chunk=4)
    assert metrics["hits@1"] == 1.0
    assert metrics["mrr"] == 1.0


def _hub_graph():
    """One (head 0, rel 0) key with 50 known tails, 12 of them tested."""
    z, test, known = _graph(seed=2)
    hub = np.stack([np.zeros(50, np.int64), np.zeros(50, np.int64),
                    np.arange(1, 51)], axis=1)
    known = np.unique(np.concatenate([known, hub]), axis=0)
    test = np.concatenate([hub[::4], test[:40]])
    return z, test, known


def test_hub_key_across_pair_tiles_matches_jax(monkeypatch):
    jdec, params, dec = _decoders("DistMult", seed=2)
    z, test, known = _hub_graph()
    wide = _port_ranks(dec, z, test, known, chunk=16)
    monkeypatch.setattr(ranking, "_PAIR_TILE", 32)
    monkeypatch.setattr(jax_ranking, "_PAIR_TILE", 32)
    timings = {}
    got = _port_ranks(dec, z, test, known, chunk=16, timings=timings)
    want = _jax_ranks(jdec, params, z, test, known, chunk=16)
    # the hub's rows alone hold 12 × 50 pairs: about 19 tiles
    assert timings["tail_pairs"] > 600 and timings["tail_path"] == "scanned"
    for side in want:
        np.testing.assert_array_equal(got[side], np.asarray(want[side]))
        np.testing.assert_array_equal(got[side], wide[side])


def test_per_chunk_fallback_gives_the_scanned_ranks(monkeypatch):
    _, _, dec = _decoders("ComplEx", seed=3)
    z, test, known = _hub_graph()
    scanned = _port_ranks(dec, z, test, known, chunk=16)
    monkeypatch.setattr(ranking, "_PAIR_TABLE_BYTES", 0)
    timings = {}
    fallback = _port_ranks(dec, z, test, known, chunk=16, timings=timings)
    assert timings["tail_path"] == timings["head_path"] == "fallback"
    assert "tail_fallback_s" in timings and "tail_scan1_s" not in timings
    for side in scanned:
        np.testing.assert_array_equal(fallback[side], scanned[side])


@pytest.mark.parametrize("name", ["TransE", "RotatE"])
def test_distance_chunk_cap_moves_no_rank(monkeypatch, name):
    """A memory budget that fits 3 rows of TransE's (rows, N, d)
    intermediates caps its chunk at 3 (RotatE's at 4); no rank moves."""
    _, _, dec = _decoders(name, seed=4)
    z, test, known = _graph(seed=4)
    free = ranking.filtered_ranking_metrics(dec, z, test, known, chunk=32)
    plain = _port_ranks(dec, z, test, known, chunk=32)
    monkeypatch.setattr(ranking, "_CANDIDATE_BYTES", 3 * 2 * N * D * 4)
    timings = {}
    capped = ranking.filtered_ranking_metrics(dec, z, test, known, chunk=32,
                                              timings=timings)
    assert timings["tail_chunk"] == {"TransE": 3, "RotatE": 4}[name]
    assert capped == free
    got = _port_ranks(dec, z, test, known, chunk=32)
    for side in plain:
        np.testing.assert_array_equal(got[side], plain[side])


def test_host_arrays_byte_identical():
    rng = np.random.default_rng(5)
    z, test, known = _graph(seed=5)
    num_keys = int(known[:, 1].max()) + 1
    for trip in (known, known[:, [2, 1, 0]]):
        a = ranking._build_filter(trip, N, num_keys)
        b = jax_ranking._build_filter(trip, N, num_keys)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    filt = jax_ranking._build_filter(known, N, num_keys)
    chunk, num = 16, len(test)
    num_pad = -(-num // chunk) * chunk
    anchors = np.concatenate([test[:, 0], np.zeros(num_pad - num, np.int64)])
    rels = np.concatenate([test[:, 1], np.zeros(num_pad - num, np.int64)])
    valid = np.arange(num_pad) < num
    rels[rng.random(num_pad) < 0.1] = 0
    got = ranking._assemble_filter_pairs(anchors, rels, valid, chunk,
                                         num_pad // chunk, filt, num_keys)
    want = jax_ranking._assemble_filter_pairs(
        anchors, rels, valid, chunk, num_pad // chunk, filt, num_keys)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_sharded_ranking_and_tf32_refused():
    _, _, dec = _decoders("DistMult")
    z, test, known = _graph()
    # a one-rank mesh ranks as no mesh (tests/test_torch_parallel_typed_rank
    # holds four gloo ranks against the unsharded ranks)
    assert ranking.filtered_ranking_metrics(
        dec, z, test, known, mesh=make_mesh()) == \
        ranking.filtered_ranking_metrics(dec, z, test, known)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            ranking.filtered_ranking_metrics(dec, z, test, known)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
