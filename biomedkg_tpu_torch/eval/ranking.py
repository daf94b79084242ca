"""Filtered-ranking evaluation: MRR / Hits@K over every candidate entity
(counterpart of biomedkg_tpu/eval/ranking.py).

For each test triple (h, r, t) every candidate tail t' (and head h') is
scored, candidates forming another known true triple are left out (the
"filtered" setting), and the true entity is ranked, ties at the mean rank.

One direction runs in two passes:

* scan 1, over chunks of triples: a (chunk, N) score product
  (``score_all_tails`` / ``score_all_heads``: a ``torch.matmul`` for
  DistMult and ComplEx) and each row's count of candidates above and equal
  to the true score, which is taken out of the same matrix;
* scan 2, over ``_PAIR_TILE`` pairs at a time of the flat (row, candidate)
  filter table: each pair and its row's true triple re-scored elementwise
  by ``score``, in the same call at the same shape, the comparison flags
  prefix-summed in exact integers and each row's window subtracted.

Where the flat pair table would pass ``_PAIR_TABLE_BYTES`` a per-chunk
loop runs instead: it gathers the filtered candidates out of the chunk's
score matrix. Either way ranks are floored at 1.

What falls away in torch, the semantics kept: the reference pads a
fallback chunk's pairs to ``_BUCKET_LADDER`` sizes only to bound XLA
recompiles, so here each chunk takes its pairs unpadded; its
``_f32_matmuls`` pin is ``device.check_full_fp32`` (no TF32: a product
rounded differently in the two passes moves ranks, ROADMAP.md hazard H1);
and scan 2's pair table is not padded to whole tiles, since nothing is
compiled per shape. ``chunk·N < 2^31`` stays, so both packages chunk
alike. TransE and RotatE score candidates through (chunk, N, d) float32
intermediates, which XLA fuses away and torch does not; their chunk is
capped so those fit ``_CANDIDATE_BYTES`` (a row's scores do not depend on
the chunk, so no rank moves).

With ``mesh`` (parallel/mesh.py) the ranks of the mesh split each
direction: the triples pad to a multiple of chunk · ranks, each rank runs
its contiguous run of scan 1's chunks (or of the fallback's) and of scan
2's pair tiles (their count rounded up to a multiple of the ranks), the
per-row counts are all-gathered and the per-row filter corrections
all-reduced. Every chunk and tile has the shape and the offset the
unsharded run gives it, so the ranks are the unsharded ranks bit for bit.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import check_full_fp32
from ..parallel.collectives import all_gather, psum

# scan 2's pair tile (the reference's width)
_PAIR_TILE = 1 << 16
# the flat (row, col) int32 pair table above which the fallback runs
_PAIR_TABLE_BYTES = 2 << 30
# device memory for a distance decoder's (chunk, N, d) float32
# intermediates: 4 GiB holds 40 TransE rows at N = 51,664, d = 256
_CANDIDATE_BYTES = 4 << 30


def _build_filter(all_triples: np.ndarray, num_nodes: int,
                  num_keys: int) -> Tuple[np.ndarray, np.ndarray]:
    """→ (keys, tails): the deduplicated known (anchor·K + rel, target)
    pairs, key-major sorted, by one int64 ``np.unique``."""
    keys = all_triples[:, 0].astype(np.int64) * num_keys \
        + all_triples[:, 1]
    packed = np.unique(keys * num_nodes + all_triples[:, 2])
    return (packed // num_nodes).astype(np.int64), \
        (packed % num_nodes).astype(np.int32)


def _assemble_filter_pairs(anchors_p, rels_p, valid, chunk, n_chunks,
                           filt, num_keys):
    """Every (padded) test row's filtered candidates, the known targets
    of its (anchor, rel) key, flat and row-major: ``rows`` (row in its
    chunk), ``cols`` (candidate ids), per-chunk ``offs`` / ``cnts``,
    ``row_global`` and the per-row windows ``bounds`` (num_pad + 1,)."""
    fkeys, ftails = filt
    qk = anchors_p.astype(np.int64) * num_keys + rels_p
    lo = np.searchsorted(fkeys, qk, side="left")
    hi = np.searchsorted(fkeys, qk, side="right")
    counts = np.where(valid, hi - lo, 0).astype(np.int64)
    total = int(counts.sum())
    starts = np.repeat(lo, counts)
    cum0 = np.concatenate([[0], np.cumsum(counts)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(cum0, counts)
    cols = ftails[starts + within].astype(np.int32)
    row_global = np.repeat(np.arange(len(anchors_p), dtype=np.int64),
                           counts)
    rows = (row_global % chunk).astype(np.int32)
    cnts = np.bincount(row_global // chunk,
                       minlength=n_chunks).astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(cnts)[:-1]]).astype(np.int32)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return (rows, cols, offs, cnts,
            row_global.astype(np.int32), bounds.astype(np.int32))


def _total_counts(scores, true_scores):
    """(higher, ties) of each row against all its candidates (int64)."""
    t = true_scores[:, None]
    return (scores > t).sum(1), (scores == t).sum(1)


def _filter_counts(scores, true_scores, rows, cols):
    """Per-row (higher, ties) of the filtered candidates, gathered from
    the chunk's score matrix at the flat (row, col) pairs."""
    vals = scores.reshape(-1)[rows * scores.shape[1] + cols]
    ts = true_scores[rows]
    n = scores.shape[0]
    return (torch.bincount(rows[vals > ts], minlength=n),
            torch.bincount(rows[vals == ts], minlength=n))


def _chunk_cap(decoder, num_nodes: int, width: int) -> int:
    """The most rows of a (chunk, N) candidate pass whose intermediates
    fit ``_CANDIDATE_BYTES`` (no cap for a decoder scoring by a product)."""
    live = getattr(decoder, "candidate_intermediates", 0)
    if not live:
        return 1 << 62
    return max(1, int(_CANDIDATE_BYTES // (live * num_nodes * width * 4)))


class Clock:
    """Seconds of each named part, synchronised on the device, into
    ``timings`` (nothing is recorded, and nothing synchronised, without
    it)."""

    def __init__(self, timings: Optional[dict], device: torch.device):
        self.timings = timings
        self.device = device

    def start(self) -> float:
        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def stop(self, key: str, t0: float, **facts) -> None:
        if self.timings is None:
            return
        self.timings[key] = self.start() - t0
        self.timings.update(facts)


def _scan_chunks(score_all_fn, z, anchors, rels, targets, chunk):
    """Scan 1: each row's (higher, ties) against every candidate; the
    true score comes out of the row's own score matrix, so the self tie
    and exact duplicates tie bitwise."""
    higher = torch.empty_like(anchors)
    ties = torch.empty_like(anchors)
    for lo in range(0, anchors.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        s = score_all_fn(z, anchors[sl], rels[sl])
        ts = s.gather(1, targets[sl, None])[:, 0]
        higher[sl], ties[sl] = _total_counts(s, ts)
    return higher, ties


def _scan_pairs(score_fn, z, anchors, rels, targets, rowg, cols, bounds,
                tiles: range):
    """Scan 2 over the pair ``tiles`` (indices of ``_PAIR_TILE``-wide
    tiles of the flat pair table): the filtered candidates' (higher, ties)
    of every row. Each tile of pairs is scored beside its rows' true
    triples in one call of the same shape (the self pair ties bitwise and
    cancels scan 1's self tie); the flags' int32 prefix sums give each
    row's count over its window ``[bounds[i], bounds[i+1])`` clipped to
    the tile, added to the rows the tile touches."""
    dev = anchors.device
    num_pad, total = anchors.shape[0], len(rowg)
    f_higher = torch.zeros(num_pad, dtype=torch.int64, device=dev)
    f_ties = torch.zeros_like(f_higher)
    prow = torch.from_numpy(rowg.astype(np.int64)).to(dev)
    pcol = torch.from_numpy(cols.astype(np.int64)).to(dev)
    bnd = torch.from_numpy(bounds.astype(np.int64)).to(dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    for off in range(tiles.start * _PAIR_TILE,
                     min(tiles.stop * _PAIR_TILE, total), _PAIR_TILE):
        end = min(off + _PAIR_TILE, total)
        pr = prow[off:end]
        a, r = anchors[pr], rels[pr]
        vals = score_fn(z, a, pcol[off:end], r)
        tsp = score_fn(z, a, targets[pr], r)
        ph = torch.cat([zero, torch.cumsum(vals > tsp, 0,
                                           dtype=torch.int32)])
        pe = torch.cat([zero, torch.cumsum(vals == tsp, 0,
                                           dtype=torch.int32)])
        r0, r1 = int(rowg[off]), int(rowg[end - 1]) + 1
        lo = (bnd[r0:r1] - off).clamp_(0, end - off)
        hi = (bnd[r0 + 1:r1 + 1] - off).clamp_(0, end - off)
        f_higher[r0:r1] += (ph[hi] - ph[lo]).long()
        f_ties[r0:r1] += (pe[hi] - pe[lo]).long()
    return f_higher, f_ties


def _fallback_counts(score_all_fn, z, anchors, rels, targets, chunk,
                     rows, cols, offs, cnts):
    """The per-chunk loop: each chunk's all-candidate counts less those
    of its filtered candidates, gathered from its own score matrix."""
    dev = anchors.device
    higher = torch.empty_like(anchors)
    ties = torch.empty_like(anchors)
    for ci, lo in enumerate(range(0, anchors.shape[0], chunk)):
        sl = slice(lo, lo + chunk)
        s = score_all_fn(z, anchors[sl], rels[sl])
        ts = s.gather(1, targets[sl, None])[:, 0]
        h, t = _total_counts(s, ts)
        if cnts[ci]:
            part = slice(offs[ci], offs[ci] + cnts[ci])
            fh, fe = _filter_counts(
                s, ts, torch.from_numpy(rows[part].astype(np.int64)).to(dev),
                torch.from_numpy(cols[part].astype(np.int64)).to(dev))
            h, t = h - fh, t - fe
        higher[sl], ties[sl] = h, t
    return higher, ties


def _ranks_before_floor(score_all_fn, score_fn, z, anchors, rels, targets,
                        filt, chunk: int, num_keys: int,
                        clock: Clock, side: str, mesh=None) -> np.ndarray:
    """One direction's float32 filtered ranks, 1 + higher + ties/2,
    before the floor at 1 (0 nowhere: the true triple is in the filter);
    with ``mesh`` split over its ranks."""
    num = len(anchors)
    n_dev, me = (1, 0) if mesh is None else (mesh.size, mesh.rank)
    group = None if mesh is None else mesh.group
    # the fallback indexes the (chunk, N) score matrix flat: the
    # reference's int32 bound, kept so both packages chunk alike
    chunk = max(1, min(chunk, (2**31 - 1) // max(z.shape[0], 1)))
    num_pad = -(-num // (chunk * n_dev)) * chunk * n_dev
    pad = num_pad - num
    anchors_p = np.concatenate([anchors, np.zeros(pad, anchors.dtype)])
    rels_p = np.concatenate([rels, np.zeros(pad, rels.dtype)])
    targets_p = np.concatenate([targets, np.zeros(pad, targets.dtype)])
    valid = np.concatenate([np.ones(num, bool), np.zeros(pad, bool)])
    n_chunks = num_pad // chunk

    t0 = clock.start()
    rows, cols, offs, cnts, rowg, bounds = _assemble_filter_pairs(
        anchors_p, rels_p, valid, chunk, n_chunks, filt, num_keys)
    total = len(rows)
    scanned = total * 4 * 2 <= _PAIR_TABLE_BYTES
    clock.stop(f"{side}_assemble_s", t0, **{
        f"{side}_pairs": total, f"{side}_chunk": chunk,
        f"{side}_path": "scanned" if scanned else "fallback"})

    def dev(a):
        return torch.from_numpy(a.astype(np.int64)).to(z.device)

    a_d, r_d, t_d = dev(anchors_p), dev(rels_p), dev(targets_p)
    # this rank's run of rows (whole chunks) and of pair tiles
    per = num_pad // n_dev
    mine = slice(me * per, (me + 1) * per)
    n_tiles = -(-max(1, -(-total // _PAIR_TILE)) // n_dev) * n_dev
    tiles = range(me * n_tiles // n_dev, (me + 1) * n_tiles // n_dev)
    t0 = clock.start()
    if scanned:
        higher, ties = _scan_chunks(score_all_fn, z, a_d[mine], r_d[mine],
                                    t_d[mine], chunk)
        higher, ties = all_gather(higher, group), all_gather(ties, group)
        clock.stop(f"{side}_scan1_s", t0)
        t0 = clock.start()
        fh, fe = _scan_pairs(score_fn, z, a_d, r_d, t_d, rowg, cols, bounds,
                             tiles)
        higher, ties = higher - psum(fh, group), ties - psum(fe, group)
        clock.stop(f"{side}_scan2_s", t0)
    else:
        c0 = me * per // chunk
        higher, ties = _fallback_counts(
            score_all_fn, z, a_d[mine], r_d[mine], t_d[mine], chunk, rows,
            cols, offs[c0:], cnts[c0:])
        higher, ties = all_gather(higher, group), all_gather(ties, group)
        clock.stop(f"{side}_fallback_s", t0)
    rank = 1.0 + higher.double() + 0.5 * ties.double()
    return rank[:num].float().cpu().numpy()


def _direction_ranks(*args, **kwargs) -> np.ndarray:
    """``_ranks_before_floor`` floored at 1: the true entity always ranks
    at least first, even where a last-ulp disagreement between the two
    passes over a candidate tied with the true score would push it
    lower."""
    return np.maximum(_ranks_before_floor(*args, **kwargs),
                      np.float32(1.0))


@torch.inference_mode()
def filtered_ranking_metrics(decoder, z, test_triples: np.ndarray,
                             all_triples: np.ndarray,
                             ks: Sequence[int] = (1, 3, 10),
                             chunk: int = 1024,
                             both_sides: bool = True,
                             mesh=None,
                             timings: Optional[dict] = None
                             ) -> Dict[str, float]:
    """Filtered MRR, mean rank and Hits@K.

    Args:
      decoder: a ``models/decoders.py`` decoder (``score``,
        ``score_all_tails``, ``score_all_heads``), on z's device.
      z: (N, d) full-graph node embeddings (a tensor, or an array moved
        to the decoder's device).
      test_triples: (T, 3) int array of (head, rel, tail).
      all_triples: (A, 3) known-true triples (train ∪ val ∪ test).
      mesh: a ``parallel.mesh.Mesh``: its ranks split the triples (z and
        the decoder replicated on each); every rank returns the metrics.
      timings: if a dict, each part's seconds (the filter build, and per
        side the pair assembly, scan 1 and scan 2 or the fallback,
        synchronised on the device), the pair count, the chunk and the
        path taken go into it.
    """
    check_full_fp32()
    test_triples = np.asarray(test_triples, dtype=np.int64)
    all_triples = np.asarray(all_triples, dtype=np.int64)
    if not isinstance(z, torch.Tensor):
        z = torch.as_tensor(np.asarray(z)).to(decoder.rel_emb.device)
    clock = Clock(timings, z.device)

    num_nodes = int(z.shape[0])
    num_keys = int(max(all_triples[:, 1].max(initial=0),
                       test_triples[:, 1].max(initial=0))) + 1
    chunk = min(chunk, _chunk_cap(decoder, num_nodes, int(z.shape[1])))
    t0 = clock.start()
    tail_filter = _build_filter(all_triples, num_nodes, num_keys)
    head_filter = _build_filter(all_triples[:, [2, 1, 0]], num_nodes,
                                num_keys)
    clock.stop("filter_s", t0)

    def tails_fn(zz, h, t, r):
        return decoder.score(zz, h, t, r)

    def heads_fn(zz, t, h, r):
        return decoder.score(zz, h, t, r)

    ranks = [_direction_ranks(
        decoder.score_all_tails, tails_fn, z, test_triples[:, 0],
        test_triples[:, 1], test_triples[:, 2], tail_filter, chunk,
        num_keys, clock, "tail", mesh)]
    if both_sides:
        ranks.append(_direction_ranks(
            decoder.score_all_heads, heads_fn, z, test_triples[:, 2],
            test_triples[:, 1], test_triples[:, 0], head_filter, chunk,
            num_keys, clock, "head", mesh))

    all_ranks = np.concatenate(ranks)
    out = {
        "mrr": float(np.mean(1.0 / all_ranks)),
        "mean_rank": float(np.mean(all_ranks)),
    }
    for k in ks:
        out[f"hits@{k}"] = float(np.mean(all_ranks <= k))
    return out
