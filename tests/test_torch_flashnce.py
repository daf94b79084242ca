"""The plain ``flash_denom`` (ops/flashnce.py) against the JAX package:
its Pallas ``flashnce.flash_denom`` in interpret mode (as
tests/test_gcl_losses.py runs it) and the XLA flash path
``_flash_pos_denom``, values and gradients, float32 at rtol 2e-6 / 2e-5;
ragged N with a padded tail; bf16 at JAX's own bounds (denominators within
0.1 of float32, gradients within 5e-2 of their max). The CUDA kernels
themselves run only on the card (chip_smoke.py phase 8); here the wrappers
must refuse a CPU tensor rather than fall back."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biomedkg_tpu.ops.pallas import flashnce as jax_flashnce
from biomedkg_tpu.training.gcl_module import _flash_pos_denom
from biomedkg_tpu_torch.ops import flashnce

TAU = 0.2


def _inputs(n, d, pads, seed):
    rng = np.random.default_rng(seed)
    an = rng.standard_normal((n, d)).astype(np.float32)
    bn = rng.standard_normal((n, d)).astype(np.float32)
    an /= np.linalg.norm(an, axis=1, keepdims=True)
    bn /= np.linalg.norm(bn, axis=1, keepdims=True)
    mask = np.arange(n) < n - pads
    col = np.where(mask, 0.0, np.finfo(np.float32).min).astype(np.float32)
    w = (rng.standard_normal(n).astype(np.float32) * mask).astype(np.float32)
    return an, bn, col, w, mask


def _port(an, bn, col, w, dtype=torch.float32, block=flashnce.PLAIN_BLOCK):
    a = torch.tensor(an).to(dtype).requires_grad_(True)
    b = torch.tensor(bn).to(dtype).requires_grad_(True)
    den = flashnce.flash_denom(a, b, torch.tensor(col), TAU, block)
    grads = torch.autograd.grad((den * torch.tensor(w)).sum(), (a, b))
    return den.detach().numpy(), [g.float().numpy() for g in grads]


def _xla(an, bn, col, w, block, dtype=jnp.float32):
    def f(a, b):
        _, den = _flash_pos_denom(a, b, jnp.asarray(col), block, TAU)
        return jnp.sum(den * w), den
    (_, den), grads = jax.value_and_grad(f, (0, 1), has_aux=True)(
        jnp.asarray(an, dtype), jnp.asarray(bn, dtype))
    return np.asarray(den), [np.asarray(g, np.float32) for g in grads]


def test_plain_matches_jax_pallas_kernel_interpret():
    """Against the Pallas kernels (forward, rows and columns backward) in
    interpret mode and the XLA flash path, float32, a padded tail."""
    n, d, block = 256, 128, 64
    an, bn, col, w, _ = _inputs(n, d, 17, seed=11)

    def via_kernel(a, b):
        return jnp.sum(jax_flashnce.flash_denom(a, b, jnp.asarray(col),
                                                block, TAU) * w)

    jax_flashnce._FORCE_KERNEL = True
    try:
        with pltpu.force_tpu_interpret_mode():
            den_k = np.asarray(jax_flashnce.flash_denom(
                jnp.asarray(an), jnp.asarray(bn), jnp.asarray(col), block,
                TAU))
            grads_k = jax.grad(via_kernel, (0, 1))(jnp.asarray(an),
                                                   jnp.asarray(bn))
    finally:
        jax_flashnce._FORCE_KERNEL = False
    den, grads = _port(an, bn, col, w, block=block)
    np.testing.assert_allclose(den, den_k, rtol=2e-6, atol=2e-6)
    for got, want in zip(grads, grads_k):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-6)
    den_x, grads_x = _xla(an, bn, col, w, block)
    np.testing.assert_allclose(den, den_x, rtol=2e-6, atol=2e-6)
    for got, want in zip(grads, grads_x):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("n,d,pads,block", [(333, 36, 40, 100),
                                            (1000, 100, 0, 1024),
                                            (200, 30, 9, 64)])
def test_plain_ragged_matches_jax(n, d, pads, block):
    """N no multiple of the tile (the plain version's last tile ragged),
    with and without a padded tail, against the XLA flash path over one
    N-row tile."""
    an, bn, col, w, _ = _inputs(n, d, pads, seed=n)
    den, grads = _port(an, bn, col, w, block=block)
    den_x, grads_x = _xla(an, bn, col, w, block=n)
    np.testing.assert_allclose(den, den_x, rtol=2e-6, atol=2e-6)
    for got, want in zip(grads, grads_x):
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_plain_bf16_at_jax_bounds():
    """bf16 operands: denominators within 0.1 of JAX's float32 ones; the
    gradients within 5e-2 of their max of JAX's bf16 flash gradients (both
    round the logits and the cotangents to bf16 at the same places)."""
    n, d, pads = 320, 64, 23
    an, bn, col, w, mask = _inputs(n, d, pads, seed=5)
    den, grads = _port(an, bn, col, w, dtype=torch.bfloat16, block=64)
    den_32, _ = _xla(an, bn, col, w, block=64)
    assert np.abs(den[mask] - den_32[mask]).max() < 0.1
    _, grads_16 = _xla(an, bn, col, w, block=64, dtype=jnp.bfloat16)
    for got, want in zip(grads, grads_16):
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CPU tensor reaches the kernels' wrappers only by mistake: they
    raise instead of computing; ``flash_denom`` takes the plain version
    only because the tensors lie on the CPU."""
    an, bn, col, w, _ = _inputs(70, 16, 3, seed=1)
    a, b, c = torch.tensor(an), torch.tensor(bn), torch.tensor(col)
    with pytest.raises(ValueError, match="CUDA"):
        flashnce.FORWARD(a, b, c, TAU)
    den = flashnce.denominators_plain(a, b, c, TAU)
    with pytest.raises(ValueError, match="CUDA"):
        flashnce.BACKWARD(a, b, c, den, torch.ones(70), TAU)
    assert flashnce.FORWARD.launches == flashnce.BACKWARD.launches == 0
    np.testing.assert_array_equal(
        flashnce.flash_denom(a, b, c, TAU).numpy(), den.numpy())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flashnce.flash_denom(a.double(), b.double(), c, TAU)


# -- the pad-tile skip -------------------------------------------------------

def _layout(n, layout, seed):
    """(col, g) float32 numpy for a pad layout: "tail" (the last fifth
    pads, g 0 there), "no pads", "all pads" (g on every row), "scattered"
    (every third 64-row tile all pads, the others pads at random, g 0 on
    pads), "g on pads" (the scattered pads, g nonzero on them and every
    fourth tile's g all 0)."""
    rng = np.random.default_rng(seed)
    tile = np.arange(n) // flashnce.TILE
    real = {"tail": np.arange(n) < n - n // 5,
            "no pads": np.ones(n, bool),
            "all pads": np.zeros(n, bool)}.get(layout)
    if real is None:
        real = (rng.random(n) > 0.4) & (tile % 3 != 1)
    col = np.where(real, 0.0, np.finfo(np.float32).min).astype(np.float32)
    g = rng.random(n).astype(np.float32)
    if layout == "g on pads":
        g *= tile % 4 != 2
    elif layout != "all pads":
        g *= real
    return col, g


LAYOUTS = ["tail", "no pads", "all pads", "scattered", "g on pads"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_live_tiles_against_brute_force(layout):
    """live_tiles's flags: a real column, a nonzero g, per 64-row tile
    (the last one ragged), against a loop over the tiles."""
    n = 777
    col, g = _layout(n, layout, seed=3)
    flags = flashnce.live_tiles(torch.tensor(col), torch.tensor(g))
    t = -(-n // flashnce.TILE)
    assert flags.shape == (2, t) and flags.dtype == torch.bool
    for i in range(t):
        rows = slice(i * flashnce.TILE, (i + 1) * flashnce.TILE)
        assert bool(flags[0, i]) == any(c > np.finfo(np.float32).min
                                        for c in col[rows])
        assert bool(flags[1, i]) == any(v != 0 for v in g[rows])
    no_g = flashnce.live_tiles(torch.tensor(col))
    assert torch.equal(no_g[0], flags[0]) and not no_g[1].any()


def _sums64(an, bn, col, g, live=None):
    """den, d_an, d_bn in float64 (numpy), over every term, or with the
    (col, g) flags ``live`` over the live tiles only, as the kernels skip:
    the forward's column tiles with a real column (all of them where none
    has), the backward's terms whose g-tile row and column-tile column are
    both live."""
    n = an.shape[0]
    inter = an @ bn.T / TAU + col[None, :]
    intra = an @ an.T / TAU + col[None, :]
    intra[np.arange(n), np.arange(n)] = np.finfo(np.float32).min
    keep = np.ones((n, n), bool)
    if live is not None:
        tile = np.arange(n) // flashnce.TILE
        c_live = live[0] if live[0].any() else np.ones_like(live[0])
        cols = c_live[tile]
        keep = live[1][tile][:, None] & cols[None, :]
        inter, intra = inter[:, cols], intra[:, cols]
    both = np.concatenate([inter, intra], 1)
    m = both.max(1)
    den = m + np.log(np.exp(both - m[:, None]).sum(1))
    inter = an @ bn.T / TAU + col[None, :]
    intra = an @ an.T / TAU + col[None, :]
    intra[np.arange(n), np.arange(n)] = np.finfo(np.float32).min
    gi = np.where(keep, g[:, None] * np.exp(inter - den[:, None]), 0.0)
    gt = np.where(keep, g[:, None] * np.exp(intra - den[:, None]), 0.0)
    return den, (gi @ bn + gt @ an + gt.T @ an) / TAU, gi.T @ an / TAU


@pytest.mark.parametrize("layout", LAYOUTS)
def test_skip_is_exact(layout):
    """The sums over the live tile pairs alone equal the sums over every
    pair to 1e-12 relative (float64): every term the kernels skip is an
    exact 0, whatever the pad layout and wherever g is nonzero. The full
    float64 sums equal the plain version (float32) to 1e-5."""
    n, d = 333, 24
    an, bn, _, _, _ = _inputs(n, d, 0, seed=17)
    col, g = _layout(n, layout, seed=4)
    a64, b64 = an.astype(np.float64), bn.astype(np.float64)
    c64, g64 = col.astype(np.float64), g.astype(np.float64)
    live = flashnce.live_tiles(torch.tensor(col), torch.tensor(g)).numpy()
    full = _sums64(a64, b64, c64, g64)
    skipped = _sums64(a64, b64, c64, g64, live)
    for got, want in zip(skipped, full):
        scale = max(np.abs(want).max(), 1e-300)
        assert np.abs(got - want).max() <= 1e-12 * scale
    den = flashnce.denominators_plain(torch.tensor(an), torch.tensor(bn),
                                      torch.tensor(col), TAU)
    grads = flashnce.denominator_grads_plain(
        torch.tensor(an), torch.tensor(bn), torch.tensor(col), den,
        torch.tensor(g), TAU)
    np.testing.assert_allclose(den.numpy(), full[0], rtol=1e-5)
    for got, want in zip(grads, full[1:]):
        assert np.abs(got.numpy() - want).max() \
            <= 1e-5 * np.abs(want).max()


def test_kernel_wrappers_refuse_bad_flags():
    """Live flags passed by the caller must be (2, ceil(N / 64)) bool or
    uint8 on the inputs' device: the wrappers refuse others before they
    look for a card."""
    an, bn, col, w, _ = _inputs(130, 16, 3, seed=2)
    a, b, c = torch.tensor(an), torch.tensor(bn), torch.tensor(col)
    g = torch.tensor(w)
    den = flashnce.denominators_plain(a, b, c, TAU)
    good = flashnce.live_tiles(c, g)
    assert good.shape == (2, 3)
    bad = [good[:, :2], good.float(), torch.zeros(2, 3, dtype=torch.bool,
                                                   device="meta"),
           good.T.contiguous().T]
    for flags in bad:
        with pytest.raises(ValueError, match="flags"):
            flashnce.FORWARD(a, b, c, TAU, flags=flags)
        with pytest.raises(ValueError, match="flags"):
            flashnce.BACKWARD(a, b, c, den, g, TAU, flags=flags)
    with pytest.raises(ValueError, match="CUDA"):
        flashnce.FORWARD(a, b, c, TAU, flags=good)
    assert flashnce.FORWARD.launches == flashnce.BACKWARD.launches == 0


def test_designs_and_path():
    """Each type's path, general and first design take that type; the
    wrappers count launches by design."""
    for dtype in (torch.float32, torch.bfloat16):
        assert flashnce.DESIGNS[flashnce.flash_design(dtype, 256, 0)] \
            == dtype
        assert flashnce.DESIGNS[flashnce.GENERAL[dtype]] == dtype
        assert flashnce.DESIGNS[flashnce.FIRST[dtype]] == dtype
    assert flashnce.PATH == {torch.float32: "wide_f32",
                             torch.bfloat16: "wgmma_bf16"}
    assert flashnce.GENERAL == {torch.float32: "wide_f32",
                                torch.bfloat16: "skip_bf16"}
    assert flashnce.DESIGNS["whole_f32"] == torch.float32
    assert "whole_f32" not in {*flashnce.PATH.values(),
                               *flashnce.GENERAL.values(),
                               *flashnce.FIRST.values()}
    assert set(flashnce.FORWARD.by_design) == set(flashnce.DESIGNS)


def test_launch_codes_match_the_source():
    """DESIGNS' order is the launch codes of csrc/flashnce.cu's Design
    enum: wgmma_bf16 takes 4, whole_f32 5, the earlier designs keep
    theirs."""
    import os
    import re
    with open(os.path.join(os.path.dirname(flashnce.__file__), "..", "csrc",
                           "flashnce.cu")) as f:
        enum = re.search(r"enum Design \{([^}]*)\}", f.read()).group(1)
    codes = {m.group(1): int(m.group(2))
             for m in re.finditer(r"k(\w+) = (\d+)", enum)}
    names = {"FirstF32": "first_f32", "FirstBf16": "first_bf16",
             "SkipBf16": "skip_bf16", "WideF32": "wide_f32",
             "WgmmaBf16": "wgmma_bf16", "WholeF32": "whole_f32"}
    assert {names[k]: v for k, v in codes.items()} \
        == {d: i for i, d in enumerate(flashnce.DESIGNS)}
    assert list(flashnce.DESIGNS) == ["first_f32", "first_bf16", "skip_bf16",
                                      "wide_f32", "wgmma_bf16", "whole_f32"]
    assert flashnce.SLICING == {"wide_f32", "wgmma_bf16", "whole_f32"}
    assert flashnce.SKIPPING == {"skip_bf16", "wide_f32", "wgmma_bf16",
                                 "whole_f32"}
    assert flashnce.BALANCED == {"wide_f32"}


def _bases(n, d, dtype, offset=0):
    """an, bn (n, d) views whose bases lie ``offset`` elements past a
    fresh (16-byte aligned) allocation."""
    flat = torch.zeros(2, n * d + 8, dtype=dtype)
    return [flat[i, offset:offset + n * d].view(n, d) for i in range(2)]


@pytest.mark.parametrize("dtype,d,offsets,want", [
    (torch.bfloat16, 256, (0, 0), "wgmma_bf16"),   # GRACE's path
    (torch.bfloat16, 8, (0, 0), "wgmma_bf16"),
    (torch.bfloat16, 72, (0, 0), "wgmma_bf16"),
    (torch.bfloat16, 136, (0, 0), "wgmma_bf16"),
    (torch.bfloat16, 100, (0, 0), "skip_bf16"),    # no multiple of 8
    (torch.bfloat16, 36, (0, 0), "skip_bf16"),
    (torch.bfloat16, 30, (0, 0), "skip_bf16"),
    (torch.bfloat16, 256, (1, 0), "skip_bf16"),    # an 2 bytes off
    (torch.bfloat16, 256, (0, 4), "skip_bf16"),    # bn 8 bytes off
    (torch.bfloat16, 256, (8, 8), "wgmma_bf16"),   # 16 bytes off
    (torch.float32, 256, (0, 0), "wide_f32"),
    (torch.float32, 100, (1, 3), "wide_f32"),
    (torch.float32, 30, (0, 0), "wide_f32"),
])
def test_flash_design_picker(dtype, d, offsets, want):
    """flash_design: bf16 takes wgmma_bf16 where d is a multiple of 8 and
    both bases are 16-byte aligned (TMA's rule), else skip_bf16; float32
    always wide_f32. The wrappers pick by the tensors' own bases."""
    an = _bases(37 if d > 8 else 130, d, dtype, offsets[0])[0]
    bn = _bases(an.shape[0], d, dtype, offsets[1])[1]
    assert flashnce.flash_design(dtype, d, an.data_ptr(),
                                 bn.data_ptr()) == want
    assert flashnce._design("flash", an, bn) == want


def _nonzero_terms(an, bn, col, g):
    """The backward's terms in float64, as (own row, streamed row) bool
    matrices per job: whether the term is nonzero. Job 0 (own an, streamed
    bn) the rows term g_o exp(inter_os - den_o); job 2 (own bn, streamed
    an) the columns term g_s exp(inter_so - den_s); job 1 (own an,
    streamed an) both intra terms, the diagonal at finfo(float32).min."""
    n = an.shape[0]
    neg = np.finfo(np.float32).min
    inter = an @ bn.T / TAU + col[None, :]
    intra = an @ an.T / TAU + col[None, :]
    intra[np.arange(n), np.arange(n)] = neg
    both = np.concatenate([inter, intra], 1)
    m = both.max(1)
    den = m + np.log(np.exp(both - m[:, None]).sum(1))
    gi = g[:, None] * np.exp(inter - den[:, None])
    gt = g[:, None] * np.exp(intra - den[:, None])
    return {0: gi != 0, 1: (gt != 0) | (gt.T != 0), 2: gi.T != 0}


@pytest.mark.parametrize("own_rows", [64, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_live_pairs_against_brute_force(layout, own_rows):
    """live_pairs, the kernels' pair rule over the flags (128 own rows:
    wide_f32's and wgmma_bf16's CTAs, either 64-row half live), equals a
    brute force over the terms: a pair is computed exactly when one of its
    terms is nonzero, per job, whatever the pad layout."""
    n, d = 777, 16
    an, bn, _, _, _ = _inputs(n, d, 0, seed=23)
    col, g = _layout(n, layout, seed=5)
    flags = flashnce.live_tiles(torch.tensor(col), torch.tensor(g))
    terms = _nonzero_terms(an.astype(np.float64), bn.astype(np.float64),
                           col.astype(np.float64), g.astype(np.float64))
    t = -(-n // flashnce.TILE)
    for job in range(flashnce.JOBS):
        got = flashnce.live_pairs(flags, job, own_rows).numpy()
        assert got.shape == (-(-t * flashnce.TILE // own_rows), t)
        for o in range(got.shape[0]):
            for s in range(t):
                block = terms[job][o * own_rows:(o + 1) * own_rows,
                                   s * flashnce.TILE:(s + 1) * flashnce.TILE]
                assert got[o, s] == bool(block.any()), (job, o, s)


@pytest.mark.parametrize("rows", [64, 128])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_live_columns_against_brute_force(layout, rows):
    """live_columns, the forward's rule over the flags (128-row column
    tiles: wide_f32's and wgmma_bf16's), equals a brute force: a column
    tile is computed exactly when one of its terms exp(logit + col - m)
    is not an exact 0, which is every tile where no column is real."""
    n = 777
    col, _ = _layout(n, layout, seed=6)
    flags = flashnce.live_tiles(torch.tensor(col))
    got = flashnce.live_columns(flags, rows).numpy()
    assert got.shape == (-(-n // rows),)
    real = col > np.finfo(np.float32).min
    for u in range(got.shape[0]):
        assert got[u] == bool(real[u * rows:(u + 1) * rows].any()
                              or not real.any())


def _live_lists(flags):
    """Per (job, 128-row own tile): its live 64-row streamed tiles in
    order, by live_pairs' rule (itself held against the terms above)."""
    return {(job, o): [int(u) for u in row.nonzero().flatten()]
            for job in range(flashnce.JOBS)
            for o, row in enumerate(flashnce.live_pairs(
                flags, job, flashnce.OWN_ROWS))}


@pytest.mark.parametrize("slots", [1, 3, 7, 132])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_bwd_plan_against_brute_force(layout, slots):
    """bwd_plan, the model of wide_f32's backward grid, on every pad
    layout and several resident-CTA counts: each item's live pairs
    (BwdItems' count from three sums) equal live_pairs' row; every live
    (job, own tile, streamed tile) pair is computed by exactly one unit;
    a cut item's slices are contiguous runs of its live tiles in slot
    order (the merge's order), at least one tile each; whole items and
    zeros never touch the workspace, slices stay within bwd_workspace's
    blocks, each once; an item with no live pair writes zeros and an
    item with one never does; only the last L mod slots items are cut."""
    n = 777
    col, g = _layout(n, layout, seed=7)
    flags = flashnce.live_tiles(torch.tensor(col), torch.tensor(g))
    lists = _live_lists(flags)
    pairs = flashnce.bwd_item_pairs(flags)
    for (job, o), tiles in lists.items():
        assert int(pairs[job, o]) == len(tiles), (job, o)
    plan = flashnce.bwd_plan(flags, slots)
    blocks = flashnce.bwd_workspace(slots, 256)[0]
    assert flashnce.bwd_workspace(slots, 100) == (slots, flashnce.OWN_ROWS,
                                                  112)
    covered, slices, used = [], {}, set()
    for u in plan:
        tiles = lists[u.job, u.own]
        if u.kind == "zeros":
            assert not tiles and u.slot == -1
            continue
        assert tiles and u.count >= 1
        covered += [(u.job, u.own, t) for t in tiles[u.lo:u.lo + u.count]]
        if u.kind == "whole":
            assert u.slot == -1 and (u.lo, u.count) == (0, len(tiles))
        else:
            assert 0 <= u.slot < blocks and u.slot not in used
            used.add(u.slot)
            slices.setdefault((u.job, u.own), []).append(u)
    want = [(job, o, t) for (job, o), tiles in lists.items() for t in tiles]
    assert sorted(covered) == sorted(want)
    assert len(set(covered)) == len(covered)
    live = [item for item, tiles in lists.items() if tiles]  # item order
    assert sorted(slices) == live[len(live) - len(live) % slots:]
    for item, parts in slices.items():
        parts.sort(key=lambda u: u.slot)
        assert [u.slot - parts[0].slot for u in parts] \
            == list(range(len(parts)))
        assert parts[0].lo == 0
        assert all(a.lo + a.count == b.lo for a, b in zip(parts, parts[1:]))
        assert parts[-1].lo + parts[-1].count == len(lists[item])
        assert {u.slices for u in parts} == {len(parts)}
        assert len({u.cut for u in parts}) == 1
    order = [u.kind for u in plan]
    assert order == sorted(order, key=["zeros", "whole", "slice"].index)
