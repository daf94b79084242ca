"""Flash InfoNCE denominators: ``den[i] = logsumexp_j concat(an_i·bn_j/τ +
col_j, an_i·an_j/τ + col_j)`` with the intra diagonal masked to
finfo(float32).min.

Counterpart of biomedkg_tpu/ops/pallas/flashnce.py::flash_denom, the
denominator of GRACE's intraview InfoNCE (training/gcl_module.py). ``an``,
``bn`` are the (N, d) L2-normalised projections (float32 or bfloat16),
``col`` the (N,) float32 additive pad mask (0 or finfo.min, not
differentiated); the result is (N,) float32. The positive term stays with
the caller.

On a CUDA tensor the forward and the backward run the hand-written Hopper
kernels of ``csrc/flashnce.cu`` (built at first use by ops/_build.py), for
any N and any d up to 256, in the design ``flash_design`` picks from the
type, d and the bases' alignment: ``wide_f32`` (full float32 on register
tiles of 8 x 8 and 8 x 4 logits a thread fed by a cp.async ring) and, in
bf16, ``wgmma_bf16`` (TMA-fed wgmma, the logits and cotangents in
registers) where TMA takes the tables, else ``skip_bf16`` (the first
design's WMMA kernels); ``first_f32`` and ``first_bf16``, the first
design with every tile computed, stay for the A/B on the card, as does
``skip_bf16`` where wgmma_bf16 runs.
The designs but the first skip the tiles whose terms are all exactly 0:
``live_tiles`` reads from ``col`` and ``g`` which 64-row tiles hold a real
column and which a nonzero cotangent, and the kernels leave out a column
tile without a real column (forward) and a tile pair whose rows term and
columns term are both 0 (backward). The backward follows the Pallas
design's flash split into a rows side and a columns side, so that no
output element is written by two CTAs: one launch runs three jobs,
rows-inter, columns-inter and intra (both sides at once: ``an_i·an_j`` is
the logit at (i, j) and at (j, i), and both cotangents multiply ``an_j``
into row i), each rebuilding its logit tiles from the saved ``den``,
without atomics, deterministic; this wrapper sums them (``d_an`` =
rows-inter + intra, ``d_bn`` = columns-inter). That is six N × N × d
products where the function needs five, since jobs 0 and 2 both rebuild
the inter logits; the one-pass choice, which builds them once and writes
the columns side with float32 atomics, would land every (tile, column)
partial sum as an atomic: 1.1·10¹⁰ of them at GRACE's N = 37,376, d = 256.
``wide_f32``'s backward fills the card's last wave: of its items (a job
and a 128-row own tile) those that fill whole waves run whole, one CTA
each, and the rest are cut into slices of their live streamed tiles,
whose partial sums the slice that finishes last adds in slice order
(``bwd_plan`` models the grid); ``whole_f32`` runs the same kernels with
the backward on one slot, every item whole, one CTA an item, kept for the
A/B.
Besides the kernel, a skipping forward launches ``live_tiles``'s three
small kernels (a zero fill, a compare, a reduction) and, for a design
that slices (``wide_f32``, ``whole_f32``, ``wgmma_bf16``) into more than
one slice, one zero fill of its tickets; a skipping backward four (a
second compare, for ``g``), and ``wide_f32``'s one zero fill of its
tickets.

On a CPU tensor it runs the plain version: a torch port of the reference's
XLA flash path (``_flash_pos_denom``, gcl_module.py:59-140, without its
positive term), an autograd Function over (block, N) row tiles whose
backward rebuilds each tile, so no (N, N) matrix outlives a tile (autograd
through the tiles would keep two float32 (N, N) matrices per direction).
It rounds where the XLA path rounds: in bf16 the logits are rounded to
bf16 before the float32 logsumexp, and the cotangents are rounded to bf16
as operands of the backward's products. A CUDA tensor never falls back to
it: the kernels build and launch, or the call raises. ``chip_smoke.py``
holds the kernels against it on the card.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple

import torch

from ._build import CudaLibrary, check_launch, stream_of

NEG = torch.finfo(torch.float32).min
MAX_D = 256
TILE = 64          # rows per live flag, and the first design's tile
OWN_ROWS = 128     # own rows per CTA of wide_f32 and wgmma_bf16 (wide::kO,
                   # wg::kO), the forward's column tile, and a slice's rows
JOBS = 3           # the backward's: rows-inter, intra, columns-inter
PLAIN_BLOCK = 1024  # rows per tile of the plain version by default
# csrc/flashnce.cu's designs, in the order of their launch codes, and the
# type each takes
DESIGNS = {"first_f32": torch.float32, "first_bf16": torch.bfloat16,
           "skip_bf16": torch.bfloat16, "wide_f32": torch.float32,
           "wgmma_bf16": torch.bfloat16, "whole_f32": torch.float32}
# per type: the path's design where the widths and bases allow (every call
# of GRACE's path), the one that takes any, and the first design
PATH = {torch.float32: "wide_f32", torch.bfloat16: "wgmma_bf16"}
GENERAL = {torch.float32: "wide_f32", torch.bfloat16: "skip_bf16"}
FIRST = {torch.float32: "first_f32", torch.bfloat16: "first_bf16"}
# forwards cut into slices
SLICING = {"wide_f32", "wgmma_bf16", "whole_f32"}
# backwards whose last wave is filled with slices (bwd_plan)
BALANCED = {"wide_f32"}
# the designs that read live_tiles' flags
SKIPPING = set(PATH.values()) | set(GENERAL.values()) | {"whole_f32"}
# what a balanced backward adds to its wrapper's tally each launch: the
# items with a live pair, the items cut into slices, the slices run
TALLY = ("flash_bwd_items", "flash_bwd_cut", "flash_bwd_slices")

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = CudaLibrary("flashnce.cu", {
    # design, an, bn, col, flags, den, part_s, part_m, tickets, splits, n,
    # d, tau, stream
    "flashnce_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     ctypes.c_float, _P],
    # design, an, bn, col, den, g, flags, out, part, tickets, tally, slots,
    # n, d, tau, stream
    "flashnce_bwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                     _I, ctypes.c_float, _P],
    # design, n
    "flashnce_fwd_splits": [_I, _I],
    # design
    "flashnce_bwd_slots": [_I],
    "flashnce_attributes": [_I, _I, ctypes.POINTER(ctypes.c_int)]})
NAME = "flash_denom"


def flash_design(dtype: torch.dtype, d: int, *addresses: int) -> str:
    """The design a call on the card runs for an (N, d) table pair of
    ``dtype`` at ``addresses`` (an's and bn's bases): the path's design
    where it takes them, else the general one. wgmma_bf16's TMA maps need
    16-byte aligned bases and row strides (d a multiple of 8); wide_f32
    takes any. A fixed rule on the widths and bases: a failed build,
    launch or tensor map raises, it never sends a call elsewhere."""
    if dtype == torch.bfloat16 and not (
            d % 8 == 0 and all(a % 16 == 0 for a in addresses)):
        return GENERAL[dtype]
    return PATH[dtype]


def live_tiles(col: torch.Tensor, g: torch.Tensor = None,
               tile: int = TILE) -> torch.Tensor:
    """(2, ceil(N / tile)) bool flags of ``tile``-row tiles: row 0 whether
    any column mask in the tile is real (``col > NEG``), row 1 whether any
    cotangent in it is nonzero (all False without ``g``). Read from the
    data alone; the same on the CPU and the card."""
    n = col.shape[0]
    t = -(-n // tile)
    flags = torch.zeros(2, t * tile, dtype=torch.bool, device=col.device)
    torch.gt(col, NEG, out=flags[0, :n])
    if g is not None:
        torch.ne(g, 0, out=flags[1, :n])
    return flags.view(2, t, tile).any(2)


def _coarse(flags_row: torch.Tensor, rows: int) -> torch.Tensor:
    """A row of live flags over tiles of ``rows`` (a multiple of TILE):
    live where any of its 64-row tiles is."""
    k = rows // TILE
    pad = -flags_row.shape[0] % k
    return torch.cat([flags_row, flags_row.new_zeros(pad)]).view(-1, k) \
        .any(1)


def live_columns(flags: torch.Tensor, rows: int = TILE) -> torch.Tensor:
    """The forward's skip rule (csrc/flashnce.cu ``Live``): which column
    tiles of ``rows`` (64: the first design; 128: wide_f32 and
    wgmma_bf16) a skipping forward computes, from ``live_tiles``' flags:
    those with a real column, or every one where no column is real."""
    c = flags[0] if bool(flags[0].any()) else torch.ones_like(flags[0])
    return _coarse(c, rows)


def live_pairs(flags: torch.Tensor, job: int,
               own_rows: int = TILE) -> torch.Tensor:
    """The backward's pair rule (csrc/flashnce.cu ``Live::pair``): (own
    tiles of ``own_rows``, 64-row streamed tiles) bool, True where a
    skipping backward computes the pair for ``job`` (0 rows-inter, 1
    intra, 2 columns-inter): the rows term needs a nonzero g among the own
    rows and a real column among the streamed ones, the columns term the
    same swapped, job 1 either. Own tiles of 128 rows (wide_f32,
    wgmma_bf16) are live where either 64-row half is."""
    c = flags[0] if bool(flags[0].any()) else torch.ones_like(flags[0])
    g = flags[1]
    rows = _coarse(g, own_rows)[:, None] & c[None, :]
    cols = _coarse(c, own_rows)[:, None] & g[None, :]
    return rows if job == 0 else cols if job == 2 else rows | cols


def bwd_item_pairs(flags: torch.Tensor) -> torch.Tensor:
    """(JOBS, own tiles of OWN_ROWS) int64: each backward item's live
    pairs, as csrc/flashnce.cu's ``BwdItems`` counts them from three sums
    over the streamed tiles (a real column, a nonzero g, either) and what
    the item's own tile holds."""
    c = flags[0] if bool(flags[0].any()) else torch.ones_like(flags[0])
    g = flags[1]
    n_c, n_g, n_cg = (int(x.sum()) for x in (c, g, c | g))
    rows, cols = _coarse(g, OWN_ROWS).long(), _coarse(c, OWN_ROWS).long()
    both = torch.where(rows.bool() & cols.bool(), n_cg,
                       rows * n_c + cols * n_g)
    return torch.stack([rows * n_c, both, cols * n_g])


class BwdUnit(NamedTuple):
    """One CTA of ``wide_f32``'s backward grid that does work."""
    kind: str     # "zeros" (an item with no live pair), "whole", "slice"
    job: int
    own: int      # the item's 128-row own tile
    lo: int       # the rank of its first live streamed tile in the item's
    count: int    # live streamed tiles, in order
    slot: int     # slices: the workspace block it writes, else -1
    cut: int      # slices: the cut item's index (its ticket), else -1
    slices: int   # slices: the item's slices, merged in slot order, else 0


def bwd_workspace(slots: int, d: int) -> tuple:
    """The shape of ``wide_f32``'s backward workspace for ``slots``
    resident CTAs and width d: one (OWN_ROWS, d rounded up to 16) float32
    block a slot."""
    return slots, OWN_ROWS, -(-d // 16) * 16


def bwd_plan(flags: torch.Tensor, slots: int) -> List[BwdUnit]:
    """The working units of ``wide_f32``'s backward for ``live_tiles``'
    flags on a card that holds ``slots`` CTAs at once, in the order the
    grid dispatches them, as csrc/flashnce.cu's ``bwd_f32`` reads them
    from the flags: the items with no live pair (zeros), then, of the L
    items with one, the first L - r (r = L mod slots) whole, then the last
    r cut into ``slots`` units (slots // r each, one more for the first
    slots % r), each unit a contiguous run of the item's live streamed
    tiles; an item with fewer live tiles than units takes that many
    slices, and its other units exit (left out here)."""
    pairs = bwd_item_pairs(flags).flatten().tolist()
    owns = len(pairs) // JOBS
    live = [i for i, p in enumerate(pairs) if p]
    units = [BwdUnit("zeros", i // owns, i % owns, 0, 0, -1, -1, 0)
             for i, p in enumerate(pairs) if not p]
    cut = len(live) % slots
    whole = len(live) - cut
    units += [BwdUnit("whole", i // owns, i % owns, 0, pairs[i], -1, -1, 0)
              for i in live[:whole]]
    if cut:
        per, extra = divmod(slots, cut)
        first = 0
        for j, i in enumerate(live[whole:]):
            span = per + (j < extra)
            k = min(span, pairs[i])
            for p in range(k):
                lo = pairs[i] * p // k
                units.append(BwdUnit("slice", i // owns, i % owns, lo,
                                     pairs[i] * (p + 1) // k - lo, first + p,
                                     j, k))
            first += span
    return units


def attributes(backward: bool, design: str) -> dict:
    """What the compiler made of one kernel (cudaFuncGetAttributes):
    registers and local (spill) bytes a thread, static shared bytes, the
    most threads a CTA."""
    out = (ctypes.c_int * 4)()
    check_launch(LIBRARY.lib().flashnce_attributes(
        int(backward), list(DESIGNS).index(design), out),
        f"{NAME} attributes")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "max_threads"), out))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(an, bn, col):
    if an.dim() != 2 or bn.shape != an.shape or col.shape != an.shape[:1]:
        raise ValueError(f"{NAME}: want an, bn (N, d) and col (N,), got "
                         f"{tuple(an.shape)}, {tuple(bn.shape)}, "
                         f"{tuple(col.shape)}")
    if an.dtype not in (torch.float32, torch.bfloat16) \
            or bn.dtype != an.dtype:
        raise TypeError(f"{NAME}: an and bn must share float32 or bfloat16, "
                        f"got {an.dtype} and {bn.dtype}")
    if col.dtype != torch.float32:
        raise TypeError(f"{NAME}: col must be float32, got {col.dtype}")
    if len({an.device, bn.device, col.device}) != 1:
        raise ValueError(f"{NAME}: inputs on {an.device}, {bn.device}, "
                         f"{col.device}")


def _check_flags(what: str, flags, col):
    """Live flags given by the caller: (2, ceil(N / TILE)) bool or uint8,
    contiguous, on col's device."""
    want = (2, -(-col.shape[0] // TILE))
    if tuple(flags.shape) != want or flags.dtype not in (torch.bool,
                                                         torch.uint8) \
            or not flags.is_contiguous():
        raise ValueError(f"{what}: flags must be a contiguous {want} bool "
                         f"or uint8 tensor, got {tuple(flags.shape)} "
                         f"{flags.dtype}")
    if flags.device != col.device:
        raise ValueError(f"{what}: flags on {flags.device}, inputs on "
                         f"{col.device}")


def _check_cuda(what: str, *tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the {what} kernel runs on CUDA tensors, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} kernel: inputs must be contiguous")
    if tensors[0].shape[1] > MAX_D:
        raise ValueError(f"{what} kernel: d = {tensors[0].shape[1]} > "
                         f"{MAX_D}")


def _design(what: str, an, bn) -> str:
    dtype = an.dtype
    design = flash_design(dtype, an.shape[1], an.data_ptr(), bn.data_ptr())
    if DESIGNS[design] != dtype:
        raise TypeError(f"{what}: design {design} takes {DESIGNS[design]}, "
                        f"got {dtype}")
    return design


class _Wrapper:
    """``launches`` goes up by one for each kernel launch and nowhere else;
    ``by_design`` counts the same launches by design."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self):
        self.launches = 0
        self.by_design = dict.fromkeys(DESIGNS, 0)

    def _counted(self, err: int, design: str):
        check_launch(err, self.name)
        self.launches += 1
        self.by_design[design] += 1


class FlashForward(_Wrapper):
    """The forward kernel's wrapper: (N,) float32 denominators. ``flags``
    (``live_tiles(col)``) is computed here, for the designs that skip,
    unless the caller passes it."""

    _splits = {}  # (device, N, design) -> the forward's slices

    def splits(self, n: int, device, design: str) -> int:
        """The slices the forward of ``design`` (one of SLICING) cuts each
        row tile's live column tiles into at N = n on ``device`` (a CUDA
        device)."""
        key = (torch.device(device), n, design)
        if key not in self._splits:
            with torch.cuda.device(key[0]):
                splits = LIBRARY.lib().flashnce_fwd_splits(
                    list(DESIGNS).index(design), n)
            if splits < 1:
                raise RuntimeError(f"{self.name}: no occupancy for "
                                   f"{design}")
            self._splits[key] = splits
        return self._splits[key]

    def __call__(self, an, bn, col, tau: float, flags=None) -> torch.Tensor:
        _check(an, bn, col)
        if flags is not None:
            _check_flags(self.name, flags, col)
        _check_cuda(self.name, an, bn, col)
        n, d = an.shape
        den = torch.empty(n, dtype=torch.float32, device=an.device)
        if n == 0:
            return den
        design = _design(self.name, an, bn)
        lib = LIBRARY.lib()
        with torch.cuda.device(an.device):
            if flags is None and design in SKIPPING:
                flags = live_tiles(col)
            splits, part_s, part_m, tickets = 1, None, None, None
            if design in SLICING:
                splits = self.splits(n, an.device, design)
            if splits > 1:
                tiles = -(-n // OWN_ROWS)
                part_s = torch.empty(splits, tiles * OWN_ROWS,
                                     dtype=torch.float64, device=an.device)
                part_m = torch.empty(splits, tiles * OWN_ROWS,
                                     dtype=torch.float32, device=an.device)
                tickets = torch.zeros(tiles, dtype=torch.int32,
                                      device=an.device)
            err = lib.flashnce_fwd(
                list(DESIGNS).index(design), an.data_ptr(), bn.data_ptr(),
                col.data_ptr(), _ptr(flags), den.data_ptr(),
                *map(_ptr, (part_s, part_m, tickets)),
                splits, n, d, float(tau), stream_of(an))
        self._counted(err, design)
        return den


class FlashBackward(_Wrapper):
    """The backward kernel's wrapper: (d_an, d_bn) in an's type from the
    saved denominators and their cotangent ``g``; one launch runs three
    jobs. ``flags`` (``live_tiles(col, g)``) is computed here, for the
    designs that skip, unless the caller passes it. A balanced backward
    adds TALLY's three counts to an int64 tensor on its device
    (``tallies``), read only by ``tally()``."""

    _slots = {}  # (device, design) -> CTAs resident at once

    def __init__(self, name: str):
        super().__init__(name)
        self.tallies = {}  # device -> int64 (len(TALLY),)

    def slots(self, device, design: str) -> int:
        """The CTAs of ``design`` (one of BALANCED) the card ``device``
        holds at once: the wave its backward fills, and its workspace's
        blocks."""
        key = (torch.device(device), design)
        if key not in self._slots:
            with torch.cuda.device(key[0]):
                slots = LIBRARY.lib().flashnce_bwd_slots(
                    list(DESIGNS).index(design))
            if slots < 1:
                raise RuntimeError(f"{self.name}: no occupancy for "
                                   f"{design}")
            self._slots[key] = slots
        return self._slots[key]

    def tally(self) -> dict:
        """TALLY's counts summed over the devices since the last
        ``clear_tally`` (a read of the device, which synchronises); {}
        before any balanced launch."""
        per_device = (t.tolist() for t in self.tallies.values())
        return dict(zip(TALLY, map(sum, zip(*per_device))))

    def clear_tally(self):
        """Zero the tallies, in stream order on their devices."""
        for t in self.tallies.values():
            t.zero_()

    def __call__(self, an, bn, col, den, g, tau: float, flags=None):
        _check(an, bn, col)
        if flags is not None:
            _check_flags(self.name, flags, col)
        _check_cuda(self.name, an, bn, col, den, g)
        if den.dtype != torch.float32 or g.dtype != torch.float32 \
                or den.shape != col.shape or g.shape != col.shape:
            raise TypeError(f"{self.name}: den and g must be float32 (N,)")
        n, d = an.shape
        if n == 0:
            return an.new_zeros(an.shape), bn.new_zeros(bn.shape)
        design = _design(self.name, an, bn)
        n_pad, d_pad = -(-n // TILE) * TILE, -(-d // 16) * 16
        out = torch.empty(JOBS, n_pad, d_pad, dtype=torch.float32,
                          device=an.device)
        lib = LIBRARY.lib()
        with torch.cuda.device(an.device):
            if flags is None and design in SKIPPING:
                flags = live_tiles(col, g)
            slots, part, tickets, tally = 0, None, None, None
            if design in BALANCED:
                # the workspace comes from the caching allocator each call
                # (the same block step after step), in stream order
                slots = self.slots(an.device, design)
                part = torch.empty(bwd_workspace(slots, d),
                                   dtype=torch.float32, device=an.device)
                tickets = torch.zeros(slots, dtype=torch.int32,
                                      device=an.device)
                tally = self.tallies.get(an.device)
                if tally is None:
                    tally = self.tallies[an.device] = torch.zeros(
                        len(TALLY), dtype=torch.int64, device=an.device)
            err = lib.flashnce_bwd(
                list(DESIGNS).index(design), an.data_ptr(), bn.data_ptr(),
                col.data_ptr(), den.data_ptr(), g.data_ptr(),
                _ptr(flags), out.data_ptr(),
                *map(_ptr, (part, tickets, tally)), slots, n, d,
                float(tau), stream_of(an))
        self._counted(err, design)
        out = out[:, :n, :d]
        return (out[0] + out[1]).to(an.dtype), out[2].to(bn.dtype)


FORWARD = FlashForward(NAME)
BACKWARD = FlashBackward(NAME + "_bwd")
KERNELS = {k.name: k for k in (FORWARD, BACKWARD)}


# -- the plain version --------------------------------------------------------

def _tile_logits(a, bn, an, col, tau: float, r0: int):
    """The (rows, N) inter and intra logit tiles of rows [r0, r0 + len(a)),
    as the reference's ``_flash_fwd`` forms them."""
    inter = ((a @ bn.T) / tau).float() + col[None, :]
    intra = ((a @ an.T) / tau).float()
    rows = torch.arange(r0, r0 + a.shape[0], device=a.device)
    cols = torch.arange(an.shape[0], device=a.device)
    eye = rows[:, None] == cols[None, :]
    intra = torch.where(eye, NEG, intra + col[None, :])
    return inter, intra


def denominators_plain(an, bn, col, tau: float,
                       block: int = PLAIN_BLOCK) -> torch.Tensor:
    """(N,) float32 denominators over (block, N) row tiles (the last tile
    may be ragged)."""
    parts = []
    for r0 in range(0, an.shape[0], block):
        inter, intra = _tile_logits(an[r0:r0 + block], bn, an, col, tau, r0)
        parts.append(torch.logaddexp(torch.logsumexp(inter, 1),
                                     torch.logsumexp(intra, 1)))
    return torch.cat(parts) if parts else col.new_zeros(0)


def denominator_grads_plain(an, bn, col, den, g, tau: float,
                            block: int = PLAIN_BLOCK):
    """(d_an, d_bn) of ``Σ g·den``, rebuilding each row tile's logits, as
    the reference's ``_flash_vjp_bwd`` with a zero positive cotangent."""
    n, d = an.shape
    d_rows = []
    d_an_cols = torch.zeros(n, d, dtype=torch.float32, device=an.device)
    d_bn_cols = torch.zeros_like(d_an_cols)
    for r0 in range(0, n, block):
        a = an[r0:r0 + block]
        inter, intra = _tile_logits(a, bn, an, col, tau, r0)
        gd, dn = g[r0:r0 + block, None], den[r0:r0 + block, None]
        gi = (gd * torch.exp(inter - dn)).to(an.dtype)
        gt = (gd * torch.exp(intra - dn)).to(an.dtype)
        d_rows.append((gi @ bn + gt @ an) / tau)
        d_bn_cols += (gi.T @ a).float() / tau
        d_an_cols += (gt.T @ a).float() / tau
    d_an = torch.cat(d_rows).float() + d_an_cols
    return d_an.to(an.dtype), d_bn_cols.to(bn.dtype)


class _FlashDenom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, an, bn, col, tau, block, plain):
        _check(an, bn, col)
        ctx.plain = plain or an.device.type == "cpu"
        if ctx.plain:
            den = denominators_plain(an, bn, col, tau, block)
        else:
            den = FORWARD(an.contiguous(), bn.contiguous(), col.contiguous(),
                          tau)
        ctx.save_for_backward(an, bn, col, den)
        ctx.tau, ctx.block = tau, block
        return den

    @staticmethod
    def backward(ctx, g):
        an, bn, col, den = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.plain:
            d_an, d_bn = denominator_grads_plain(an, bn, col, den, g,
                                                 ctx.tau, ctx.block)
        else:
            d_an, d_bn = BACKWARD(an.contiguous(), bn.contiguous(),
                                  col.contiguous(), den, g, ctx.tau)
        return d_an, d_bn, None, None, None, None


def flash_denom(an: torch.Tensor, bn: torch.Tensor, col: torch.Tensor,
                tau: float, block: int = PLAIN_BLOCK) -> torch.Tensor:
    """(N,) float32 InfoNCE log-denominators, differentiable in ``an`` and
    ``bn``: the CUDA kernels on a CUDA tensor, the plain version over
    ``block``-row tiles on a CPU tensor."""
    return _FlashDenom.apply(an, bn, col, tau, block, False)


def flash_denom_plain(an: torch.Tensor, bn: torch.Tensor, col: torch.Tensor,
                      tau: float, block: int = PLAIN_BLOCK) -> torch.Tensor:
    """The plain version, on any device (``chip_smoke.py`` runs it on the
    card beside the kernels)."""
    return _FlashDenom.apply(an, bn, col, tau, block, True)
