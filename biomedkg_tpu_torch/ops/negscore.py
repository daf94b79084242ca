"""Fused negative scoring for the four KGE decoders, forward and backward.

For slot i with h = z[ns[i]], t = z[nd[i]] and the relation row
r = table[rel[i]], the score is Σ over features of

* "distmult": h·r·t;
* "complex":  r_re·(h_re t_re + h_im t_im) + r_im·(h_re t_im − h_im t_re),
  on the re/im halves of width d/2;
* "transe":   −|h + r − t|, on z rows normalised to unit L1 norm first;
* "rotate":   −|h∘e^{iθ} − t| per complex pair, γ added by the decoder.

Counterpart of biomedkg_tpu/ops/pallas/negscore.py: the streamed family
``{mode}_neg_scores`` (``_fwd_call`` / ``_bwd_call``) and the dual-sorted
family ``{mode}_neg_scores_ds`` (``_fwd_call_ds`` / ``_bwd_call_ds``, for
the "sorted2" sampler whose ``nd`` lies in a narrow band per ``BLOCK``
slots). On CUDA tensors these launch the hand-written Hopper kernels of
``csrc/negscore.cu`` (built at first use by ops/_build.py), for any K·E
and N, for ``z`` in float32 or bfloat16, and any d (even for the paired
modes "complex" and "rotate"); on CPU tensors they run
``{mode}_neg_scores_plain``, which the tests and ``chip_smoke.py`` hold the
kernels against. The two families compute the same function, so they share
the plain version. A CUDA tensor never falls back: the kernels build and
launch, or the call raises.

As the reference's kernels compute it: ``ns`` ascending (any order is
exact, only slower), ``nd`` any order, ns, nd and rel clipped into range.
The relation table is rounded to z's type and everything else is float32;
the scores are float32. RotatE's table is ``[cos θ | sin θ]`` (R, d) from
the float32 phases θ (R, d/2), and its gradient comes back as dθ. TransE's
L1 normalisation is plain torch around the kernels (z to float32, each row
divided by max(Σ|row|, 1e-12), back to z's type), so autograd carries its
gradient, as XLA does in the reference. The backward returns ``dz`` in z's
type and the relation gradient in rel_emb's. Under a dp × tp step z holds
the rank's columns and ``group`` is the tp group: TransE's row norms are
then the group's sums of the ranks' parts, and each rank's scores are its
columns' part (the decoders sum them over the group).

The forward runs in the design ``negscore_fwd_design`` names: "run" for
both families. A warp walks a contiguous run of slots, holds its share of
the current src row in registers (reloaded only where ns changes), reads
the relation row from a float32 table in shared memory, gathers the
slot's t from z (in L2), and sums eight slots' partials at once (a
transpose reduction over the lanes). It takes ns and nd in any order, so
the dual-sorted family's sorted2 inputs need no design of their own.
``lane_scores_plain`` is its plain version in the kernel's order of sums. The first design (``fwd_kernel`` /
``ds_fwd_kernel``: both rows gathered every slot, one warp-shuffle sum a
slot) stays for the A/B on the card; only a caller that replaces
``negscore_fwd_design`` reaches it.

The backward runs in the design ``negscore_design`` names: "owner" for
every call the kernels take, both families. ``BUCKETS`` (one cooperative
launch) sorts the slot ids stably by clipped ns and by clipped nd into
buckets; the owner kernel then gives each node id a group of four warps,
which walk its src bucket and its dst bucket, sum its row's gradient in
registers and write dz's row once, in z's type (no atomics on dz); the
relation gradient is summed in the src walk, per warp and then per block,
into a zeroed buffer. A call makes three device launches: one zero fill (the
relation gradient and the bucket build's barrier), the bucket build, the
owner kernel. ``buckets_plain`` and ``owner_grads_plain`` are their plain
versions, the latter summing ``unit_grads`` in the owner's order. The
first design (``bwd_kernel`` / ``ds_bwd_kernel``: float32 atomics on dz,
two zero fills and a cast around it) stays for the A/B on the card; only
a caller that replaces ``negscore_design`` reaches it.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.collectives import psum_shared
from ._build import CudaLibrary, check_launch, stream_of
from .segment import take_rows

BLOCK = 2048            # slots per chunk of the "sorted2" sampler and the
                        # dual-sorted kernels (the reference's negscore.BLOCK)
MODES = ("distmult", "complex", "transe", "rotate")
PAIRED = ("complex", "rotate")       # features j and j + d/2 form a pair

_P = ctypes.c_void_p
_I = ctypes.c_int
# mode, z, ns, nd, rel, re, out, m, n, d, r, [vec | chunk], stream
_FWD = [_I, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P]
_RUN = _FWD[:-2] + [_P]
# mode, z, ns, nd, rel, re, ds, dz, dre, m, n, d, r, [chunk], stream
_BWD = [_I, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
        _P]
_BWD_DS = _BWD[:-1] + [_I, _P]
# mode, z, ns, nd, rel, re, ds, off, ord, dz, dre, m, n, d, r, stream
_OWNER = [_I] + [_P] * 10 + [ctypes.c_longlong, _I, _I, _I, _P]
# ns, nd, m, n, blocks, blk, tot, off, ord, bar, stream
_BUCKETS = [_P, _P, ctypes.c_longlong, _I, _I, _P, _P, _P, _P, _P, _P]
LIBRARY = CudaLibrary("negscore.cu", {
    **{f"negscore_{fam}fwd_{t}": _FWD
       for fam in ("", "ds_") for t in ("f32", "bf16")},
    **{f"negscore_run_fwd_{t}": _RUN for t in ("f32", "bf16")},
    **{f"negscore_bwd_{t}": _BWD for t in ("f32", "bf16")},
    **{f"negscore_ds_bwd_{t}": _BWD_DS for t in ("f32", "bf16")},
    **{f"negscore_owner_bwd_{t}": _OWNER for t in ("f32", "bf16")},
    "negscore_buckets": _BUCKETS})
# the backward's designs: the first (atomics on dz) and the node-owned one
DESIGNS = ("first", "owner")
# the forward's: the first (both rows gathered a slot) and the redesign
FWD_DESIGNS = ("first", "run")
BUCKETS_NAME = "negscore_buckets"
BUCKET_THREADS = 256     # csrc/negscore.cu kBucketThreads


def _takes(mode: str, dtype: torch.dtype, d: int):
    if mode not in MODES or dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"negscore: no kernel for mode {mode!r} in "
                         f"{dtype}")
    if mode in PAIRED and d % 2:
        raise ValueError(f"negscore: mode {mode!r} needs an even d, got {d}")


def negscore_design(mode: str, dual: bool, dtype: torch.dtype,
                    d: int) -> str:
    """The backward design a call on the card runs: "owner" for every
    mode, family, type and width the kernels take (an even d for the
    paired modes). A fixed rule: a failed build or launch raises, it never
    sends a call to the first design."""
    _takes(mode, dtype, d)
    return "owner"


def negscore_fwd_design(mode: str, dual: bool, dtype: torch.dtype,
                        d: int) -> str:
    """The forward design a call on the card runs: "run" for both families
    and every mode, type and width the kernels take. A fixed rule, as
    ``negscore_design``."""
    _takes(mode, dtype, d)
    return "run"


def fwd_lane_features(units: int) -> int:
    """The features a lane of the forward redesign takes at once from each
    half-row of ``units`` features (csrc/negscore.cu ``fwd_vector``, for a
    z whose base is 32-byte aligned): 8, else 4, where that divides the
    width and leaves the 32 lanes a pack each; else 1."""
    for v in (8, 4):
        if units % v == 0 and units // v >= 32:
            return v
    return 1


def kernel_name(mode: str, dual: bool) -> str:
    """The forward kernel's name; its backward's adds "_bwd"."""
    return f"{mode}_neg_scores{'_ds' if dual else ''}"


def _rel_width(mode: str, d: int) -> int:
    """Width of the relation parameter: d, or the d/2 phases of RotatE."""
    return d // 2 if mode == "rotate" else d


def _check(name, mode, z, ns, nd, rel, rel_emb, rel_width):
    m = ns.shape[0] if ns.dim() == 1 else -1
    if (z.dim() != 2 or rel_emb.dim() != 2 or ns.dim() != 1
            or nd.shape != (m,) or rel.shape != (m,)
            or rel_emb.shape[1] != rel_width):
        raise ValueError(
            f"{name}: want z (N, d), ns/nd/rel (M,), rel_emb (R, "
            f"{'d/2' if rel_width != z.shape[-1] else 'd'}); got "
            f"{tuple(z.shape)}, {tuple(ns.shape)}, {tuple(nd.shape)}, "
            f"{tuple(rel.shape)}, {tuple(rel_emb.shape)}")
    if mode in PAIRED and z.shape[1] % 2:
        raise ValueError(f"{name}: mode {mode!r} pairs features j and "
                         f"j + d/2 and needs an even d, got {z.shape[1]}")
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: z must be float32 or bfloat16, got "
                        f"{z.dtype}")
    if not rel_emb.is_floating_point():
        raise TypeError(f"{name}: rel_emb is {rel_emb.dtype}")
    for arg, ids in (("ns", ns), ("nd", nd), ("rel", rel)):
        if ids.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {ids.dtype}")
    devices = {t.device for t in (z, ns, nd, rel, rel_emb)}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on {devices}")
    if (z.shape[0] == 0 or rel_emb.shape[0] == 0) and m > 0:
        raise ValueError(f"{name}: empty z or rel_emb table")


def _on_card(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the negscore kernels run on CUDA tensors, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError("negscore kernels: inputs must be contiguous")


class NegScoreForward:
    """One forward kernel's wrapper (a mode, streamed or dual-sorted):
    ``launches`` goes up by one for each kernel launch and nowhere else,
    ``by_design`` counts the same launches by design.

    ``re`` is the float32 relation table (R, d) from ``relation_table``;
    returns the (M,) float32 scores."""

    def __init__(self, mode: str, dual: bool):
        self.mode, self.dual = mode, dual
        self.name = kernel_name(mode, dual)
        self.reset()

    def reset(self):
        self.launches = 0
        self.by_design = dict.fromkeys(FWD_DESIGNS, 0)

    def __call__(self, z, ns, nd, rel, re) -> torch.Tensor:
        _check(self.name, self.mode, z, ns, nd, rel, re, z.shape[-1])
        _on_card(z, ns, nd, rel, re)
        if re.dtype != torch.float32:
            raise TypeError(f"{self.name} kernel: re must be float32, got "
                            f"{re.dtype}")
        (n, d), m, r = z.shape, ns.shape[0], re.shape[0]
        out = torch.empty(m, dtype=torch.float32, device=z.device)
        if m == 0:
            return out
        if d == 0:
            return out.zero_()
        design = negscore_fwd_design(self.mode, self.dual, z.dtype, d)
        kind = "f32" if z.dtype == torch.float32 else "bf16"
        if design == "run":
            fn, last = f"negscore_run_fwd_{kind}", []
        elif self.dual:
            fn, last = f"negscore_ds_fwd_{kind}", [BLOCK]
        else:   # 16-byte loads of each row's (half-)width
            units = d // 2 if self.mode in PAIRED else d
            fn, last = f"negscore_fwd_{kind}", [int(
                units % (16 // z.element_size()) == 0
                and z.data_ptr() % 16 == 0)]
        with torch.cuda.device(z.device):
            err = getattr(LIBRARY.lib(), fn)(
                MODES.index(self.mode), z.data_ptr(), ns.data_ptr(),
                nd.data_ptr(), rel.data_ptr(), re.data_ptr(), out.data_ptr(),
                m, n, d, r, *last, stream_of(z))
        check_launch(err, f"{self.name} forward [{design}]")
        self.launches += 1
        self.by_design[design] += 1
        return out


def bucket_blocks(m: int, device) -> int:
    """The bucket build's blocks for m slots: one a multiprocessor at most
    (the cooperative launch needs them all resident), none idle."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(sms, -(-m // BUCKET_THREADS)))


class BucketBuild:
    """The owner design's bucket build (``bucket_kernel``): ``launches``
    goes up by one for each launch and nowhere else. For (M,) int32 ns
    and nd and n ids, returns int32 ``offsets`` (2, n + 1) and ``order``
    (2, M): row 0 by clipped ns, row 1 by clipped nd, as
    ``buckets_plain``. ``barrier`` is one zeroed int32 (or float32) element
    on the same card; the wrapper makes one when it is None."""

    name = BUCKETS_NAME

    def __init__(self):
        self.launches = 0

    def __call__(self, ns, nd, n: int, barrier=None):
        _on_card(ns, nd)
        m = ns.shape[0] if ns.dim() == 1 else -1
        if ns.dtype != torch.int32 or nd.dtype != torch.int32 \
                or nd.shape != (m,):
            raise TypeError(f"{self.name}: ns and nd must be int32 (M,)")
        if n <= 0 or m >= 2 ** 31:
            raise ValueError(f"{self.name}: need n > 0 ids and fewer than "
                             f"2**31 slots, got n = {n}, M = {m}")
        blocks = bucket_blocks(max(m, 1), ns.device)
        ints = torch.empty(2 * blocks * n + 2 * n + 2 * (n + 1) + 2 * m,
                           dtype=torch.int32, device=ns.device)
        blk, tot, off, order = torch.split(
            ints, [2 * blocks * n, 2 * n, 2 * (n + 1), 2 * m])
        off, order = off.view(2, n + 1), order.view(2, m)
        if m == 0:
            return off.zero_(), order
        if barrier is None:
            barrier = torch.zeros(1, dtype=torch.int32, device=ns.device)
        with torch.cuda.device(ns.device):
            err = LIBRARY.lib().negscore_buckets(
                ns.data_ptr(), nd.data_ptr(), m, n, blocks, blk.data_ptr(),
                tot.data_ptr(), off.data_ptr(), order.data_ptr(),
                barrier.data_ptr(), stream_of(ns))
        check_launch(err, self.name)
        self.launches += 1
        return off, order


BUCKETS = BucketBuild()


class NegScoreBackward:
    """One backward kernel's wrapper: ``launches`` goes up by one for each
    backward kernel launch and nowhere else, ``by_design`` counts the same
    launches by design (the owner design's bucket build counts in
    ``BUCKETS``). Returns (dz (N, d), d(rel) (R, d), or dθ (R, d/2) for
    "rotate", float32) for the float32 upstream gradient ``ds`` (M,): dz in
    z's type from the owner design, in float32 from the first."""

    def __init__(self, mode: str, dual: bool):
        self.mode, self.dual = mode, dual
        self.name = kernel_name(mode, dual) + "_bwd"
        self.reset()

    def reset(self):
        self.launches = 0
        self.by_design = dict.fromkeys(DESIGNS, 0)

    def __call__(self, z, ns, nd, rel, re, ds):
        _check(self.name, self.mode, z, ns, nd, rel, re, z.shape[-1])
        _on_card(z, ns, nd, rel, re, ds)
        if re.dtype != torch.float32 or ds.dtype != torch.float32 \
                or ds.shape != ns.shape:
            raise TypeError(f"{self.name} kernel: re and ds must be "
                            f"float32, ds shaped like ns")
        (n, d), m, r = z.shape, ns.shape[0], re.shape[0]
        design = negscore_design(self.mode, self.dual, z.dtype, d)
        dr = _rel_width(self.mode, d)
        if design == "owner":
            return self._owner(z, ns, nd, rel, re, ds, n, d, m, r, dr)
        dz = torch.zeros(n, d, dtype=torch.float32, device=z.device)
        dre = torch.zeros(r, dr, dtype=torch.float32, device=z.device)
        if m == 0 or d == 0:
            return dz, dre
        kind = "f32" if z.dtype == torch.float32 else "bf16"
        fn = getattr(LIBRARY.lib(),
                     f"negscore_{'ds_' if self.dual else ''}bwd_{kind}")
        args = [MODES.index(self.mode), z.data_ptr(), ns.data_ptr(),
                nd.data_ptr(), rel.data_ptr(), re.data_ptr(), ds.data_ptr(),
                dz.data_ptr(), dre.data_ptr(), m, n, d, r]
        if self.dual:
            args.append(BLOCK)
        with torch.cuda.device(z.device):
            err = fn(*args, stream_of(z))
        self._counted(err, design)
        return dz, dre

    def _owner(self, z, ns, nd, rel, re, ds, n, d, m, r, dr):
        # one zero fill: the relation gradient, then (16 bytes on, so the
        # gradient's base stays 16-byte aligned for the vector atomics) the
        # bucket build's barrier counter
        scratch = torch.zeros(r * dr + 4, dtype=torch.float32,
                              device=z.device)
        dre = scratch[:r * dr].view(r, dr)
        if m == 0 or d == 0:
            return torch.zeros(n, d, dtype=z.dtype, device=z.device), dre
        off, order = BUCKETS(ns, nd, n, barrier=scratch[r * dr:])
        dz = torch.empty(n, d, dtype=z.dtype, device=z.device)
        kind = "f32" if z.dtype == torch.float32 else "bf16"
        with torch.cuda.device(z.device):
            err = getattr(LIBRARY.lib(), f"negscore_owner_bwd_{kind}")(
                MODES.index(self.mode), z.data_ptr(), ns.data_ptr(),
                nd.data_ptr(), rel.data_ptr(), re.data_ptr(), ds.data_ptr(),
                off.data_ptr(), order.data_ptr(), dz.data_ptr(),
                dre.data_ptr(), m, n, d, r, stream_of(z))
        self._counted(err, "owner")
        return dz, dre

    def _counted(self, err: int, design: str):
        check_launch(err, f"{self.name} [{design}]")
        self.launches += 1
        self.by_design[design] += 1


# one wrapper per (mode, family, direction), by the name chip_smoke reports
KERNELS = {k.name: k for mode in MODES for dual in (False, True)
           for k in (NegScoreForward(mode, dual),
                     NegScoreBackward(mode, dual))}


def relation_table(mode: str, rel_emb: torch.Tensor,
                   z_dtype) -> torch.Tensor:
    """The kernels' (R, d) relation table as float32, rounded to z's type:
    rel_emb, or RotatE's ``[cos θ | sin θ]`` of the float32 phases.
    Differentiable."""
    if mode == "rotate":
        theta = rel_emb.float()
        rel_emb = torch.cat([torch.cos(theta), torch.sin(theta)], dim=1)
    return rel_emb.to(z_dtype).float()


def l1_normalized(z: torch.Tensor, group=None) -> torch.Tensor:
    """TransE's table pass: each row of float32 z divided by
    max(Σ|row|, 1e-12), back in z's type (differentiable). With a tp
    ``group`` z holds the rank's columns and Σ|row| sums over the group."""
    zf = z.float()
    norm = psum_shared(zf.abs().sum(1, keepdim=True), group)
    return (zf / norm.clamp(min=1e-12)).to(z.dtype)


class _PairDistance(torch.autograd.Function):
    """RotatE's per-pair distance sqrt(max(u0² + u1², 1e-12)), whose
    gradient is u / that distance at every u, as the kernels and the
    reference's Pallas backward (``_distance_bwd``) take it. Autograd
    through the clamp would give 0 where |u| < 1e-6, so a pair whose
    rotated head nearly meets its tail (one draw in about 40 of the
    training step's 409,600 slots x 128 pairs holds one) would put up to
    its whole cotangent between this version and the kernels."""

    @staticmethod
    def forward(ctx, u0, u1):
        dist = torch.sqrt(torch.clamp(u0 * u0 + u1 * u1, min=1e-12))
        ctx.save_for_backward(u0, u1, dist)
        return dist

    @staticmethod
    def backward(ctx, g):
        u0, u1, dist = ctx.saved_tensors
        return g * u0 / dist, g * u1 / dist


def slot_terms(mode: str, h, t, r) -> torch.Tensor:
    """(M, d), or (M, d/2) for the paired modes: the per-feature terms
    whose row sum is each slot's score, in the kernels' arithmetic (float32
    h, t and relation rows r)."""
    if mode == "distmult":
        return h * r * t
    if mode == "transe":
        return -(h + r - t).abs()
    half = h.shape[1] // 2
    h0, h1, t0, t1 = h[:, :half], h[:, half:], t[:, :half], t[:, half:]
    r0, r1 = r[:, :half], r[:, half:]
    if mode == "complex":
        return r0 * (h0 * t0 + h1 * t1) + r1 * (h0 * t1 - h1 * t0)
    u0 = h0 * r0 - h1 * r1 - t0
    u1 = h0 * r1 + h1 * r0 - t1
    return -_PairDistance.apply(u0, u1)


def plain_scores(mode, z, ns, nd, rel, rel_emb) -> torch.Tensor:
    """The plain version of the kernels themselves: what they compute on z
    as given (for "transe", z already L1-normalised), differentiated by
    autograd. DistMult's keeps the reference's unfused form, whose h·t
    products round to z's type."""
    n, r = z.shape[0], rel_emb.shape[0]
    h = take_rows(z, ns.long().clamp(0, n - 1))
    t = take_rows(z, nd.long().clamp(0, n - 1))
    table = relation_table(mode, rel_emb, z.dtype)
    rel = rel.long().clamp(0, r - 1)
    if mode == "distmult":
        # the reference's unfused path: h·t in z's type, projected against
        # all R relations with float32 sums, the slot's column selected
        all_rel = (h * t).float() @ table.T
        onehot = rel[:, None] == torch.arange(r, device=z.device)
        return torch.where(onehot, all_rel, 0.0).sum(1)
    return slot_terms(mode, h.float(), t.float(), take_rows(table, rel)).sum(1)


def lane_scores_plain(mode, z, ns, nd, rel, re, terms=None):
    """The forward redesign's plain version: the (M,) float32 scores as
    the kernels sum them. Each slot's units (features, or pairs for the
    paired modes) go in packs of ``fwd_lane_features(units)`` to the 32
    lanes, 32 packs a pass; a lane adds its pack's unit terms in order;
    the lanes' partials are summed as a tree (lanes l and l + 16, then
    halving over 16, 8, 4, 2); a later pass's tree sum is added to the
    earlier ones'. ``re`` is the float32 (R, d) table; ``terms`` (M,
    units) replaces ``slot_terms``'s, for a caller that computes them
    otherwise."""
    (n, d), r = z.shape, re.shape[0]
    if terms is None:
        terms = slot_terms(mode, z[ns.long().clamp(0, n - 1)].float(),
                           z[nd.long().clamp(0, n - 1)].float(),
                           re[rel.long().clamp(0, r - 1)].float())
    m, units = terms.shape
    v = fwd_lane_features(units)
    packs = units // v
    lanes = -(-packs // 32) * 32
    by_pack = torch.zeros(m, lanes * v, dtype=torch.float32,
                          device=terms.device)
    by_pack[:, :units] = terms.float()
    by_pack = by_pack.view(m, lanes, v)
    partial = by_pack[:, :, 0]
    for k in range(1, v):
        partial = partial + by_pack[:, :, k]
    out = None
    for p0 in range(0, lanes, 32):
        x = partial[:, p0:p0 + 32]
        while x.shape[1] > 1:
            half = x.shape[1] // 2
            x = x[:, :half] + x[:, half:]
        out = x[:, 0] if out is None else out + x[:, 0]
    return out


def buckets_plain(ns, nd, n: int):
    """The bucket build's plain version: ``offsets`` (2, n + 1) int32, each
    id's first position in its side's order (the exclusive prefix of its
    bincount, then M), and ``order`` (2, M) int32, the slot ids stably
    sorted by clipped ns (row 0) and clipped nd (row 1)."""
    offsets, order = [], []
    for ids in (ns, nd):
        keys = ids.long().clamp(0, n - 1)
        counts = torch.bincount(keys, minlength=n)
        offsets.append(torch.cat([counts.new_zeros(1), counts.cumsum(0)]))
        order.append(torch.argsort(keys, stable=True))
    return (torch.stack(offsets).int(), torch.stack(order).int())


def unit_grads(mode: str, h, t, r, g):
    """Each slot's unit gradients, as the kernels compute them: (dh (M, d),
    dt (M, d), the relation row's gradient (M, d), or dθ (M, d/2) for
    "rotate") of the float32 rows h, t, r and the upstream gradient g
    (M,). RotatE's follows the reference's ``_distance_bwd`` (du =
    −g·u / max(|u|, 1e-6))."""
    g = g[:, None]
    if mode == "distmult":
        gr = g * r
        return gr * t, gr * h, g * h * t
    if mode == "transe":
        gs = g * torch.sign(h + r - t)
        return -gs, gs, -gs
    half = h.shape[1] // 2
    h0, h1, t0, t1 = h[:, :half], h[:, half:], t[:, :half], t[:, half:]
    r0, r1 = r[:, :half], r[:, half:]
    if mode == "complex":
        return (torch.cat([g * (r0 * t0 + r1 * t1),
                           g * (r0 * t1 - r1 * t0)], 1),
                torch.cat([g * (r0 * h0 - r1 * h1),
                           g * (r0 * h1 + r1 * h0)], 1),
                torch.cat([g * (h0 * t0 + h1 * t1),
                           g * (h0 * t1 - h1 * t0)], 1))
    rot0, rot1 = h0 * r0 - h1 * r1, h0 * r1 + h1 * r0
    u0, u1 = rot0 - t0, rot1 - t1
    dist = torch.sqrt(torch.clamp(u0 * u0 + u1 * u1, min=1e-12))
    du0, du1 = -g * u0 / dist, -g * u1 / dist
    return (torch.cat([du0 * r0 + du1 * r1, -du0 * r1 + du1 * r0], 1),
            torch.cat([-du0, -du1], 1), -du0 * rot1 + du1 * rot0)


def owner_grads_plain(mode, z, ns, nd, rel, re, ds, terms=None):
    """The owner design's plain version: float32 (dz (N, d), the relation
    gradient (R, dr)) as per-bucket sums in the owner's order: each id's
    row is its src bucket's dh terms, then its dst bucket's dt terms, in
    bucket order; the relation gradient sums the slots in src-bucket order.
    ``re`` is the float32 (R, d) table; ``terms`` (dh, dt, dr per slot)
    replaces ``unit_grads``'s, for a caller that computes them otherwise."""
    (n, d), r = z.shape, re.shape[0]
    ks, kd = ns.long().clamp(0, n - 1), nd.long().clamp(0, n - 1)
    rel = rel.long().clamp(0, r - 1)
    if terms is None:
        terms = unit_grads(mode, z[ks].float(), z[kd].float(), re[rel],
                           ds.float())
    dh, dt, dr = terms
    _, order = buckets_plain(ns, nd, n)
    src, dst = order[0].long(), order[1].long()
    dz = torch.zeros(n, d, dtype=torch.float32, device=z.device)
    dz.index_add_(0, ks[src], dh[src].float())
    dz.index_add_(0, kd[dst], dt[dst].float())
    dre = torch.zeros(r, dr.shape[1], dtype=torch.float32, device=z.device)
    dre.index_add_(0, rel[src], dr[src].float())
    return dz, dre


class _NegScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, ns, nd, rel, rel_emb, mode, dual):
        re = relation_table(mode, rel_emb.detach(), z.dtype).contiguous()
        ctx.save_for_backward(z, ns, nd, rel, re)
        ctx.rel_dtype = rel_emb.dtype
        ctx.name = kernel_name(mode, dual)
        return KERNELS[ctx.name](z, ns, nd, rel, re)

    @staticmethod
    def backward(ctx, ds):
        z, ns, nd, rel, re = ctx.saved_tensors
        dz, dre = KERNELS[ctx.name + "_bwd"](z, ns, nd, rel, re,
                                             ds.float().contiguous())
        return (dz.to(z.dtype), None, None, None, dre.to(ctx.rel_dtype),
                None, None)


def _make(mode: str, dual: bool, plain: bool):
    name = kernel_name(mode, dual) + ("_plain" if plain else "")

    def neg_scores(z, ns, nd, rel, rel_emb, group=None) -> torch.Tensor:
        _check(name, mode, z, ns, nd, rel, rel_emb,
               _rel_width(mode, z.shape[-1]))
        if mode == "transe":
            z = l1_normalized(z, group)
        if plain or z.device.type == "cpu":
            return plain_scores(mode, z, ns, nd, rel, rel_emb)
        return _NegScores.apply(z, ns, nd, rel, rel_emb, mode, dual)

    neg_scores.__name__ = neg_scores.__qualname__ = name
    neg_scores.__doc__ = (
        f"(M,) float32 {mode} negative scores (a tp ``group``: z's "
        "columns are the rank's)"
        + (": the plain torch version." if plain else
           f"; the {'dual-sorted' if dual else 'streamed'} kernels on CUDA "
           f"tensors, the plain version on CPU tensors."))
    return neg_scores


distmult_neg_scores_plain = _make("distmult", False, True)
complex_neg_scores_plain = _make("complex", False, True)
transe_neg_scores_plain = _make("transe", False, True)
rotate_neg_scores_plain = _make("rotate", False, True)

distmult_neg_scores = _make("distmult", False, False)
complex_neg_scores = _make("complex", False, False)
transe_neg_scores = _make("transe", False, False)
rotate_neg_scores = _make("rotate", False, False)

distmult_neg_scores_ds = _make("distmult", True, False)
complex_neg_scores_ds = _make("complex", True, False)
transe_neg_scores_ds = _make("transe", True, False)
rotate_neg_scores_ds = _make("rotate", True, False)
