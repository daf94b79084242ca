"""Fused DistMult negative scoring, forward and backward:
``s[i] = Σ_j z[ns[i], j] · rel_emb[rel[i], j] · z[nd[i], j]``.

Counterpart of biomedkg_tpu/ops/pallas/negscore.py in mode "distmult"
(``distmult_neg_scores``: ``_fwd_call`` / ``_bwd_call``). On CUDA tensors
``distmult_neg_scores`` launches the hand-written Hopper kernels of
``csrc/negscore.cu`` (built at first use by ops/_build.py), for any d, K·E
and N and for ``z`` in float32 or bfloat16; on CPU tensors it runs
``distmult_neg_scores_plain``, the reference's unfused path written in
torch, which the tests and ``chip_smoke.py`` hold the kernels against. A
CUDA tensor never falls back: the kernels build and launch, or the call
raises.

Contract, as in the reference: ``ns`` ascending (the stratified-sorted
sampler; any order is exact, only slower), ``nd`` any order, both clipped
into [0, N) as clip-mode gathers do. The relation rows are rounded to z's
type, products and sums are float32, and the scores are float32. The
backward returns ``dz`` in z's type and ``d(rel_emb)`` in rel_emb's.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary, check_launch, stream_of
from .segment import take_rows

_P = ctypes.c_void_p
_FWD = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
_BWD = [_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, _P]
LIBRARY = CudaLibrary("negscore.cu", {
    "negscore_fwd_f32": _FWD, "negscore_fwd_bf16": _FWD,
    "negscore_bwd_f32": _BWD, "negscore_bwd_bf16": _BWD})


def _check(z, ns, nd, rel, rel_emb):
    m = ns.shape[0] if ns.dim() == 1 else -1
    if (z.dim() != 2 or rel_emb.dim() != 2 or ns.dim() != 1
            or nd.shape != (m,) or rel.shape != (m,)
            or rel_emb.shape[1] != z.shape[1]):
        raise ValueError(
            f"distmult_neg_scores: want z (N, d), ns/nd/rel (M,), rel_emb "
            f"(R, d); got {tuple(z.shape)}, {tuple(ns.shape)}, "
            f"{tuple(nd.shape)}, {tuple(rel.shape)}, {tuple(rel_emb.shape)}")
    if z.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"distmult_neg_scores: z must be float32 or "
                        f"bfloat16, got {z.dtype}")
    if not rel_emb.is_floating_point():
        raise TypeError(f"distmult_neg_scores: rel_emb is {rel_emb.dtype}")
    for name, ids in (("ns", ns), ("nd", nd), ("rel", rel)):
        if ids.dtype != torch.int32:
            raise TypeError(f"distmult_neg_scores: {name} must be int32, "
                            f"got {ids.dtype}")
    devices = {t.device for t in (z, ns, nd, rel, rel_emb)}
    if len(devices) != 1:
        raise ValueError(f"distmult_neg_scores: inputs on {devices}")
    if (z.shape[0] == 0 or rel_emb.shape[0] == 0) and m > 0:
        raise ValueError("distmult_neg_scores: empty z or rel_emb table")


def _on_card(*tensors):
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"the negscore kernels run on CUDA tensors, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError("negscore kernels: inputs must be contiguous")


class NegScoreForward:
    """The forward kernel's wrapper: ``launches`` goes up by one for each
    kernel launch and nowhere else.

    ``re`` is the relation table as float32 (already rounded to z's
    type); returns the (M,) float32 scores."""

    def __init__(self):
        self.launches = 0

    def __call__(self, z, ns, nd, rel, re) -> torch.Tensor:
        _check(z, ns, nd, rel, re)
        _on_card(z, ns, nd, rel, re)
        if re.dtype != torch.float32:
            raise TypeError(f"negscore kernel: re must be float32, got "
                            f"{re.dtype}")
        (n, d), m, r = z.shape, ns.shape[0], re.shape[0]
        out = torch.empty(m, dtype=torch.float32, device=z.device)
        if m == 0:
            return out
        if d == 0:
            return out.zero_()
        lib = LIBRARY.lib()
        fn = (lib.negscore_fwd_f32 if z.dtype == torch.float32
              else lib.negscore_fwd_bf16)
        pack = 16 // z.element_size()
        vec = int(d % pack == 0 and z.data_ptr() % 16 == 0)
        with torch.cuda.device(z.device):
            err = fn(z.data_ptr(), ns.data_ptr(), nd.data_ptr(),
                     rel.data_ptr(), re.data_ptr(), out.data_ptr(), m, n, d,
                     r, vec, stream_of(z))
        check_launch(err, "negscore forward")
        self.launches += 1
        return out


class NegScoreBackward:
    """The backward kernel's wrapper: ``launches`` goes up by one for each
    kernel launch and nowhere else. Returns float32 (dz (N, d),
    dre (R, d)) for the float32 upstream gradient ``ds`` (M,)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, z, ns, nd, rel, re, ds):
        _check(z, ns, nd, rel, re)
        _on_card(z, ns, nd, rel, re, ds)
        if re.dtype != torch.float32 or ds.dtype != torch.float32 \
                or ds.shape != ns.shape:
            raise TypeError("negscore backward kernel: re and ds must be "
                            "float32, ds shaped like ns")
        (n, d), m, r = z.shape, ns.shape[0], re.shape[0]
        dz = torch.zeros(n, d, dtype=torch.float32, device=z.device)
        dre = torch.zeros(r, d, dtype=torch.float32, device=z.device)
        if m == 0 or d == 0:
            return dz, dre
        lib = LIBRARY.lib()
        fn = (lib.negscore_bwd_f32 if z.dtype == torch.float32
              else lib.negscore_bwd_bf16)
        with torch.cuda.device(z.device):
            err = fn(z.data_ptr(), ns.data_ptr(), nd.data_ptr(),
                     rel.data_ptr(), re.data_ptr(), ds.data_ptr(),
                     dz.data_ptr(), dre.data_ptr(), m, n, d, r,
                     stream_of(z))
        check_launch(err, "negscore backward")
        self.launches += 1
        return dz, dre


FORWARD = NegScoreForward()
BACKWARD = NegScoreBackward()


def relation_table(rel_emb: torch.Tensor, z_dtype) -> torch.Tensor:
    """The kernels' relation table: rel_emb rounded to z's type, as
    float32."""
    return rel_emb.detach().to(z_dtype).float().contiguous()


class _DistMultNegScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, ns, nd, rel, rel_emb):
        re = relation_table(rel_emb, z.dtype)
        ctx.save_for_backward(z, ns, nd, rel, re)
        ctx.rel_dtype = rel_emb.dtype
        return FORWARD(z, ns, nd, rel, re)

    @staticmethod
    def backward(ctx, ds):
        z, ns, nd, rel, re = ctx.saved_tensors
        dz, dre = BACKWARD(z, ns, nd, rel, re, ds.float().contiguous())
        return dz.to(z.dtype), None, None, None, dre.to(ctx.rel_dtype)


def distmult_neg_scores_plain(z, ns, nd, rel, rel_emb) -> torch.Tensor:
    """The reference's unfused path (biomedkg_tpu/models/decoders.py
    ``DistMult.score_neg_sorted``): gather both rows, ``h * t`` in z's
    type, project against all R relations with float32 sums, select the
    slot's column; differentiated by autograd."""
    _check(z, ns, nd, rel, rel_emb)
    n, r = z.shape[0], rel_emb.shape[0]
    h = take_rows(z, ns.long().clamp(0, n - 1))
    t = take_rows(z, nd.long().clamp(0, n - 1))
    all_rel = (h * t).float() @ rel_emb.to(z.dtype).float().T   # (M, R)
    onehot = (rel.long().clamp(0, r - 1)[:, None]
              == torch.arange(r, device=z.device))
    return torch.where(onehot, all_rel, 0.0).sum(1)


def distmult_neg_scores(z, ns, nd, rel, rel_emb) -> torch.Tensor:
    """(M,) float32 negative scores; the kernels on CUDA tensors, the plain
    version on CPU tensors (see the module docstring)."""
    if z.device.type == "cpu":
        return distmult_neg_scores_plain(z, ns, nd, rel, rel_emb)
    _check(z, ns, nd, rel, rel_emb)
    return _DistMultNegScores.apply(z, ns, nd, rel, rel_emb)
