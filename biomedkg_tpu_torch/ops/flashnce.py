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
any N and any d up to 256. The backward follows the Pallas design's flash
split into a rows side and a columns side, so that no output element is
written by two CTAs: one launch runs three jobs, rows-inter,
columns-inter and intra (both sides at once: ``an_i·an_j`` is the logit at
(i, j) and at (j, i), and both cotangents multiply ``an_j`` into row i),
each rebuilding its logit tiles from the saved ``den``, without atomics,
deterministic; this wrapper sums them (``d_an`` = rows-inter + intra,
``d_bn`` = columns-inter). That is six N × N × d products, as many as the
other choice, one pass with float32 atomics for the columns side, which
would land every (tile, column) partial sum as an atomic: 1.1·10¹⁰ of them
at GRACE's N = 37,376, d = 256.

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

import torch

from ._build import CudaLibrary, check_launch, stream_of

NEG = torch.finfo(torch.float32).min
MAX_D = 256
TILE = 64          # the kernels' tile: rows per CTA and per streamed tile
JOBS = 3           # the backward's: rows-inter, intra, columns-inter
PLAIN_BLOCK = 1024  # rows per tile of the plain version by default

_P, _I = ctypes.c_void_p, ctypes.c_int
# an, bn, col, den, n, d, tau, stream
_FWD = [_P, _P, _P, _P, _I, _I, ctypes.c_float, _P]
# an, bn, col, den, g, out, n, d, tau, stream
_BWD = [_P, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P]
LIBRARY = CudaLibrary("flashnce.cu", {
    "flashnce_fwd_f32": _FWD, "flashnce_fwd_bf16": _FWD,
    "flashnce_bwd_f32": _BWD, "flashnce_bwd_bf16": _BWD})
NAME = "flash_denom"


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


class FlashForward:
    """The forward kernel's wrapper: (N,) float32 denominators.
    ``launches`` goes up by one for each kernel launch and nowhere else."""

    name = NAME

    def __init__(self):
        self.launches = 0

    def __call__(self, an, bn, col, tau: float) -> torch.Tensor:
        _check(an, bn, col)
        _check_cuda(self.name, an, bn, col)
        n, d = an.shape
        den = torch.empty(n, dtype=torch.float32, device=an.device)
        if n == 0:
            return den
        lib = LIBRARY.lib()
        fn = lib.flashnce_fwd_f32 if an.dtype == torch.float32 else \
            lib.flashnce_fwd_bf16
        with torch.cuda.device(an.device):
            err = fn(an.data_ptr(), bn.data_ptr(), col.data_ptr(),
                     den.data_ptr(), n, d, float(tau), stream_of(an))
        check_launch(err, self.name)
        self.launches += 1
        return den


class FlashBackward:
    """The backward kernel's wrapper: (d_an, d_bn) in an's type from the
    saved denominators and their cotangent ``g``. ``launches`` goes up by
    one for each kernel launch (three jobs) and nowhere else."""

    name = NAME + "_bwd"

    def __init__(self):
        self.launches = 0

    def __call__(self, an, bn, col, den, g, tau: float):
        _check(an, bn, col)
        _check_cuda(self.name, an, bn, col, den, g)
        if den.dtype != torch.float32 or g.dtype != torch.float32 \
                or den.shape != col.shape or g.shape != col.shape:
            raise TypeError(f"{self.name}: den and g must be float32 (N,)")
        n, d = an.shape
        if n == 0:
            return an.new_zeros(an.shape), bn.new_zeros(bn.shape)
        n_pad, d_pad = -(-n // TILE) * TILE, -(-d // 16) * 16
        out = torch.empty(JOBS, n_pad, d_pad, dtype=torch.float32,
                          device=an.device)
        lib = LIBRARY.lib()
        fn = lib.flashnce_bwd_f32 if an.dtype == torch.float32 else \
            lib.flashnce_bwd_bf16
        with torch.cuda.device(an.device):
            err = fn(an.data_ptr(), bn.data_ptr(), col.data_ptr(),
                     den.data_ptr(), g.data_ptr(), out.data_ptr(), n, d,
                     float(tau), stream_of(an))
        check_launch(err, self.name)
        self.launches += 1
        out = out[:, :n, :d]
        return (out[0] + out[1]).to(an.dtype), out[2].to(bn.dtype)


FORWARD = FlashForward()
BACKWARD = FlashBackward()
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
