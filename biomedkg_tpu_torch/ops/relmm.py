"""Relation-blocked grouped GEMM: ``out[e] = msg[e] @ W[block_rel[e // B]]``.

Counterpart of biomedkg_tpu/ops/pallas/relmm.py::relation_matmul_sorted.
The edges come relation-sorted with every B-row block single-relation
(the "relation" batch layout, sampling/batch.py); ``block_rel`` names each
block's relation, and the block size is the batch's own
(``E // len(block_rel)``). On a CUDA tensor the product runs on the
hand-written Hopper kernel of ``csrc/relmm.cu`` (built at first use by
ops/_build.py); on a CPU tensor it runs ``relation_matmul_sorted_plain``,
the plain torch version the tests and ``chip_smoke.py`` hold the kernel
against. A CUDA tensor never falls back: the kernel builds and launches, or
the call raises. This is also the port's whole counterpart of
biomedkg_tpu/ops/relmatmul.py::relation_matmul, whose per-edge scan over
``edge_type`` (its route for batches without ``block_rel``) is not kept: a
call without ``block_rel`` raises.

The backward is the reference's ``_relmm_bwd``: ``d_msg = g @ W[r]ᵀ`` is
the same kernel reading W transposed (skipped when msg needs no gradient,
as the first conv's features do), and ``dW`` stays plain torch as JAX
leaves it to XLA: a float32 batched ``msg_bᵀ g_b`` over the (E/B, B, ·)
block views, summed into relations by a float32 ``index_add_``, cast to
W's type. Its transient is (E/B, din, dout) float32.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary, check_launch, stream_of

_P = ctypes.c_void_p
_I = ctypes.c_int
# x, w, block_rel, out, rows, k, n, num_rel, block_size, transpose, stream
_SIGNATURE = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _P]
LIBRARY = CudaLibrary("relmm.cu", {"relmm_f32": _SIGNATURE,
                                   "relmm_bf16": _SIGNATURE})
NAME = "relation_matmul_sorted"


def block_size_of(msg: torch.Tensor, block_rel: torch.Tensor) -> int:
    """The batch's block size ``E // len(block_rel)``, refusing a row count
    the blocks do not tile."""
    if block_rel is None:
        raise ValueError(f"{NAME} requires block_rel metadata "
                         "(relation-layout batches)")
    nb = block_rel.shape[0] if block_rel.dim() == 1 else 0
    if nb == 0 or msg.shape[0] % nb:
        raise ValueError(
            f"E_pad ({msg.shape[0]}) is not a multiple of the block count "
            f"({nb}) — block_rel does not describe this batch's edge layout")
    return msg.shape[0] // nb


def _check(msg, weights, block_rel, transpose):
    """The checks every route makes; returns (block size, output axis of
    weights)."""
    k_axis, n_axis = (2, 1) if transpose else (1, 2)
    block_size = block_size_of(msg, block_rel)
    if (msg.dim() != 2 or weights.dim() != 3
            or weights.shape[k_axis] != msg.shape[1]):
        raise ValueError(
            f"{NAME}: want msg (E, din), weights (R, "
            f"{'dout, din' if transpose else 'din, dout'}), block_rel "
            f"(E // B,); got {tuple(msg.shape)}, {tuple(weights.shape)}, "
            f"{tuple(block_rel.shape)}")
    if msg.dtype not in (torch.float32, torch.bfloat16) \
            or weights.dtype != msg.dtype:
        raise TypeError(f"{NAME}: msg and weights must share float32 or "
                        f"bfloat16, got {msg.dtype} and {weights.dtype}")
    if block_rel.dtype.is_floating_point:
        raise TypeError(f"{NAME}: block_rel is {block_rel.dtype}")
    if len({msg.device, weights.device, block_rel.device}) != 1:
        raise ValueError(f"{NAME}: inputs on {msg.device}, "
                         f"{weights.device}, {block_rel.device}")
    return block_size, n_axis


class RelmmKernel:
    """One direction's wrapper: the forward, or (``transpose``) d_msg, which
    reads weights (R, din, dout) as (R, dout, din). ``launches`` goes up by
    one for each kernel launch and nowhere else."""

    def __init__(self, transpose: bool):
        self.transpose = transpose
        self.name = NAME + ("_bwd" if transpose else "")
        self.launches = 0

    def __call__(self, msg: torch.Tensor, weights: torch.Tensor,
                 block_rel: torch.Tensor) -> torch.Tensor:
        block_size, n_axis = _check(msg, weights, block_rel, self.transpose)
        for t in (msg, weights, block_rel):
            if t.device.type != "cuda":
                raise ValueError(f"the {NAME} kernel runs on CUDA tensors, "
                                 f"got {t.device}")
        if not (msg.is_contiguous() and weights.is_contiguous()):
            raise ValueError(f"{self.name} kernel: msg and weights must be "
                             f"contiguous")
        block_rel = block_rel.to(torch.int32).contiguous()
        (rows, k), n = msg.shape, weights.shape[n_axis]
        out = torch.empty(rows, n, dtype=msg.dtype, device=msg.device)
        if rows == 0 or n == 0:
            return out
        lib = LIBRARY.lib()
        fn = lib.relmm_f32 if msg.dtype == torch.float32 else lib.relmm_bf16
        with torch.cuda.device(msg.device):
            err = fn(msg.data_ptr(), weights.data_ptr(),
                     block_rel.data_ptr(), out.data_ptr(), rows, k, n,
                     weights.shape[0], block_size, int(self.transpose),
                     stream_of(msg))
        check_launch(err, self.name)
        self.launches += 1
        return out


FORWARD = RelmmKernel(transpose=False)
BACKWARD = RelmmKernel(transpose=True)
KERNELS = {k.name: k for k in (FORWARD, BACKWARD)}


def relation_matmul_sorted_plain(msg: torch.Tensor, weights: torch.Tensor,
                                 block_rel: torch.Tensor) -> torch.Tensor:
    """The plain torch version: per relation, one float32 product over the
    rows of its blocks, cast back to msg's type (the reference's
    ``preferred_element_type=f32``); rows of a block whose relation is
    outside [0, R) stay zero. Never builds the per-block weights
    ``W[block_rel]``. Differentiable by autograd."""
    block_size = block_size_of(msg, block_rel)
    nb = msg.shape[0] // block_size
    blocks = msg.reshape(nb, block_size, msg.shape[1])
    out = msg.new_zeros(msg.shape[0], weights.shape[2], dtype=torch.float32)
    out_blocks = out.view(nb, block_size, -1)
    for r in range(weights.shape[0]):
        sel = torch.nonzero(block_rel == r).flatten()
        if sel.numel():
            prod = blocks.index_select(0, sel).float() @ weights[r].float()
            out_blocks.index_copy_(0, sel, prod)
    return out.to(msg.dtype)


def weight_grad(msg: torch.Tensor, g: torch.Tensor, block_rel: torch.Tensor,
                num_relations: int) -> torch.Tensor:
    """float32 (R, din, dout) ``dW[r] = Σ_{blocks b of r} msg_bᵀ g_b``."""
    nb = block_rel.shape[0]
    block_size = msg.shape[0] // nb
    per_block = torch.bmm(
        msg.reshape(nb, block_size, -1).transpose(1, 2).float(),
        g.reshape(nb, block_size, -1).float())
    out = per_block.new_zeros((num_relations,) + per_block.shape[1:])
    return out.index_add_(0, block_rel.long(), per_block)


def _product(msg, weights, block_rel, transpose: bool):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if msg.device.type == "cpu":
        _check(msg, weights, block_rel, transpose)
        w = weights.transpose(1, 2) if transpose else weights
        return relation_matmul_sorted_plain(msg, w, block_rel)
    return (BACKWARD if transpose else FORWARD)(msg, weights, block_rel)


class _RelationMatmulSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, msg, weights, block_rel):
        ctx.save_for_backward(msg, weights, block_rel)
        return _product(msg, weights, block_rel, False)

    @staticmethod
    def backward(ctx, g):
        msg, weights, block_rel = ctx.saved_tensors
        g = g.contiguous()
        d_msg = d_w = None
        if ctx.needs_input_grad[0]:
            d_msg = _product(g, weights, block_rel, True)
        if ctx.needs_input_grad[1]:
            d_w = weight_grad(msg, g, block_rel,
                              weights.shape[0]).to(weights.dtype)
        return d_msg, d_w, None


def relation_matmul_sorted(msg: torch.Tensor, weights: torch.Tensor,
                           block_rel: torch.Tensor) -> torch.Tensor:
    """``out[e] = msg[e] @ weights[block_rel[e // B]]`` → (E, dout) in
    msg's type, summed in float32. The block size B is the batch's own,
    ``E // len(block_rel)``.

    msg: (E, din) float32 or bfloat16, pad rows zero (so that dW stays
    exact); weights: (R, din, dout) in msg's type; block_rel: (E // B,)
    integer relation of each single-relation block of B rows.
    """
    return _RelationMatmulSorted.apply(msg, weights, block_rel)
