"""Aggregate-then-transform RGCN convolution, the opt-in
``dst_bwd="agg"`` (counterpart of biomedkg_tpu/ops/aggconv.py).

The node-centric conv transforms every node under every relation and
gathers at ``rel·N + src``; its backward scatters (E, d) gradients at
unsorted keys. This conv reorders the factorisation:

  forward:   a[dst·R + rel] += norm · x[src]      (SpMM over the graph)
             out = Σ_r a[n, r] @ w_rel[r]
  backward:  dw = aᵀ · dout per relation;  da = dout · w_relᵀ
             dx[src] += norm · da[dst·R + rel]    (SpMM over the transpose)

Both SpMMs are sorted segment-sums (ops/segsum.py: the CUDA kernel on a
CUDA tensor): the forward over the (dst, rel)-sorted primary edge order
into N·R rows, the backward over the batch's src-sorted copy
(``GraphBatch.src_edges``) into N rows. The gathers are plain row
gathers. ``norm`` is the masked 1/|N_r(dst)| of the node path, zero on
pads.

Rounding follows the JAX package: the SpMMs sum in float32; ``a``, the
output and ``da`` are rounded to x's type, ``dw`` to w_rel's, and the
products accumulate in float32 (cuBLAS).
"""

from __future__ import annotations

import torch

from .segsum import sorted_segment_sum


class _AggConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w_rel, src, key, norm, s2, key2, norm2):
        n, r = x.shape[0], w_rel.shape[0]
        msg = x.index_select(0, src) * norm[:, None].to(x.dtype)
        a = sorted_segment_sum(msg, key, n * r).to(x.dtype)
        ctx.save_for_backward(w_rel, a, s2, key2, norm2)
        ctx.num_nodes = n
        return (a.reshape(n, -1) @ w_rel.reshape(-1, w_rel.shape[-1])
                ).to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        w_rel, a, s2, key2, norm2 = ctx.saved_tensors
        n = ctx.num_nodes
        r, din, k = w_rel.shape
        dout = dout.to(a.dtype)
        dw = (a.reshape(n, r * din).T @ dout).reshape(r, din, k)
        da = (dout @ w_rel.reshape(r * din, k).T).to(a.dtype)
        dmsg2 = da.reshape(n * r, din).index_select(0, key2) \
            * norm2[:, None].to(a.dtype)
        dx = sorted_segment_sum(dmsg2, s2, n).to(a.dtype)
        return dx, dw.to(w_rel.dtype), None, None, None, None, None, None


def agg_conv(x: torch.Tensor, w_rel: torch.Tensor, src: torch.Tensor,
             key: torch.Tensor, norm: torch.Tensor, s2: torch.Tensor,
             key2: torch.Tensor, norm2: torch.Tensor) -> torch.Tensor:
    """out[n] = Σ_r W_r · (Σ_{e: dst=n, rel=r} norm_e · x[src_e]).

    x: (N, din); w_rel: (R, din, dout); src: (E,) primary-order sources;
    key: (E,) int32 ascending dst·R + rel (pads repeat the last real key,
    norm 0 there); norm: (E,) masked mean normalisation. The src-sorted
    copy: s2 (E,) int32 ascending sources, key2 (E,) its dst·R + rel (any
    order), norm2 its masked norms.
    """
    return _AggConv.apply(x, w_rel, src, key, norm, s2, key2, norm2)
