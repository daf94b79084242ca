"""The yardstick of the RGAT + ComplEx cell: the relation-blocked grouped
GEMM's least time and the least operations of a whole RGAT + ComplEx
training step, from the real sizes of a batch (real edges, real rows,
distinct node-relation pairs), at the H100 peaks of bounds.py. Nothing
here imports the program."""

from __future__ import annotations

from .bounds import NEG_FLOPS, bound_s

# per edge and message column, float32 operations of the attention
# (the two logit dot products, the weighted message and its scatter),
# (forward, backward)
ATTEND_FLOPS = (6, 12)


def relmm_call_s(e: int, k: int, n: int, r: int, itemsize: int = 4) -> float:
    """One product ``out[e] = msg[e] @ W[rel(e)]`` over e real rows (the
    forward, or d_msg with k and n swapped): msg read once, the (r, k, n)
    weights read once, the output written once; 2·e·k·n operations."""
    nbytes = itemsize * (e * k + r * k * n + e * n)
    return bound_s(nbytes, 2.0 * e * k * n)


def weight_grad_s(e: int, k: int, n: int, r: int, itemsize: int = 4) -> float:
    """One dW = Σ msgᵀ g by relation over e real rows: msg and g read
    once, the float32 (r, k, n) gradient written once; 2·e·k·n
    operations."""
    nbytes = itemsize * (e * k + e * n) + 4 * r * k * n
    return bound_s(nbytes, 2.0 * e * k * n)


def relmm_step_s(e: int, dims, heads: int, r: int, itemsize: int = 4
                 ) -> float:
    """A training step's grouped GEMMs and their dW on e real edges: per
    conv (din → heads·dout) two forward products (the source and the
    destination messages) and two dW; d_msg twice on every conv but the
    first (the features do not train)."""
    total = 0.0
    for i, (din, dout) in enumerate(dims):
        n = heads * dout
        total += 2 * relmm_call_s(e, din, n, r, itemsize)
        total += 2 * weight_grad_s(e, din, n, r, itemsize)
        if i > 0:
            total += 2 * relmm_call_s(e, n, din, r, itemsize)
    return total


def rgat_complex_step_flops(e: int, src_pairs: int, dst_pairs: int, dims,
                            heads: int, k: int, d_out: int) -> float:
    """Least float32 operations of one RGAT + ComplEx training step.

    Per conv (din → heads·dout = n): a message is x_u W_r, one per
    distinct (node, relation) pair at each end, so the products are
    2·(src_pairs + dst_pairs)·din·n forward, as many for dW and, on every
    conv but the first, for the input gradient; the attention
    ``ATTEND_FLOPS`` a message element. ComplEx: the negscore count a
    feature of each positive and negative slot (5 forward, 15 backward).
    The optimizer and the head mean are not counted."""
    flops = 0.0
    for i, (din, dout) in enumerate(dims):
        n = heads * dout
        products = 2.0 * (src_pairs + dst_pairs) * din * n
        flops += products * (2.0 if i == 0 else 3.0)
        flops += sum(ATTEND_FLOPS) * e * n
    flops += sum(NEG_FLOPS["complex"]) * (1 + k) * e * d_out
    return flops

