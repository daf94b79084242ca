"""The yardstick: the H100's data-sheet peaks, each kernel's least time,
and the least operations of a whole training step, all from the real
sizes of the inputs (real edges, real rows, real negative slots), never
from a padded envelope or a design's tile size.

The kernel bounds are frozen copies of ``chip_smoke.py``'s
``segsum_bound_ms``, ``negscore_bound_ms`` / ``neg_bytes`` and
``flash_bound_ms``; the flash work counts real-row pairs where
``chip_smoke.flash_live_work`` counted the live 64-row tile pairs of one
design. Nothing here imports the program.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12        # float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # bf16 tensor cores
# special-function units (exp, sqrt, reciprocal): 16 per SM and clock
# against 128 float32 FMA lanes (256 operations)
SFU_OP_PER_S = FP32_FLOP_PER_S / 16

# per unit (slot x feature) float32 operations of a negscore call,
# (forward, backward)
NEG_FLOPS = {"distmult": (3, 8), "complex": (5, 15), "transe": (4, 10),
             "rotate": (6.5, 16.5)}
NEG_SFU = {"rotate": (1, 2)}


def bound_s(nbytes: float, flops: float = 0.0, peak: float = FP32_FLOP_PER_S,
            sfu_ops: float = 0.0) -> float:
    """Least seconds: the larger of the bytes over HBM bandwidth, the
    operations over ``peak`` and the special-function operations over
    theirs."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak,
               sfu_ops / SFU_OP_PER_S)


def segsum_bound_s(rows: int, d: int, itemsize: int, segments: int) -> float:
    """One segment sum of ``rows`` real (rows, d) inputs into ``segments``
    real outputs: inputs and their int32 ids read once, the float32 output
    written once; one add an input element."""
    nbytes = rows * d * itemsize + 4 * rows + segments * d * 4
    return bound_s(nbytes, rows * d)


def neg_bytes(mode: str, n: int, d: int, itemsize: int, m: int, r: int,
              backward: bool) -> int:
    """The bytes one negscore call must move: the (n, d) z table, three
    int32 index arrays of m slots, the float32 relation table and the
    scores; backward also ds in, and dz and the relation gradient out."""
    nbytes = n * d * itemsize + 3 * 4 * m + r * d * 4 + 4 * m
    if backward:
        dr = d // 2 if mode == "rotate" else d
        nbytes += n * d * itemsize + r * dr * 4
    return nbytes


def negscore_bound_s(mode: str, n: int, d: int, itemsize: int, m: int,
                     r: int, backward: bool) -> float:
    """One negscore call over m real slots of an (n, d) table of real
    rows."""
    return bound_s(neg_bytes(mode, n, d, itemsize, m, r, backward),
                   NEG_FLOPS[mode][backward] * m * d,
                   sfu_ops=NEG_SFU.get(mode, (0, 0))[backward] * m * (d // 2))


def flash_bound_s(n: int, d: int, itemsize: int, backward: bool) -> float:
    """One InfoNCE denominator call over n real rows of width d: the two
    (n, d) inputs read once and the outputs written once (backward: the
    column mask, the denominators and their cotangent in, both input
    gradients out); the products the mathematics needs over real-row
    pairs: forward the inter logits and half the symmetric intra logits,
    backward the three gradient products (G_inter bn, G_inter^T an,
    (G_intra + G_intra^T) an); one exp per real logit pair forward (inter
    and half of intra) and per softmax weight backward."""
    nbytes = 2 * n * d * itemsize + 8 * n
    if backward:
        nbytes += 8 * n + 2 * n * d * itemsize
    products = 3.0 if backward else 1.5
    exps = 2.0 if backward else 1.5
    peak = BF16_FLOP_PER_S if itemsize == 2 else FP32_FLOP_PER_S
    return bound_s(nbytes, products * 2.0 * n * n * d, peak,
                   exps * n * n)


def rgcn_step_flops(n: int, e: int, pairs: int, dims, k: int,
                    d_out: int) -> float:
    """Least float32 operations of one RGCN + DistMult training step.

    Per conv (din -> dout) the cheaper of transforming every node under
    every relation it sends or receives on (``pairs``: the fewer of the
    batch's distinct (source, relation) and (destination, relation)
    pairs) and aggregating first, 2·pairs·din·dout, plus the root product
    2·n·din·dout and one add an edge message element; the backward twice
    the products, but the first conv's input gradient (the features do not
    train) is not needed. DistMult: 3 operations a feature of each
    positive and negative slot forward, 8 backward (the negscore count).
    The optimizer and the elementwise work are not counted."""
    flops = 0.0
    for i, (din, dout) in enumerate(dims):
        products = 2.0 * (pairs + n) * din * dout
        flops += products * (2.0 if i == 0 else 3.0) + e * dout
    flops += 11.0 * (1 + k) * e * d_out
    return flops


def gcn_grace_step_flops(n: int, e: int, dims, proj: int, d_out: int
                         ) -> float:
    """Least float32 operations of one GRACE step on n real nodes and e
    real edges: per view and conv the product 2·n·din·dout and one add an
    edge element, the projection's two products; the backward twice the
    products (the first conv's input gradient not needed). The InfoNCE of
    both directions: the inter logits once (the second direction's are
    their transpose), the two symmetric intra products at half, forward;
    backward four products: both directions' inter gradients summed into
    one product for each input, and one for each intra gradient."""
    flops = 0.0
    for i, (din, dout) in enumerate(dims):
        flops += 2 * (2.0 * n * din * dout * (2.0 if i == 0 else 3.0)
                      + e * dout)
    flops += 2 * (2.0 * n * d_out * proj + 2.0 * n * proj * d_out) * 3.0
    pair = 2.0 * n * n * d_out
    flops += (1.0 + 0.5 + 0.5) * pair + 4.0 * pair
    return flops


def share(least_s: float, device_s: float):
    """least / device time as a percentage; None when nothing ran."""
    if device_s <= 0.0 or least_s <= 0.0:
        return None
    return 100.0 * least_s / device_s


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks, over all values."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(work: float, seconds: float) -> float:
    """All the window's work over all its time."""
    if seconds <= 0.0:
        raise ValueError("empty window")
    return work / seconds

