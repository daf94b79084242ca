"""The port's sorted segment-sum (its plain torch version, which CPU
tensors run) against the JAX ``sorted_segment_sum``: the XLA path and the
Pallas kernel in interpret mode, forward and backward.

Tolerances: float32 1e-5 (only the summation order differs); bfloat16
2e-2, as tests/test_ops.py states for the JAX kernel (JAX's interpret-mode
one-hot matmul rounds differently from a float32 sum of bf16 inputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biomedkg_tpu.ops.pallas import segsum as jax_segsum
from biomedkg_tpu_torch.ops import segsum

M, N = 2048, 300


def _ids(rng, order):
    ids = np.sort(rng.integers(0, N, M)).astype(np.int32)
    if order == "sorted-pads":
        ids[:7] = -1             # the reference's padding convention
        ids[-40:] = -1
        ids = np.sort(ids)
    elif order == "unsorted":
        rng.shuffle(ids)
        ids[rng.choice(M, 50, replace=False)] = -1
    return ids


def _jax(vals, ids, path):
    arg = jnp.asarray(vals)
    if path == "xla":
        return np.asarray(jax_segsum.sorted_segment_sum(arg, jnp.asarray(ids),
                                                        N))
    jax_segsum._FORCE_KERNEL = True
    try:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jax_segsum.sorted_segment_sum(
                arg, jnp.asarray(ids), N))
    finally:
        jax_segsum._FORCE_KERNEL = False


@pytest.mark.parametrize("path", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 128])
@pytest.mark.parametrize("order", ["sorted-pads", "unsorted"])
def test_plain_matches_jax(order, d, dtype, path):
    rng = np.random.default_rng(d)
    ids = _ids(rng, order)
    vals = rng.standard_normal((M, d)).astype(np.float32)
    data = torch.from_numpy(vals)
    if dtype == "bfloat16":
        data = data.to(torch.bfloat16)
        vals = jnp.asarray(vals).astype(jnp.bfloat16)
    out = segsum.sorted_segment_sum(data, torch.from_numpy(ids), N)
    assert out.dtype == torch.float32 and out.shape == (N, d)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.numpy(), _jax(vals, ids, path),
                               rtol=tol, atol=tol)


def test_backward_matches_jax():
    rng = np.random.default_rng(1)
    ids = _ids(rng, "sorted-pads")
    vals = rng.standard_normal((M, 16)).astype(np.float32)
    cot = rng.standard_normal((N, 16)).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jax_segsum.sorted_segment_sum(
        v, jnp.asarray(ids), N) * cot))(jnp.asarray(vals))
    data = torch.from_numpy(vals).requires_grad_(True)
    (segsum.sorted_segment_sum(data, torch.from_numpy(ids), N)
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(data.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_out_of_range_ids_are_dropped():
    data = torch.ones(4, 2)
    ids = torch.tensor([0, 5, -1, 2], dtype=torch.int32)
    out = segsum.sorted_segment_sum(data, ids, 3)
    np.testing.assert_array_equal(out.numpy(), [[1, 1], [0, 0], [1, 1]])


@pytest.mark.parametrize("data,ids,err", [
    (torch.ones(4, 2, dtype=torch.float64),
     torch.zeros(4, dtype=torch.int32), TypeError),
    (torch.ones(4, 2), torch.zeros(4, dtype=torch.int64), TypeError),
    (torch.ones(4, 2), torch.zeros(3, dtype=torch.int32), ValueError),
    (torch.ones(4), torch.zeros(4, dtype=torch.int32), ValueError),
])
def test_rejects_bad_inputs(data, ids, err):
    with pytest.raises(err):
        segsum.sorted_segment_sum(data, ids, 3)
    with pytest.raises(err):
        segsum.KERNEL(data, ids, 3)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU; only the dispatch in
    sorted_segment_sum sends CPU tensors to the plain version."""
    before = segsum.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        segsum.KERNEL(torch.ones(4, 2), torch.zeros(4, dtype=torch.int32), 3)
    assert segsum.KERNEL.launches == before
