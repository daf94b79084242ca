"""The port's relation-blocked grouped GEMM (``ops/relmm.py``, its plain
version, which CPU tensors run, inside the autograd Function whose backward
the card also runs) and its layout checks, against the JAX package:
``relation_matmul(impl="scan")`` and ``relation_matmul_sorted`` in
interpret mode (as tests/test_ops.py:126-170 runs it), forward, d_msg
and dW, with trailing pad blocks and a relation that has no block; and the
port's ``scatter_max`` and ``segment_softmax`` against JAX's.

Tolerances: float32 1e-5 of each result's max (both sum in float32, only
the order differs). bf16: 1e-2 of the max for the product (one bf16
rounding of the output on each side), 3e-2 for the gradients (JAX's
interpret-mode figure, tests/test_ops.py; its scan rounds dW per relation
to bf16, the port sums it in float32 and rounds once).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biomedkg_tpu.ops import segment as jax_segment
from biomedkg_tpu.ops.pallas.relmm import relation_matmul_sorted as \
    jax_sorted
from biomedkg_tpu.ops.relmatmul import relation_matmul as jax_relmm
from biomedkg_tpu_torch.ops import relmm, segment

R, B, DIN, DOUT = 4, 64, 24, 16
# relation 3 has no block; the last two blocks are trailing pads
BLOCK_REL = np.array([0, 2, 2, 1, 0, 2, 0, 0], np.int32)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 3e-2)}
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed=0, din=DIN, dout=DOUT, block=B, block_rel=BLOCK_REL):
    rng = np.random.default_rng(seed)
    e = block * len(block_rel)
    msg = rng.standard_normal((e, din)).astype(np.float32)
    msg[-2 * block:] = 0.0
    w = rng.standard_normal((R, din, dout)).astype(np.float32)
    g = rng.standard_normal((e, dout)).astype(np.float32)
    return msg, w, g, np.repeat(block_rel, block)


def _port(msg, w, g, dtype, block_rel=BLOCK_REL):
    m = torch.from_numpy(msg).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).to(dtype).requires_grad_(True)
    out = relmm.relation_matmul_sorted(m, wt,
                                       torch.from_numpy(block_rel).long())
    assert out.dtype == dtype and out.shape == (msg.shape[0], w.shape[2])
    d_msg, d_w = torch.autograd.grad(out, (m, wt), torch.from_numpy(g).to(
        dtype))
    assert d_msg.dtype == d_w.dtype == dtype
    return [t.float().numpy() for t in (out.detach(), d_msg, d_w)]


def _jax(fn, msg, w, g, dtype):
    jt = JAX_DTYPE[dtype]
    out, vjp = jax.vjp(fn, jnp.asarray(msg, jt), jnp.asarray(w, jt))
    return [np.asarray(t, np.float32)
            for t in (out, *vjp(jnp.asarray(g, jt)))]


def _close(got, want, dtype):
    for i, (a, b) in enumerate(zip(got, want)):
        tol = TOL[dtype][min(i, 1)]
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= tol * scale, (i, np.abs(a - b).max(),
                                                     scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_jax_scan(dtype):
    msg, w, g, et = _inputs()
    got = _port(msg, w, g, dtype)
    _close(got, _jax(lambda a, b: jax_relmm(a, b, jnp.asarray(et),
                                            impl="scan"), msg, w, g, dtype),
           dtype)
    # pad rows stay zero, and a relation with no block gets no gradient
    assert not got[0][-2 * B:].any() and not got[2][3].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_jax_interpret_kernel(dtype):
    msg, w, g, _ = _inputs(seed=1)
    br = jnp.asarray(BLOCK_REL)

    def kernel(a, b):
        return jax_sorted(a, b, br, B)

    with pltpu.force_tpu_interpret_mode():
        want = _jax(kernel, msg, w, g, dtype)
    _close(_port(msg, w, g, dtype), want, dtype)


def test_ragged_blocks_and_widths_match_scan():
    """A block size that is no multiple of the kernels' 64-row tile, odd
    widths, float32."""
    block, block_rel = 40, np.array([1, 0, 3, 3, 0], np.int32)
    msg, w, g, et = _inputs(seed=2, din=37, dout=5, block=block,
                            block_rel=block_rel)
    got = _port(msg, w, g, torch.float32, block_rel)
    _close(got, _jax(lambda a, b: jax_relmm(a, b, jnp.asarray(et),
                                            impl="scan"), msg, w, g,
                     torch.float32), torch.float32)


def test_weight_grad_is_per_relation_sum():
    msg, w, g, et = _inputs(seed=3)
    d_w = relmm.weight_grad(torch.from_numpy(msg), torch.from_numpy(g),
                            torch.from_numpy(BLOCK_REL), R)
    want = np.stack([msg[et == r].T @ g[et == r] for r in range(R)])
    np.testing.assert_allclose(d_w.numpy(), want, rtol=1e-5, atol=1e-4)


def test_layout_errors():
    """The block size is the batch's own, E // len(block_rel); a batch the
    blocks do not tile, a call without block_rel, or mismatched inputs
    raise, and a CPU tensor never reaches the kernel."""
    msg = torch.zeros(6 * B, DIN)
    w = torch.zeros(R, DIN, DOUT)
    br = torch.zeros(6, dtype=torch.long)
    assert relmm.block_size_of(msg, br) == B
    with pytest.raises(ValueError, match="block_rel metadata"):
        relmm.relation_matmul_sorted(msg, w, None)
    for rows, blocks in ((6 * B - 1, br), (6 * B, br[:0])):
        with pytest.raises(ValueError, match="not a multiple of the block "
                                             "count"):
            relmm.relation_matmul_sorted(msg[:rows], w, blocks)
    with pytest.raises(TypeError, match="share float32 or bfloat16"):
        relmm.relation_matmul_sorted(msg, w.bfloat16(), br)
    with pytest.raises(TypeError, match="block_rel is"):
        relmm.relation_matmul_sorted(msg, w, br.float())
    with pytest.raises(ValueError, match="want msg"):
        relmm.relation_matmul_sorted(msg, w.transpose(1, 2), br)
    with pytest.raises(ValueError, match="CUDA tensors"):
        relmm.FORWARD(msg, w, br)
    assert relmm.FORWARD.launches == relmm.BACKWARD.launches == 0


@pytest.mark.parametrize("heads", [None, 2])
def test_segment_softmax_and_max_match_jax(heads):
    rng = np.random.default_rng(5)
    n, e = 12, 200
    shape = (e,) if heads is None else (e, heads)
    scores = (3 * rng.standard_normal(shape)).astype(np.float32)
    index = rng.integers(0, n - 3, e)        # the last 3 segments are empty
    index[index == 4] = 5
    mask = rng.random(e) < 0.7
    mask[index == 6] = False                 # segment 6 is all masked
    cot = rng.standard_normal(shape).astype(np.float32)

    st = torch.from_numpy(scores).requires_grad_(True)
    got = segment.segment_softmax(st, torch.from_numpy(index), n,
                                  mask=torch.from_numpy(mask))
    (grad,) = torch.autograd.grad(got, st, torch.from_numpy(cot))
    want, vjp = jax.vjp(lambda s: jax_segment.segment_softmax(
        s, jnp.asarray(index), n, mask=jnp.asarray(mask)),
        jnp.asarray(scores))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(grad.numpy(),
                               np.asarray(vjp(jnp.asarray(cot))[0]),
                               rtol=1e-5, atol=1e-6)
    assert not got.detach().numpy()[~mask].any()

    mx = segment.scatter_max(torch.from_numpy(scores),
                             torch.from_numpy(index), n).numpy()
    jmx = np.asarray(jax_segment.scatter_max(jnp.asarray(scores),
                                             jnp.asarray(index), n))
    full = np.isin(np.arange(n), index)
    np.testing.assert_array_equal(mx[full], jmx[full])
    assert np.all(np.isneginf(jmx[~full]))
    assert np.all(mx[~full] == np.finfo(np.float32).min)


def test_take_rows_matbwd_is_take_rows():
    assert segment.take_rows_matbwd is segment.take_rows


# (din, dout) of every relmm product on the RGAT (768/256 -> 2 heads x 256)
# and RGCN edge-conv (768/256 -> 256) paths
PATH_SHAPES = [(768, 512), (256, 512), (768, 256), (256, 256)]
ALIGNED = (0, 256, 4096)    # msg, weights and out addresses, 16-byte aligned


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("din,dout", PATH_SHAPES)
def test_instance_picker_takes_the_redesign_on_the_paths(dtype, din, dout):
    """Both directions: the forward (k = din, n = dout) and d_msg (k =
    dout, n = din)."""
    want = {torch.bfloat16: "wgmma", torch.float32: "simt_f32"}[dtype]
    for k, n in ((din, dout), (dout, din)):
        assert relmm.relmm_instance(dtype, k, n, *ALIGNED) == want


@pytest.mark.parametrize("k,n,addresses,bf16,f32", [
    # widths that are no multiple of 8 (bf16) or whose n is none of 4
    (100, 36, ALIGNED, "wmma_general", "simt_f32"),
    (36, 100, ALIGNED, "wmma_general", "simt_f32"),
    (100, 37, ALIGNED, "wmma_general", "simt_f32_general"),
    (0, 40, ALIGNED, "wmma_general", "simt_f32"),
    # the aligned odd shape chip_smoke.py gives the redesign
    (72, 40, ALIGNED, "wgmma", "simt_f32"),
    (40, 72, ALIGNED, "wgmma", "simt_f32"),
    # a base off 16 bytes: msg, weights or out
    (768, 512, (8, 256, 4096), "wmma_general", "simt_f32_general"),
    (768, 512, (0, 260, 4096), "wmma_general", "simt_f32_general"),
    (768, 512, (0, 256, 4100), "wmma_general", "simt_f32_general"),
])
def test_instance_picker_falls_back_to_the_general_instance(
        k, n, addresses, bf16, f32):
    assert relmm.relmm_instance(torch.bfloat16, k, n, *addresses) == bf16
    assert relmm.relmm_instance(torch.float32, k, n, *addresses) == f32


def test_instance_picker_sees_a_misaligned_view():
    """A row view of a tensor starts at its storage offset."""
    w = torch.zeros(8, 768, 512, dtype=torch.bfloat16)
    msg = torch.zeros(257, 768, dtype=torch.bfloat16)
    assert relmm.relmm_instance(torch.bfloat16, 768, 512, msg[1:].data_ptr(),
                                w.data_ptr(), 0) == "wgmma"
    assert relmm.relmm_instance(torch.bfloat16, 768, 512,
                                msg.view(-1)[4:].data_ptr(), w.data_ptr(),
                                0) == "wmma_general"


def test_instances_match_the_cuda_source():
    """INSTANCES is in the order of csrc/relmm.cu's Instance codes, and
    every type's redesign and general instance are among them."""
    path = os.path.join(os.path.dirname(relmm.__file__), os.pardir, "csrc",
                        "relmm.cu")
    with open(path) as f:
        enum = re.search(r"enum Instance : int \{(.*?)\};", f.read(),
                         re.S).group(1)
    codes = dict(re.findall(r"\b(k[A-Za-z]+) = (\d+),", enum))
    names = {"kWmmaGeneral": "wmma_general", "kWgmma": "wgmma",
             "kSimtGeneral": "simt_f32_general", "kSimt": "simt_f32"}
    assert {names[c]: int(v) for c, v in codes.items()} == {
        name: i for i, name in enumerate(relmm.INSTANCES)}
    for table in (relmm.FAST, relmm.GENERAL):
        assert set(table.values()) <= set(relmm.INSTANCES)
