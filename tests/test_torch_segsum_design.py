"""The owner design of the port's sorted segment-sum (ops/segsum.py), on
the CPU: which instance a call takes, the geometry ``owner_plan`` gives the
kernel, and ``owner_sum_plain`` (the kernel's chunks, runs, partials and
joins in plain torch, with each output row's writes counted), held with
``segsum_plain`` against numpy and against the JAX package's
``sorted_segment_sum`` (its Pallas kernel in interpret mode, as
tests/test_torch_segsum.py runs it).

Tolerances, element by element and relative to the sum of its terms'
magnitudes: float32 1e-5 (only the summation order differs); bfloat16
2e-2, as tests/test_ops.py states for the JAX kernel (JAX's interpret-mode
one-hot matmul rounds differently from a float32 sum of bf16 inputs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from biomedkg_tpu.ops.pallas import segsum as jax_segsum
from biomedkg_tpu_torch.ops import segsum

M, N = 2048, 300
# a small card, so that M rows make many chunks
SMS, PER_SM = 2, 1
KINDS = ("ascending", "front pads", "end pads", "pads anywhere", "any order",
         "above N", "hub", "empty run")
TYPES = {"float32": (torch.float32, 1e-5), "bfloat16": (torch.bfloat16, 2e-2)}


def _ids(kind, rng, chunk_rows):
    """int32 ids of one kind: ascending with repeats, -1 pads in front (still
    ascending), at the end or anywhere, in any order, above N, one hub
    segment over many chunks, or a run of empty ids that starts at a chunk
    boundary."""
    ids = np.sort(rng.integers(0, N, M))
    if kind == "front pads":
        ids[: M // 10] = -1
    elif kind == "end pads":
        ids[-M // 10:] = -1
    elif kind == "pads anywhere":
        ids[rng.choice(M, M // 20, replace=False)] = -1
    elif kind == "any order":
        rng.shuffle(ids)
    elif kind == "above N":
        ids[-M // 8:] = N + 5
        ids[-M // 8 - 1] = N
    elif kind == "hub":
        ids[M // 4: M // 4 + 6 * chunk_rows] = ids[M // 4]
        ids = np.sort(ids)
    elif kind == "empty run":
        at = 3 * chunk_rows
        ids[at:] = np.minimum(ids[at:] + N // 4, N - 1)
    return ids.astype(np.int32)


def _numpy_sum(vals, ids):
    keep = (ids >= 0) & (ids < N)
    out = np.zeros((N, vals.shape[1]), np.float64)
    np.add.at(out, ids[keep], vals[keep].astype(np.float64))
    return out


def _assert_sums(got, want, vals, ids, tol):
    magnitude = _numpy_sum(np.abs(vals), ids)
    err = np.abs(np.asarray(got, np.float64) - want)
    assert err.shape == magnitude.shape
    assert np.all(err <= tol * magnitude + 1e-30), \
        float((err / np.maximum(magnitude, 1e-30)).max())


def _jax_interpret(vals, ids, dtype):
    arg = jnp.asarray(vals)
    if dtype == torch.bfloat16:
        arg = arg.astype(jnp.bfloat16)
    jax_segsum._FORCE_KERNEL = True
    try:
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jax_segsum.sorted_segment_sum(
                arg, jnp.asarray(ids), N))
    finally:
        jax_segsum._FORCE_KERNEL = False


def _case(kind, d, dtype, seed):
    """(data as torch in ``dtype``, its values as float32 numpy, ids, the
    chunk rows the packed or general instance takes at (M, d))."""
    rng = np.random.default_rng(seed)
    instance = segsum.segsum_instance(dtype, d, 0, 0, 0)
    plan = segsum.owner_plan(instance, dtype, M, d, SMS, PER_SM)
    ids = _ids(kind, rng, plan.chunk_rows)
    data = torch.from_numpy(
        rng.standard_normal((M, d)).astype(np.float32)).to(dtype)
    return data, data.float().numpy(), ids, plan.chunk_rows


@pytest.mark.parametrize("dtype,d,addresses,want", [
    (torch.float32, 256, (0, 16, 32), "packed"),
    (torch.float32, 8, (0, 0, 0), "packed"),       # the count table
    (torch.float32, 7, (0, 0, 0), "general"),      # a graph of 7 relations
    (torch.float32, 257, (0, 0, 0), "general"),
    (torch.float32, 256, (4, 0, 0), "general"),    # data not 16-byte aligned
    (torch.float32, 256, (0, 8, 0), "general"),    # ids not 16-byte aligned
    (torch.bfloat16, 256, (0, 0, 0), "packed"),
    (torch.bfloat16, 8, (0, 0, 0), "packed"),
    (torch.bfloat16, 100, (0, 0, 0), "general"),   # 16-byte packs need 8 | d
    (torch.bfloat16, 256, (0, 0, 2), "general"),   # out not 16-byte aligned
])
def test_instance_for_width_and_alignment(dtype, d, addresses, want):
    assert segsum.segsum_instance(dtype, d, *addresses) == want
    assert segsum.INSTANCES == ("first", "packed", "general")


@pytest.mark.parametrize("instance,dtype,m,d", [
    ("packed", torch.float32, 1_159_168, 256),     # serving conv
    ("packed", torch.float32, 1_159_168, 8),       # serving count table
    ("packed", torch.bfloat16, 40_960, 256),       # Stage C conv
    ("packed", torch.float32, 40_960, 8),          # Stage C count table
    ("packed", torch.float32, 276_480, 256),       # GRACE
    ("packed", torch.bfloat16, 276_480, 256),
    ("general", torch.float32, 50_000, 257),
    ("general", torch.bfloat16, 50_000, 100),
    ("general", torch.float32, 5, 7),
    ("packed", torch.bfloat16, 1, 8),
])
@pytest.mark.parametrize("sms,per_sm", [(132, 2), (132, 1), (2, 1)])
def test_plan_covers_every_row(instance, dtype, m, d, sms, per_sm):
    _, per, _, in_flight = segsum.OWNER_KERNELS[(instance, dtype)]
    plan = segsum.owner_plan(instance, dtype, m, d, sms, per_sm)
    g = plan.group
    assert g in (1, 2, 4, 8, 16, 32)
    # a lane a unit of the row, up to a warp
    units = -(-d // per)
    assert g == 32 or g >= units
    assert g == 1 or g // 2 < units
    # whole rounds of rows in flight, and the chunks tile the rows
    assert plan.chunk_rows % in_flight == 0
    assert (plan.chunks - 1) * plan.chunk_rows < m <= \
        plan.chunks * plan.chunk_rows
    # every block resident; a group a chunk unless the card is full
    per_block = segsum.THREADS // g
    assert 1 <= plan.blocks <= sms * per_sm
    assert plan.blocks * per_block >= plan.chunks or \
        plan.blocks == sms * per_sm


@pytest.mark.parametrize("dtype_name", TYPES)
@pytest.mark.parametrize("d", [8, 7, 256, 257])
@pytest.mark.parametrize("kind", KINDS)
def test_owner_sum_matches_numpy(kind, d, dtype_name):
    dtype, tol = TYPES[dtype_name]
    data, vals, ids, chunk_rows = _case(kind, d, dtype, seed=d)
    want = _numpy_sum(vals, ids)
    got, writes = segsum.owner_sum_plain(data, torch.from_numpy(ids), N,
                                         chunk_rows)
    assert got.dtype == torch.float32 and got.shape == (N, d)
    _assert_sums(got.numpy(), want, vals, ids, tol)
    _assert_sums(segsum.segsum_plain(data, torch.from_numpy(ids), N).numpy(),
                 want, vals, ids, tol)
    if bool(np.all(ids[1:] >= ids[:-1])):
        # ascending: every output row written once, but the rows of
        # segments that cross a chunk boundary: zeroed before the
        # barrier, then only added to
        added = writes["added"] > 0
        assert torch.all((writes["stored"] + writes["zeroed"])[~added] == 1)
        assert torch.all(writes["stored"][added] == 0)
        assert torch.all(writes["zeroed"][added] >= 1)
    else:
        assert kind in ("end pads", "pads anywhere", "any order")
        assert torch.all(writes["zeroed"] >= 1)
        assert not torch.any(writes["stored"])


@pytest.mark.parametrize("dtype_name", TYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_owner_sum_matches_jax_interpret(kind, dtype_name):
    dtype, tol = TYPES[dtype_name]
    d = 257 if dtype == torch.float32 else 8
    data, vals, ids, chunk_rows = _case(kind, d, dtype, seed=1)
    want = _jax_interpret(vals, ids, dtype)
    got, _ = segsum.owner_sum_plain(data, torch.from_numpy(ids), N,
                                    chunk_rows)
    _assert_sums(got.numpy(), want, vals, ids, tol)
    _assert_sums(segsum.segsum_plain(data, torch.from_numpy(ids), N).numpy(),
                 want, vals, ids, tol)


def test_hub_over_many_chunks_is_zeroed_once_a_boundary_and_added():
    """The hub segment spans many chunks: each of its chunk boundaries
    zeroes its row before the barrier, and each of its chunks adds its
    part after it. A segment that crosses one boundary is zeroed once and
    added twice; one inside a chunk is stored once."""
    data, vals, ids, chunk_rows = _case("hub", 256, torch.float32, seed=3)
    hub = int(ids[M // 4])
    rows = np.flatnonzero(ids == hub)
    spanned = rows[-1] // chunk_rows - rows[0] // chunk_rows + 1
    assert spanned >= 6
    got, writes = segsum.owner_sum_plain(data, torch.from_numpy(ids), N,
                                         chunk_rows)
    assert int(writes["added"][hub]) == spanned
    assert int(writes["zeroed"][hub]) == spanned - 1
    assert int(writes["stored"][hub]) == 0
    boundary = np.arange(chunk_rows, M, chunk_rows)
    crossing = set(ids[boundary][ids[boundary] == ids[boundary - 1]].tolist())
    short = [i for i in crossing if i != hub and 0 <= i < N]
    assert short and all(int(writes["added"][i]) == 2
                         and int(writes["zeroed"][i]) == 1 for i in short)
    inside = [i for i in set(ids.tolist()) - crossing if 0 <= i < N]
    assert inside and all(int(writes["stored"][i]) == 1 for i in inside)
    _assert_sums(got.numpy(), _numpy_sum(vals, ids), vals, ids, 1e-5)
