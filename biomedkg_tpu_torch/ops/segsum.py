"""Sorted segment-sum: ``out[n] = Σ_{i: ids[i] == n} data[i]``.

Counterpart of biomedkg_tpu/ops/pallas/segsum.py::sorted_segment_sum. On
a CUDA tensor it launches the hand-written Hopper kernels of
``csrc/segsum.cu`` (built at first use by ops/_build.py) in the instance
``segsum_instance`` picks: the owner design's ``packed`` instance (16-byte
packs) where the width and the bases allow, else its ``general`` one (one
element a lane); the first design's ``first`` instance is kept off the
path for the A/B. On a CPU tensor it runs ``segsum_plain``, the plain
torch version the tests and ``chip_smoke.py`` hold the kernel against. A
CUDA tensor never falls back: the kernel builds and launches, or the call
raises.

The owner design's host-visible parts have plain versions here that the
CPU tests reach: ``owner_plan`` (the chunk partition and the grid) and
``owner_sum_plain`` (which output rows each chunk stores, zeroes or adds
to, and the sums in the kernel's order).

The gradient is the row gather of the reference's ``_segsum_bwd``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ._build import CudaLibrary, check_launch, stream_of

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# data, ids, out, m, d, n, code, group, chunk_rows, chunks, blocks, sync,
# stream
_LAUNCH = [_P, _P, _P, _L, _I, _L, _I, _I, _L, _L, _I, _P, _P]
LIBRARY = CudaLibrary("segsum.cu", {
    "segsum_launch": _LAUNCH,
    "segsum_blocks_per_sm": [_I, ctypes.POINTER(ctypes.c_int)]})
NAME = "sorted_segment_sum"
# csrc/segsum.cu's instances
INSTANCES = ("first", "packed", "general")
TYPES = (torch.float32, torch.bfloat16)
THREADS = 256
# the owner design's kernels: (instance, type) -> (launch code, elements a
# lane's unit, units a lane a row at most, rows in flight); keep in step
# with csrc/segsum.cu's owner_kernel_of (the first design's codes are 0 in
# float32, 1 in bf16)
OWNER_KERNELS = {("packed", torch.float32): (2, 4, 2, 8),
                 ("packed", torch.bfloat16): (3, 8, 1, 8),
                 ("general", torch.float32): (4, 1, 4, 8),
                 ("general", torch.bfloat16): (5, 1, 4, 8)}


def segsum_instance(dtype: torch.dtype, d: int, *addresses: int) -> str:
    """The instance a call runs: ``packed`` where a row is whole 16-byte
    packs (d a multiple of 4 in float32, 8 in bf16) and every base (data,
    ids, out) is 16-byte aligned, else ``general``."""
    per_pack = 16 // dtype.itemsize
    aligned = all(a % 16 == 0 for a in addresses)
    return "packed" if aligned and d % per_pack == 0 else "general"


class Plan(NamedTuple):
    group: int          # lanes that walk one chunk together, a row at a time
    chunk_rows: int     # rows a chunk (a multiple of the rows in flight)
    chunks: int
    blocks: int         # all resident: at most sms * blocks_per_sm


def owner_plan(instance: str, dtype: torch.dtype, m: int, d: int, sms: int,
               blocks_per_sm: int) -> Plan:
    """The owner design's geometry for (m, d): a lane a unit of the row
    (up to a warp a row, more units a lane for wider rows), and as many
    chunks as the card holds groups, each at least one round of rows in
    flight; a warp a row takes half as many, one block's groups on each
    SM (a segment that crosses a chunk boundary is added with atomics, and
    the fewer such rows the better where a row is a warp's load)."""
    _, per, _, in_flight = OWNER_KERNELS[(instance, dtype)]
    units = -(-d // per)
    group = 1
    while group < 32 and group < units:
        group *= 2
    per_block = THREADS // group
    blocks = sms * (1 if group == 32 else blocks_per_sm)
    rows = -(-m // (blocks * per_block))
    chunk_rows = max(in_flight, -(-rows // in_flight) * in_flight)
    chunks = -(-m // chunk_rows)
    return Plan(group, chunk_rows, chunks,
                max(1, min(sms * blocks_per_sm, -(-chunks // per_block))))


class SegsumKernel:
    """The kernel's wrapper: ``launches`` goes up by one for each kernel
    launch and nowhere else, and ``by_instance`` counts the same launches
    by instance."""

    def __init__(self):
        self.name = NAME
        self.reset()
        self._resident = {}
        self._sync = {}

    def reset(self):
        self.launches = 0
        self.by_instance = dict.fromkeys(INSTANCES, 0)

    def blocks_per_sm(self, code: int, device: torch.device) -> int:
        key = (code, device.index)
        if key not in self._resident:
            count = ctypes.c_int(0)
            check_launch(LIBRARY.lib().segsum_blocks_per_sm(
                code, ctypes.byref(count)), "segsum occupancy")
            self._resident[key] = count.value
        return self._resident[key]

    def sync(self, device: torch.device, stream: int) -> torch.Tensor:
        """The stream's barrier workspace, zeroed once; every launch leaves
        it as it found it."""
        key = (device.index, stream)
        if key not in self._sync:
            # csrc/segsum.cu's Sync: count, generation, order flag
            self._sync[key] = torch.zeros(3, dtype=torch.int32, device=device)
        return self._sync[key]

    def __call__(self, data: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
        _check(data, ids, num_segments)
        if data.device.type != "cuda":
            raise ValueError(f"the segsum kernel runs on CUDA tensors, got "
                             f"{data.device}")
        if not (data.is_contiguous() and ids.is_contiguous()):
            raise ValueError("segsum kernel: data and ids must be contiguous")
        m, d = data.shape
        if m == 0 or d == 0 or num_segments == 0:
            return torch.zeros(num_segments, d, dtype=torch.float32,
                               device=data.device)
        out = torch.empty(num_segments, d, dtype=torch.float32,
                          device=data.device)
        instance = segsum_instance(data.dtype, d, data.data_ptr(),
                                   ids.data_ptr(), out.data_ptr())
        code = TYPES.index(data.dtype) if instance == "first" else \
            OWNER_KERNELS[(instance, data.dtype)][0]
        with torch.cuda.device(data.device):
            stream = stream_of(data)
            if instance == "first":
                out.zero_()
                plan, sync = Plan(0, 0, 0, 0), 0
            else:
                plan = owner_plan(
                    instance, data.dtype, m, d,
                    torch.cuda.get_device_properties(
                        data.device).multi_processor_count,
                    self.blocks_per_sm(code, data.device))
                sync = self.sync(data.device, stream).data_ptr()
            err = LIBRARY.lib().segsum_launch(
                data.data_ptr(), ids.data_ptr(), out.data_ptr(), m, d,
                num_segments, code, plan.group, plan.chunk_rows,
                plan.chunks, plan.blocks, sync, stream)
        check_launch(err, f"segsum [{instance}]")
        self.launches += 1
        self.by_instance[instance] += 1
        return out


KERNEL = SegsumKernel()


def _check(data: torch.Tensor, ids: torch.Tensor, num_segments: int):
    if data.dim() != 2 or ids.dim() != 1 or ids.shape[0] != data.shape[0]:
        raise ValueError(f"segsum: want data (M, d) and ids (M,), got "
                         f"{tuple(data.shape)} and {tuple(ids.shape)}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segsum: data must be float32 or bfloat16, got "
                        f"{data.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"segsum: ids must be int32, got {ids.dtype}")
    if ids.device != data.device:
        raise ValueError(f"segsum: data on {data.device}, ids on "
                         f"{ids.device}")
    if num_segments < 0:
        raise ValueError(f"segsum: num_segments {num_segments} < 0")


def segsum_plain(data: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The plain torch version: ids outside [0, num_segments) (the -1
    pads) go to a dump row that is cut off. Returns float32."""
    ids = ids.long()
    safe = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    out = torch.zeros(num_segments + 1, data.shape[1], dtype=torch.float32,
                      device=data.device)
    return out.index_add_(0, safe, data.float())[:num_segments]


def owner_sum_plain(data: torch.Tensor, ids: torch.Tensor,
                    num_segments: int, chunk_rows: int):
    """The owner design in plain torch, in the kernel's order, over chunks
    of ``chunk_rows``: returns the float32 sums and, per output row, how
    often it is written: ``zeroed`` before the barrier (the row of a
    segment that crosses a chunk boundary, once a boundary), ``added``
    after it (a run that crosses a chunk boundary), ``stored`` (a run that
    is a whole segment, or a zero between two runs) and, last, ``zeroed``
    again (the rows below the first id and above the last). Ids that do
    not ascend take the other path: everything zeroed, every run added."""
    m, n = ids.shape[0], num_segments
    ids = ids.long()
    out = torch.full((n, data.shape[1]), float("nan"))
    writes = {k: torch.zeros(n, dtype=torch.long)
              for k in ("zeroed", "stored", "added")}
    if m == 0 or n == 0:
        return out.zero_(), writes
    starts = torch.arange(0, m, chunk_rows)
    same_prev = torch.zeros(m, dtype=torch.bool)
    same_prev[1:] = ids[1:] == ids[:-1]
    # runs: maximal stretches of one id inside one chunk
    run_start = ~same_prev
    run_start[starts] = True
    run = torch.cumsum(run_start.long(), 0) - 1
    heads = torch.nonzero(run_start).flatten()
    ends = torch.cat([heads[1:], torch.tensor([m])]) - 1
    run_id = ids[heads]
    sums = torch.zeros(heads.shape[0], data.shape[1]).index_add_(
        0, run, data.float())
    keep = (run_id >= 0) & (run_id < n)

    def write(kind, rows, value=None):
        writes[kind].index_add_(0, rows, torch.ones_like(rows))
        if kind == "added":
            out.index_add_(0, rows, value)
        else:
            out[rows] = 0.0 if value is None else value

    def span(lo, hi):
        lo = max(lo, 0)
        return torch.arange(lo, max(lo, min(hi, n)))

    # before the barrier
    crossing = starts[1:][same_prev[starts[1:]]]
    write("zeroed", ids[crossing][(ids[crossing] >= 0) & (ids[crossing] < n)])
    if not bool(torch.all(ids[1:] >= ids[:-1])):
        write("zeroed", span(0, n))
        write("added", run_id[keep], sums[keep])
        return out, writes
    # after it: a run that continues the previous chunk's last run or goes
    # on into the next chunk is added, the rest stored
    crosses = (same_prev[heads] & run_start[heads]) | (
        (ends + 1 < m) & same_prev[(ends + 1).clamp(max=m - 1)])
    write("stored", run_id[keep & ~crosses], sums[keep & ~crosses])
    rise = torch.nonzero(ids[1:] > ids[:-1]).flatten() + 1
    for i in rise.tolist():
        write("stored", span(int(ids[i - 1]) + 1, int(ids[i])))
    write("added", run_id[keep & crosses], sums[keep & crosses])
    write("zeroed", span(0, int(ids[0])))
    write("zeroed", span(int(ids[-1]) + 1, n))
    return out, writes


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        ctx.data_dtype = data.dtype
        if data.device.type == "cpu":
            _check(data, ids, num_segments)
            return segsum_plain(data, ids, num_segments)
        return KERNEL(data, ids, num_segments)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        n = ctx.num_segments
        ids = ids.long()
        valid = (ids >= 0) & (ids < n)
        d_data = g.index_select(0, ids.clamp(0, max(n - 1, 0)))
        d_data = d_data * valid[:, None]
        return d_data.to(ctx.data_dtype), None, None


def sorted_segment_sum(data: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """``out[n] = Σ_{i: ids[i] == n} data[i]`` → (num_segments, d) float32.

    data: (M, d) float32 or bfloat16; ids: (M,) int32, ascending for speed
    (any order is exact); ids outside [0, num_segments), such as the -1
    pads, are ignored.
    """
    return _SortedSegmentSum.apply(data, ids, num_segments)
