"""Sorted segment-sum: ``out[n] = Σ_{i: ids[i] == n} data[i]``.

Counterpart of biomedkg_tpu/ops/pallas/segsum.py::sorted_segment_sum. On
a CUDA tensor it launches the hand-written Hopper kernel of
``csrc/segsum.cu`` (built at first use by ops/_build.py); on a CPU tensor
it runs ``segsum_plain``, the plain torch version the tests and
``chip_smoke.py`` hold the kernel against. A CUDA
tensor never falls back: the kernel builds and launches, or the call
raises.

The gradient is the row gather of the reference's ``_segsum_bwd``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary, check_launch, stream_of

_SIGNATURE = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
              ctypes.c_void_p]
LIBRARY = CudaLibrary("segsum.cu", {"segsum_f32": _SIGNATURE,
                                    "segsum_bf16": _SIGNATURE})


class SegsumKernel:
    """The kernel's wrapper: ``launches`` goes up by one for each kernel
    launch and nowhere else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, data: torch.Tensor, ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
        _check(data, ids, num_segments)
        if data.device.type != "cuda":
            raise ValueError(f"the segsum kernel runs on CUDA tensors, got "
                             f"{data.device}")
        if not (data.is_contiguous() and ids.is_contiguous()):
            raise ValueError("segsum kernel: data and ids must be contiguous")
        m, d = data.shape
        out = torch.zeros(num_segments, d, dtype=torch.float32,
                          device=data.device)
        if m == 0 or d == 0 or num_segments == 0:
            return out
        lib = LIBRARY.lib()
        fn = lib.segsum_f32 if data.dtype == torch.float32 else \
            lib.segsum_bf16
        with torch.cuda.device(data.device):
            err = fn(data.data_ptr(), ids.data_ptr(), out.data_ptr(), m, d,
                     num_segments, stream_of(data))
        check_launch(err, "segsum")
        self.launches += 1
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
