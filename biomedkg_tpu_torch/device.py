"""The device rule every entry point of the port follows.

``device=None`` means ``"cuda"``. Without CUDA that raises: an entry point
never carries on quietly on the CPU. The CPU runs only when the caller asks
for it (the tests pass ``device="cpu"``).

float32 matrix products must stay full float32 on the card: TF32 keeps ~3
decimal digits and reorders top-k candidates (ROADMAP.md hazard H1), so a
process that turned it on is refused.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def check_full_fp32() -> None:
    """Raise if float32 matmuls may run in TF32."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul."
            "allow_tf32 / set_float32_matmul_precision); the port computes "
            "in full float32 — turn TF32 off")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    check_full_fp32()
    return dev
