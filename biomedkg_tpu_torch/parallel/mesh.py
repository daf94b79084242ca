"""Process groups for data-parallel × tensor-parallel training
(counterpart of biomedkg_tpu/parallel/mesh.py).

The JAX package lays its devices out as a (dp, tp) ``jax.sharding.Mesh``;
here each device is a rank of an initialised ``torch.distributed`` group
(NCCL on the card, gloo where the caller asks for it), and a ``Mesh``
holds the (dp, tp) grid of those ranks with one process group along each
axis. Rank ``d·tp + t`` sits at (d, t), as JAX's ``reshape(dp, tp)`` puts
device ``d·tp + t``. An axis that spans every rank is the world group;
another axis of one rank needs no group (its collectives are the
identity).
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

LAUNCH_HINT = ("start one process per card with `python -m "
               "biomedkg_tpu_torch.parallel.launch --nproc N <module> "
               "[args]` or `torchrun --nproc_per_node N -m <module> [args]`")


class Mesh(NamedTuple):
    """A (dp, tp) grid of ranks: this rank's coordinates and the groups
    of its row (tp) and column (dp). ``dp_group`` / ``tp_group`` are None
    on an axis of one rank that is not the whole initialised group."""
    dp: int
    tp: int
    rank: int
    dp_rank: int
    tp_rank: int
    dp_group: Optional[dist.ProcessGroup]
    tp_group: Optional[dist.ProcessGroup]

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def group(self) -> Optional[dist.ProcessGroup]:
        """The group of every rank of the mesh (None outside an
        initialised group)."""
        return dist.group.WORLD if dist.is_initialized() else None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> Mesh:
    """The (dp, tp) mesh over the initialised group's ranks; dp defaults
    to world size / tp. More than one rank needs an initialised group:
    without one this raises and says how to start one."""
    world = world_size()
    if dp is None:
        dp = world // tp
    if dp * tp != world:
        if world == 1 and not dist.is_initialized():
            raise RuntimeError(
                f"a (dp={dp}, tp={tp}) mesh needs {dp * tp} ranks and no "
                f"process group is initialised: {LAUNCH_HINT}")
        raise ValueError(f"dp({dp}) * tp({tp}) != world size ({world})")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dp_rank, tp_rank = divmod(rank, tp)
    dp_group = tp_group = None
    # an axis over every rank of an initialised group is the world group
    # (even of one rank: its collectives still run, on NCCL on the card);
    # every rank creates every other group, in the same order
    if dist.is_initialized() and dp == world:
        dp_group = dist.group.WORLD
    elif dp > 1:
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)])
            if t == tp_rank:
                dp_group = g
    if dist.is_initialized() and tp == world:
        tp_group = dist.group.WORLD
    elif tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if d == dp_rank:
                tp_group = g
    return Mesh(dp, tp, rank, dp_rank, tp_rank, dp_group, tp_group)


def distributed_init_if_needed(device=None) -> torch.device:
    """Join the group torchrun's variables describe (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT) over NCCL on the card, gloo on
    the CPU; a single process (no WORLD_SIZE, or 1) and an already
    initialised group are left as they are. Returns this rank's device:
    for a launched rank (WORLD_SIZE above 1, or LOCAL_RANK set) on the
    card ``cuda:LOCAL_RANK``, set as the current device before NCCL
    starts (``device_id`` binds the communicator to it); for a single
    process ``device`` as ``resolve_device`` gives it (``cuda:1`` stays
    card 1)."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda" and (world > 1 or "LOCAL_RANK" in os.environ):
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if world == 1 or dist.is_initialized():
        return dev
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world,
                            **kwargs)
    return dev


def resolve_devices(devices, present: int) -> int:
    """The device count Lightning's ``devices`` asks for, clamped to the
    ``present`` ones as the JAX Trainer clamps it: ids (a list or "0,1")
    out of range warn and are dropped, a count above ``present`` warns
    and clamps, -1 or "auto" takes them all, None is one."""
    if devices is None:
        return 1
    d = devices
    if isinstance(d, str) and "," in d:
        d = [int(x) for x in d.split(",") if x.strip()]
    if isinstance(d, (list, tuple)):
        ids = [int(i) for i in d if 0 <= int(i) < present]
        if len(ids) < len(d):
            warnings.warn(f"devices={devices!r}: ids out of the {present} "
                          f"present are dropped, using {ids or [0]}",
                          stacklevel=3)
        return max(len(ids), 1)
    want = present if d in ("auto", -1, "-1") else int(d)
    if want < 0:
        want = present
    if want > present:
        warnings.warn(f"devices={devices!r} asks for {want} devices, "
                      f"{present} present: clamping", stacklevel=3)
    return max(1, min(want, present))


def is_global_zero() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def host_local_batch_seed(seed: int) -> int:
    """Per-rank loader seed: ``seed + rank``, so each rank samples its own
    batch stream under one global seed."""
    return int(seed) + (dist.get_rank() if dist.is_initialized() else 0)
