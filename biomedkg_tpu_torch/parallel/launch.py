"""One process per card, as Lightning's default ``ddp`` strategy re-launches
the script: the entry point runs again once per rank with torchrun's
variables set (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
and each rank joins the group in ``mesh.distributed_init_if_needed``.

    python -m biomedkg_tpu_torch.parallel.launch --nproc 2 \\
        biomedkg_tpu_torch.train_kge devices=0,1 epochs=10

``torchrun --nproc_per_node 2 -m biomedkg_tpu_torch.train_kge ...`` starts
the same ranks. ``train_kge``, ``train_gcl`` and ``train_dpi`` call
``per_card`` first: asked for more than one card of those present
(``devices``, clamped as the Trainer clamps it) from a process that is not
yet a rank, they re-launch themselves this way and return when every rank
has ended. ``test_kge`` runs in one process unless launched (its test
epoch is not data parallel; under a launcher every rank evaluates alike
and rank 0 reports).

``run_local_ranks`` starts ``world`` ranks of a function in this host's
processes (spawned), each in a group of the backend the caller names
(gloo for the CPU tests and the shared-card checks), with a time limit.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import traceback
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import torch

from ..device import resolve_device
from .mesh import resolve_devices


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cards_asked(devices, device) -> int:
    """The cards ``devices`` asks for on this host, clamped to those
    present; 1 off the card."""
    if resolve_device(device).type != "cuda":
        return 1
    return resolve_devices(devices, torch.cuda.device_count())


def launch(module: str, argv: Sequence[str], nproc: int) -> int:
    """Run ``python -m module argv`` as ``nproc`` ranks on this host; the
    first non-zero exit code (the others are stopped), else 0."""
    port = free_port()
    procs = []
    for rank in range(nproc):
        rank_env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(nproc),
                        LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                        MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv], env=rank_env))
    code = 0
    try:
        pending = list(procs)
        while pending:
            for p in list(pending):
                try:
                    rc = p.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    continue
                pending.remove(p)
                if rc and not code:
                    code = rc
                    for q in pending:
                        q.terminate()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return code


def per_card(module: str, argv: Sequence[str], devices, device) -> bool:
    """True when this call ran ``module`` as one rank per card (the
    caller then returns): more than one card asked for, from a process
    that is not yet a rank."""
    n = cards_asked(devices, device)
    if n <= 1 or "WORLD_SIZE" in os.environ:
        return False
    code = launch(module, argv, n)
    if code:
        raise SystemExit(code)
    return True


def _rank_main(rank, world, port, backend, timeout_s, target, args, queue):
    import torch.distributed as dist

    try:
        # one intra-op thread a rank: the ranks, and whatever else runs
        # beside them, share the host's cores
        torch.set_num_threads(1)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                          LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        kwargs = {}
        if backend == "nccl":           # one card a rank
            torch.cuda.set_device(rank)
            kwargs["device_id"] = torch.device("cuda", rank)
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world,
                                timeout=timedelta(seconds=timeout_s),
                                **kwargs)
        try:
            queue.put((rank, "ok", target(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, "error", traceback.format_exc()))
        raise


def run_local_ranks(world: int, target: Callable, args: tuple = (),
                    backend: str = "gloo", timeout: float = 300.0) -> List:
    """``target(rank, *args)`` in ``world`` spawned processes, each a rank
    of one group of ``backend``; returns the ranks' results in rank order.
    A rank that fails, or any that is still running after ``timeout``
    seconds, fails the call: every process is stopped."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, port, backend,
                               max(30, int(timeout)), target, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world - len(out)} of {world} ranks "
                                   f"did not finish in {timeout:.0f} s")
            try:
                rank, status, value = results.get(timeout=min(left, 5.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank exited with {dead[0]} "
                                       "before it reported")
                continue
            if status == "error":
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        description="Run a module as one rank per card on this host.")
    parser.add_argument("--nproc", type=int,
                        default=max(1, torch.cuda.device_count()))
    parser.add_argument("module")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    ns = parser.parse_args(argv)
    return launch(ns.module, ns.args, ns.nproc)


if __name__ == "__main__":
    sys.exit(main())
