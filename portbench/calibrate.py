"""The readings the check's limits are set from, on the card at the cell's
own size, many seeds in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...]

For each of ``--seeds`` the program's checked steps against the float32
reference (the lower readings); for each of ``--control-seeds`` the
control, the reference computed in bfloat16 in the program's place,
against the float32 reference (the upper readings); for each of
``--fault-seeds`` the program with each fault of faults.py planted. One
JSON line each. The benchmark's own runs do not run this.
"""

import time

CLOCK = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(workload, seed, device, control=False, fault=None,
             overrides=None, seconds=0.5):
    import torch

    from portbench import runner
    from portbench.cells import common

    kept = {}

    def keep(cell, timed):
        kept["cell"], kept["loader"] = cell, timed.loader
        if fault is not None:
            fault(cell, timed)

    result = runner.run_cell(workload, seed, seconds, False, device,
                             time.perf_counter(), overrides=overrides,
                             fault=keep)
    out = {k: v["value"] for k, v in result["checks"].items()}
    if control:
        cell, loader_kept = kept["cell"], kept["loader"].kept
        ref = cell.reference_readings(loader_kept, torch.float32)
        low = cell.reference_readings(loader_kept, torch.bfloat16)
        out = dict(out, **{"control_" + k: v for k, v in
                           common.compare(low, ref).items()})
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from portbench import graph
    from portbench.faults import FAULTS
    build, memo = graph.primekg_edges, {}

    def cached(*args):
        key = json.dumps(args, sort_keys=True)
        if key not in memo:
            memo[key] = build(*args)
        return memo[key]

    graph.primekg_edges = cached
    for seed in args.seeds:
        print(json.dumps({"kind": "program", "seed": seed,
                          **readings(args.workload, seed, args.device)}),
              flush=True)
    for seed in args.control_seeds:
        print(json.dumps({"kind": "control", "seed": seed,
                          **readings(args.workload, seed, args.device,
                                     control=True)}), flush=True)
    for seed in args.fault_seeds:
        for name, fault in FAULTS.items():
            print(json.dumps({"kind": name, "seed": seed,
                              **readings(args.workload, seed, args.device,
                                         fault=fault)}), flush=True)


if __name__ == "__main__":
    main()
