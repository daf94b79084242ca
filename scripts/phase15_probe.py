"""Phase 15 of chip_smoke.py (the parallel strategies) alone, on the card:

    python scripts/phase15_probe.py             # legs (a), (b) and (c)
    python scripts/phase15_probe.py --dp-only   # (a)'s dp step: its check
                                                # against train_step, timing
    python scripts/phase15_probe.py --tp-only   # (c): the dp × tp legs

It builds the kernels and phase 2's PrimeKG++-scale data module as
chip_smoke.py does, then runs ``parallel_phase`` (or ``dp_stage_c`` on a
one-rank NCCL group, or phase 8's neighbour batches and ``tp_phase``)
and prints the numbers as one ``P15 {json}`` line.
The ``chip_smoke`` it imports is the first on the path: to compare two
trees on one card, run it in turns (A, B, B, A) with ``PYTHONPATH`` set
to each tree's root.
"""

import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

os.environ["BIOMEDKG_SYNTHETIC_SCALE"] = "primekg"
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    dev = torch.device("cuda")
    libs = (cs.segsum.LIBRARY, cs.negscore.LIBRARY, cs.relmm.LIBRARY,
            cs.flashnce.LIBRARY)
    with ThreadPoolExecutor(len(libs) + 1) as pool:
        builds = [pool.submit(lib.lib) for lib in libs]
        sampler = pool.submit(cs.native.get_lib)
        for future in builds:
            future.result()
        sampler.result()
    with tempfile.TemporaryDirectory() as tmp:
        data = dict(cs.PRIMEKG_DATA, data_dir=os.path.join(tmp, "primekg"))
        dm = cs.PrimeKGModule(**data, seed=cs.SEED)
        dm.setup(stage="split")
        if sys.argv[1:] == ["--dp-only"]:
            torch.distributed.init_process_group(
                "nccl", init_method=f"tcp://127.0.0.1:{cs.free_port()}",
                rank=0, world_size=1, device_id=torch.device("cuda", 0))
            try:
                _, numbers = cs.dp_stage_c(dm, dev, cs.make_mesh(dp=1, tp=1))
            finally:
                torch.distributed.destroy_process_group()
        else:
            gcl_dm, _, host = cs.gcl_batches(dev, tmp)
            gcl_host = (gcl_dm.graph.x, host[:2])
            if sys.argv[1:] == ["--tp-only"]:
                numbers = cs.tp_phase(dm, gcl_host, tmp)
            else:
                _, numbers = cs.parallel_phase(dm, dev, data, gcl_host)
    print("P15 " + json.dumps(numbers, default=str), flush=True)


if __name__ == "__main__":
    main()
