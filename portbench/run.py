"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA
devices; prints the result as the last line of standard output (see
runner.py) and the numbers the check compared, each beside its limit, as
the last lines of standard error.
"""

import time

CLOCK = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# caches the program or torch may write go inside the checkout, at fixed
# paths; transformers must not load JAX
for key, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(key, os.path.join(CACHE, sub))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.runner import main
    sys.exit(main(sys.argv[1:], CLOCK))
