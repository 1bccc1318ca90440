"""The benchmark of ``plnerf_torch`` on NVIDIA cards: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cells, their configurations, traffic
mixes and metrics are named in ``BENCHMARK.json``; ``lib/harness.py``
finds their files.  The last line of standard output is the result's JSON
object; the numbers that decide ``correct`` are the last lines of
standard error.  Without enough CUDA cards it prints no result and exits
with 3.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
# every build and kernel cache at a fixed path inside the checkout, set
# before torch is imported (the program's own kernels build into
# build/plnerf_torch/ of the checkout)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# import from the checkout's root, not from this script's folder
sys.path[:] = [p for p in sys.path
               if os.path.abspath(p or ".") != os.path.dirname(
                   os.path.abspath(__file__))]
sys.path.insert(0, ROOT)

if __name__ == "__main__":
    from portbench.lib import harness

    sys.exit(harness.main(t_start=T_START))
