"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 lfmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout on a machine with the CUDA devices the cell
asks for. Prints the result as the last line of standard output and each
compared number beside its limit as the last lines of standard error.
Exits 2 without a result when the devices are missing, 3 when a module of
the JAX package (or JAX itself) was loaded by the end of the window.
"""

import os
import sys
import time

T_START = time.perf_counter()
# The port builds its kernels' libraries with nvcc into build/kernels of the
# checkout, a fixed path, so only the first run in a checkout builds them.
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from lfmbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
