"""Run one cell of the benchmark of clipper_tpu_torch on this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout: the cell is an entry of ``workloads`` in
``BENCHMARK.json``. The last line of standard output is the result as one
JSON object; the numbers that decide ``correct`` are the last lines of
standard error. Exits non-zero, and prints no result, where the machine
has no CUDA card or fewer than the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from benchmark import runner
    os.environ.update(runner.cache_env(ROOT))
    sys.exit(runner.main(sys.argv[1:], T_START))
