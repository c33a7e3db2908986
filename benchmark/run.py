"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, their configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; ``harness.py`` finds each by
name.  The last line of standard output is the result as one JSON object;
the numbers compared with the plain reference, each beside its limit, are
the last lines of standard error.  Without as many CUDA devices as the cell
asks for, the run exits with an error and prints no result.
"""

import time

T_START = time.perf_counter()  # set-up runs from here to the window's start

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
