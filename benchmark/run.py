"""Runs one cell of the port's benchmark and prints its result as the last
line of standard output (see README.md):

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import sys
import time

T_START = time.monotonic()

if __name__ == "__main__":
    from pathlib import Path

    # the checkout's root, in place of this directory: the drivers import
    # the port and the benchmark as packages
    sys.path[0] = str(Path(__file__).resolve().parents[1])
    from benchmark.lib.harness import main

    raise SystemExit(main(t_start=T_START))
