"""Run one cell of the benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON line (portbench/README.md)."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_environment()
    sys.exit(harness.main(sys.argv[1:], T_START))
