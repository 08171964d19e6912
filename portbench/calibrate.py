"""Readings that set a cell's limits (PERF.md, "What decides correct"):

    python3 -m portbench.calibrate --workload <cell> --seeds a,b,c \
        [--seconds 2] [--probes]

runs the cell once a seed with a short window, in one process (and its
ranks), and prints one JSON line a seed: the program's compared numbers
(the lower readings) and, with --probes, the control's (the reference at
the precision below the configuration's, in the program's place) and
those of the faults planted in the reference (the upper readings).
"""

import gc
import json
import os
import sys
import time

from portbench import harness


def main(argv):
    import argparse
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", default="2")
    p.add_argument("--probes", action="store_true")
    a = p.parse_args(argv)
    cell = harness.Cell(a.workload)
    import torch
    from arnerf_tpu_torch import build
    if not os.environ.get("PORTBENCH_RANK"):
        build.build()
    for seed in a.seeds.split(","):
        t0 = time.perf_counter()
        args = harness.parse(["--workload", a.workload, "--seed", seed,
                              "--seconds", a.seconds])
        mine = ["--workload", a.workload, "--seeds", seed, "--seconds",
                a.seconds] + (["--probes"] if a.probes else [])
        ranks = harness.Ranks(cell.chips, mine, "portbench.calibrate")
        try:
            out = cell.driver().run(cell, args, ranks, t0)
            codes = ranks.wait()
            if ranks.rank != 0:
                return 0
            row = {"seed": int(seed), "program": out["numbers"],
                   "metrics": out["metrics"], "ranks": codes,
                   "fault": out.get("fault")}
            if a.probes:
                for k, f in out["probes"].items():
                    row[k] = f()
        except Exception as e:          # report the seed and go on
            ranks.wait(10)
            row = {"seed": int(seed), "error": repr(e)}
        print(json.dumps(row), flush=True)
        out = None
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    harness.set_environment()
    sys.exit(main(sys.argv[1:]))
