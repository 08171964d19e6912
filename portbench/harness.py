"""The general part of a run: the command line, the cache directories, the
look for the card, finding a cell's files by name, the ranks of a cell on
several cards, the metrics a cell reports, the comparison's verdict and the
result line.

A cell is an entry of BENCHMARK.json's `workloads`: `config` names an entry
of `configs` (its `file`, the sizes as run), `traffic` the file
portbench/traffic/<traffic>.json (its "driver" names the module of
portbench/drivers/ that runs it, with the rest as that driver's
parameters), and portbench/workloads/<cell>.json holds the cell's limits
("limits") and the numbers it computes but does not compare
("not_compared": no control or fault reading separates them from sound
runs; PERF.md gives their readings).
A per-layer metric <name> is read by portbench/metrics/<name>.py, whose
read(trace) returns a number or None.
"""

import argparse
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
CACHE = HERE / ".cache"
FORBIDDEN = {"jax", "jaxlib", "flax", "arnerf_tpu"}


def set_environment():
    """Fixed cache directories inside the checkout, and NCCL kept off
    /dev/shm (the ranks of a host talk over NVLink peer to peer)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["NCCL_SHM_DISABLE"] = "1"
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path: Path):
    return json.loads(path.read_text())


class Cell:
    """A cell's entries and files, found by name."""

    def __init__(self, name: str, bench: dict = None, root: Path = HERE):
        bench = bench or load_json(root.parent / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the cells are "
                             f"{sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        self.chips = self.entry["chips"]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.root = root
        self.config = load_json(root.parent / conf["file"])
        self.traffic = load_json(root / "traffic"
                                 / f"{self.entry['traffic']}.json")
        limits = load_json(root / "workloads" / f"{name}.json")
        self.limits = limits["limits"]
        self.not_compared = set(limits.get("not_compared", ()))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", ())
                          or ("workloads" not in m and m["moves"] in moved)]

    def driver(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")


def reader(metric: str, root: Path = HERE):
    """The read() of portbench/metrics/<metric>.py."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None):
    """Loaded modules (or `names`) whose top-level name is JAX's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


class Ranks:
    """The processes of a cell on several cards: this process is rank 0
    and starts the others as `python3 -m <module> <argv>` with torchrun's
    variables; they rendezvous over TCP on a free port of localhost."""

    def __init__(self, chips: int, argv, module: str = "portbench.run"):
        child = os.environ.get("PORTBENCH_RANK")
        self.rank = int(child) if child else 0
        self.size = chips
        self.procs = []
        if chips > 1 and not child:
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            os.environ.update(WORLD_SIZE=str(chips), RANK="0",
                              LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(port))
            for r in range(1, chips):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, *argv],
                    cwd=CHECKOUT, stdout=subprocess.DEVNULL,
                    env=dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                             PORTBENCH_RANK=str(r))))

    def wait(self, timeout: float = 120.0) -> list:
        """Wait for the other ranks; returns their exit codes (a rank that
        has not ended by then is killed and reads -9)."""
        codes = []
        deadline = time.monotonic() + timeout
        for p in self.procs:
            try:
                codes.append(p.wait(max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                codes.append(-9)
        return codes


def verdict(numbers: dict, limits: dict):
    """[(name, value, limit)] and whether every number is at or under its
    limit; a number with no limit, or that is not finite, fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        lim = limits.get(name)
        good = lim is not None and value == value and value <= lim
        ok = ok and good
        rows.append((name, value, lim))
    return rows, ok and bool(rows)


def result_line(cell: Cell, out: dict, trace: int):
    """(the JSON object of the contract, with "checks" last; the rows
    compared, each (name, value, limit))."""
    metrics = {}
    if trace:
        t = out["trace"]
        for m in cell.per_layer:
            v = reader(m["name"], cell.root)(t)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out["metrics"][m["name"]]),
                                  "unit": m["unit"]}
    rows, ok = verdict({k: v for k, v in out["numbers"].items()
                        if k not in cell.not_compared}, cell.limits)
    if out.get("fault"):
        rows.append(("fault", out["fault"], None))
    line = {"correct": bool(ok and not out.get("fault")),
            "attempted": int(out["attempted"]), "failed": int(out["failed"]),
            "metrics": metrics, "device": out["device"]}
    if trace:
        line["breakdown"] = out["trace"].breakdown()
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    return line, rows


def device_info(dev, peaks, chips: int, trace_out=None) -> dict:
    """The result's "device": `peaks` are the ranks' memory peaks,
    `trace_out` the traced window's (busy s, wall s)."""
    import torch
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "count": chips, "memory_peak_bytes": int(max(peaks))}
    if trace_out is not None:
        info["busy_s"], info["window_s"] = trace_out
    return info


def main(argv, t_start: float):
    """Run one cell once on as many CUDA cards as it asks for."""
    args = parse(argv)
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{n} visible", file=sys.stderr)
        return 2
    from arnerf_tpu_torch import build
    if not os.environ.get("PORTBENCH_RANK"):
        build.build()              # before the other ranks start
    ranks = Ranks(cell.chips, argv)
    out = cell.driver().run(cell, args, ranks, t_start)
    codes = ranks.wait()
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    if ranks.rank != 0:
        return 0 if out is not None else 1
    if any(codes):
        print(f"portbench: rank exit codes {codes}", file=sys.stderr)
        return 1
    line, rows = result_line(cell, out, args.trace)
    for n, v, lim in rows:
        print(f"check {n}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
