"""Start one process per rank, as torchrun does: each runs the same
command with RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT
set, and joins the group through mesh.init_distributed."""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

# the directory holding the arnerf_tpu_torch package, for the ranks' imports
PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


def free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world_size: int, port: int, env=None) -> dict:
    """`env` (default os.environ) with torchrun's variables for `rank`."""
    return dict(os.environ if env is None else env, RANK=str(rank),
                LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def launch(args, n: int, *, cpu: bool = False, timeout: float = None,
           env=None):
    """Run `python args...` as ranks 0..n-1 and wait for all of them. With
    `cpu`, each rank takes an equal share of the host's cores
    (OMP_NUM_THREADS, unless set). The first rank to fail, or the
    timeout, stops every rank and raises RuntimeError."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                          else []))
    if cpu:
        env.setdefault("OMP_NUM_THREADS",
                       str(max(1, (os.cpu_count() or 1) // n)))
    port = free_port()
    procs = [subprocess.Popen([sys.executable, *args],
                              env=rank_env(r, n, port, env))
             for r in range(n)]
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise RuntimeError(f"rank {bad[0][0]} of {n} exited with "
                                   f"code {bad[0][1]}")
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"{n} ranks still running after "
                                   f"{timeout} s")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
