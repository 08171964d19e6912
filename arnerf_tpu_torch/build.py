"""Build the port's native code at first use.

Each CUDA source `csrc/<name>.cu` is compiled by nvcc for sm_90a, and each
host source `csrc/<name>.cpp` (the image decoder) by the host C++ compiler
($CXX, else `c++`), into a shared library with a plain C interface, loaded
with ctypes. Libraries go to `build/arnerf_tpu_torch/` at the root of the
checkout, named by a digest of the source and flags, so an edited source is
never served a stale build. Importing this module builds nothing; a missing
compiler or a failed build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "arnerf_tpu_torch"
KERNEL_SOURCES = ("fused_head", "segment_sum", "hashgrid", "marching")
HOST_SOURCES = ("dataio",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_loaded = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(f"nvcc not found on PATH or in {cuda_home}/bin: the "
                       f"port's CUDA kernels cannot be built")


def host_compiler() -> str:
    """$CXX, else `c++` from PATH."""
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler ($CXX unset and no c++ on "
                           "PATH): the port's image decoder cannot be built")
    return cxx


def _source(name: str):
    """(source path, compiler flags) of `name`: host C++ or CUDA."""
    if name in HOST_SOURCES:
        return CSRC / f"{name}.cpp", HOST_FLAGS
    return CSRC / f"{name}.cu", NVCC_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=KERNEL_SOURCES) -> dict:
    """Compile every named source not built yet, all compiler processes
    started together. Returns {name: seconds} for what was compiled; the
    compiler's output (for nvcc the ptxas report: registers, shared memory,
    spills) is kept beside each library as `<library>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        src, flags = _source(name)
        compiler = host_compiler() if name in HOST_SOURCES else nvcc_path()
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: {proc.args[0]} exit "
                          f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("native build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
