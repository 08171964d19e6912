"""Import hygiene of the port: arnerf_tpu_torch and chip_smoke.py import
neither jax/jaxlib nor the JAX package `arnerf_tpu` (matched as a whole
module name: `arnerf_tpu_torch` itself is allowed), nor an image library
(cv2, imageio, PIL: the GPU machine has none; the port decodes with its own
native code), and importing the package builds no kernel and no decoder."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "arnerf_tpu")
IMAGE_LIBRARIES = ("cv2", "imageio", "PIL")
PORT_FILES = sorted(
    [p.relative_to(REPO).as_posix()
     for p in (REPO / "arnerf_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"])


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) \
                and getattr(node.func, "attr", getattr(node.func, "id", None)) \
                in ("import_module", "__import__") \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield node.lineno, str(node.args[0].value)


def test_forbidden_names_match_whole_modules():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("arnerf_tpu") and _forbidden("arnerf_tpu.ops.sh")
    assert not _forbidden("arnerf_tpu_torch")
    assert not _forbidden("arnerf_tpu_torch.ops.fused_head")
    assert not _forbidden("jaxtyping_like_name")


def test_port_file_list_is_complete():
    assert "arnerf_tpu_torch/ops/fused_head.py" in PORT_FILES
    assert "arnerf_tpu_torch/eval.py" in PORT_FILES
    assert "arnerf_tpu_torch/show_gui.py" in PORT_FILES
    assert (REPO / "chip_smoke.py").exists()


def test_port_file_list_holds_parallel_and_the_rtmv_prep():
    """The multi-GPU package and the RTMV prep are checked as every other
    module of the port (the parametrised tests below)."""
    for name in ("__init__", "mesh", "dp", "tp", "accounting", "launch"):
        assert f"arnerf_tpu_torch/parallel/{name}.py" in PORT_FILES
    assert "arnerf_tpu_torch/prepare_rtmv.py" in PORT_FILES
    assert "arnerf_tpu_torch/datasets/rtmv.py" in PORT_FILES


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_jax_or_reference_package_imports(rel):
    bad = [(line, mod) for line, mod in _imports(REPO / rel)
           if _forbidden(mod)]
    assert not bad, f"{rel} imports {bad}"


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_image_library_imports(rel):
    bad = [(line, mod) for line, mod in _imports(REPO / rel)
           if mod.split(".")[0] in IMAGE_LIBRARIES]
    assert not bad, f"{rel} imports {bad}"


def test_importing_the_package_builds_nothing(tmp_path):
    """Import every module of the port in a fresh interpreter with process
    creation disabled: no nvcc runs, no library loads, no jax arrives."""
    code = """
import importlib, pkgutil, subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a process was started while importing")
subprocess.Popen = refuse
import arnerf_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(arnerf_tpu_torch.__path__,
                                              "arnerf_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from arnerf_tpu_torch import build
assert not build._loaded, build._loaded
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "arnerf_tpu", "cv2",
                                    "imageio", "PIL"))
assert not bad, bad
print("imported", len(mods))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout
