"""What the benchmark loads: in a fresh interpreter, importing the harness
(and the drivers it runs) loads neither JAX nor the JAX package, and the
reference loads nothing of the program either. Top-level names are
compared whole: the port's name begins with the JAX package's."""

import json
import subprocess
import sys

import pytest

from portbench import harness

PROBE = ("import json, sys\n"
         "for m in sys.argv[1:]:\n"
         "    __import__(m)\n"
         "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")


def _top_level(*modules):
    out = subprocess.run([sys.executable, "-c", PROBE, *modules],
                         cwd=harness.CHECKOUT, capture_output=True,
                         text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("modules", [
    ("portbench.run", "portbench.calibrate"),
    ("portbench.drivers.train", "portbench.drivers.view",
     "arnerf_tpu_torch.training.trainer", "arnerf_tpu_torch.rendering")])
def test_portbench_loads_no_jax(modules):
    assert not _top_level(*modules) & {"jax", "jaxlib", "flax",
                                       "arnerf_tpu"}


def test_portbench_reference_loads_nothing_of_the_program():
    mods = _top_level("portbench.reference", "portbench.reference.train",
                      "portbench.reference.view",
                      "portbench.reference.weights")
    assert not mods & {"jax", "jaxlib", "flax", "arnerf_tpu",
                       "arnerf_tpu_torch"}


def test_portbench_forbidden_names_are_whole_names():
    assert harness.forbidden_modules(
        ["arnerf_tpu_torch.ops", "jaxlib_x", "flaxen", "portbench"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "arnerf_tpu.ops.hashgrid", "flax"]) == \
        ["arnerf_tpu", "flax", "jax"]
