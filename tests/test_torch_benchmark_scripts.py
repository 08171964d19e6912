"""Every benchmarking/*.sh flag set parses through the port's option parser
(arnerf_tpu_torch.opt) and names a dataset in the port's registry: the
seven benchmark scripts run the same flags against either package's train
entry point. The flags come from each script's `python train.py` calls,
shell variables replaced with placeholders, as tests/test_benchmark_scripts.py
extracts them for the JAX package's parser. One case per script.
"""

import glob
import os

import pytest

from arnerf_tpu_torch.datasets import dataset_dict, unported_reason
from arnerf_tpu_torch.opt import get_opts
from tests.test_benchmark_scripts import extract_invocations

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = sorted(glob.glob(os.path.join(ROOT, "benchmarking", "*.sh")))


def test_every_benchmark_script_has_a_case():
    assert len(SCRIPTS) == 7, SCRIPTS


@pytest.mark.parametrize("script", SCRIPTS,
                         ids=[os.path.basename(s) for s in SCRIPTS])
def test_benchmark_script_flags_parse_in_the_port(script):
    calls = extract_invocations(script)
    assert calls, f"no train.py invocation found in {script}"
    for argv in calls:
        hp = get_opts(argv)      # argparse exits on an unknown flag
        assert hp.dataset_name in dataset_dict, hp.dataset_name
        assert not unported_reason(hp.dataset_name), hp.dataset_name
        assert hp.batch_size > 0 and hp.num_epochs > 0 and hp.lr > 0
        assert hp.device == "cuda"      # the scripts run on the card
