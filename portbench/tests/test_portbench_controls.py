"""The controls, kept at a size a test run holds (the published widths,
few rays, small images and grid): the reference in the next precision
below the configuration's, put in the program's place, comes out not
correct under the cell's own limits (fp8 for the bf16
training cells, TF32 for the float32 view). On the card only: TF32 and
the card's kernels exist there alone. Run there with
`python -m pytest -m cuda portbench/tests -q`."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["synthetic_train", "synthetic_view"])
def test_portbench_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = tiny.cell(name, card=True)
    _, out = tiny.run(c, device="cuda:0")
    control = out["probes"]["control"]()
    rows, ok = harness.verdict({k: v for k, v in control.items()
                                if k not in c.not_compared}, c.limits)
    assert not ok, rows
