"""Each cell run at a tiny size on the CPU against the reference: sound
runs come out correct under limits set for the tiny size (the chip's limits
are the cells' own, portbench/workloads/), and each fault the cell can
have, planted in the program, makes `correct` come out false."""

import pytest

from portbench.tests import tiny

# limits of the tiny CPU size: the CPU rounds the same bf16 operands but
# sums in other orders than the card; fault readings sit far above
TINY_LIMITS = {"train": {"start.loss_gap": 1e-3, "start.grad_gap": 1e-2,
                         "start.update_gap": 2e-2, "start.grid_flips": 2e-2,
                         "start.demand_gap": 1e-2, "timed.loss_gap": 1e-3,
                         "start.update_median": 2e-2,
                         "timed.update_median": 2e-2,
                         "timed.grad_gap": 5e-2, "timed.update_gap": 2e-2,
                         "timed.grid_flips": 2e-2, "timed.demand_gap": 1e-2},
               "view": {"rgb_p99": 1e-4, "rgb_mean": 1e-4}}


def _limited(name):
    c = tiny.cell(name)
    c.limits = TINY_LIMITS[c.traffic["driver"]]
    return c


@pytest.mark.parametrize("name,trace", [("synthetic_train", 0),
                                        ("synthetic_train", 1),
                                        ("synthetic_view", 0),
                                        ("synthetic_view", 1)])
def test_portbench_cell_runs_correct_on_the_cpu(name, trace, monkeypatch):
    line, out = tiny.run(_limited(name), trace=trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    want = "per_layer" if trace else "end_to_end"
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in
                                        getattr(tiny.cell(name), want)}
        assert all(m["value"] > 0 for m in line["metrics"].values())


@pytest.mark.parametrize("name,fault", [
    ("synthetic_train", "state_unchanged"),
    ("synthetic_train", "half_batch"),
    ("synthetic_view", "answer_altered"),
    ("synthetic_view", "half_rays"),
    ("synthetic_view", "encode_hash")])
def test_portbench_fault_makes_correct_false(name, fault, monkeypatch):
    from arnerf_tpu_torch import rendering
    from arnerf_tpu_torch.ops import hashgrid
    from arnerf_tpu_torch.training import trainer
    monkeypatch.setattr(trainer.Adam, "step", trainer.Adam.step)
    monkeypatch.setattr(trainer, "nerf_loss", trainer.nerf_loss)
    monkeypatch.setattr(rendering, "render_test", rendering.render_test)
    monkeypatch.setattr(hashgrid, "_PRIME_Y", hashgrid._PRIME_Y)
    monkeypatch.setattr(hashgrid, "_PRIME_Z", hashgrid._PRIME_Z)
    tiny.FAULTS[fault]()
    line, _ = tiny.run(_limited(name))
    assert not line["correct"]


@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_portbench_four_ranks_on_the_cpu(fault):
    """The four-rank cell over gloo: sound, it is correct against the
    reference's step over the union of the ranks' rays; without the
    exchange between ranks it is not."""
    c = _limited("unbounded_train_dp4")
    line = tiny.run_ranks("unbounded_train_dp4", 4, fault)
    from portbench import harness
    rows, ok = harness.verdict({k: v["value"] for k, v in
                                line["checks"].items()}, c.limits)
    assert ok == (fault is None), line["checks"]
