"""The operation and byte counts, the roofline and mfu arithmetic on
hand-counted shapes, and the trace reader on a synthetic event list."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness, work
from portbench.trace import Trace

CFG = harness.Cell("synthetic_train").config


def test_portbench_flops_by_hand():
    # sigma 32x64 + 64x16 = 3072, rgb 32x64 + 64x64 + 64x3 = 6336 MACs
    assert work.sigma_macs(CFG) == 3072 and work.rgb_macs(CFG) == 6336
    assert work.field_flops(CFG, exact=False) == 18816
    # exact encode: 16 levels x 8 corners x (2 weight products + 2 MACs)
    assert work.field_flops(CFG, exact=True) == 18816 + 16 * 8 * 6
    assert work.train_flops(CFG, 1, 0) == 3 * 18816 + 32
    assert work.train_flops(CFG, 0, 10) == 10 * 2 * 3072
    assert work.view_flops(CFG, 2) == 2 * 19584


@pytest.mark.parametrize("bf16,bound_us", [(True, 15.96), (False, 73.6)])
def test_portbench_head_bound_by_hand(bf16, bound_us):
    # 2^18 rows: bf16 is bound by 204 bytes a row at 3.35 TB/s, f32 by
    # 18,816 FLOPs a row at 67 TFLOP/s (PERF.md's kernel table)
    got = work.head_bound_s(CFG, 1 << 18, bf16) * 1e6
    assert got == pytest.approx(bound_us, rel=2e-3)


def test_portbench_segment_sum_bound_by_hand():
    # an int32 row and two float32 values a table update
    assert work.segment_sum_bound_s(CFG, 3.35e12 / 12) == pytest.approx(1.0)


def _ev(name, dev, start, end, kernels=()):
    return SimpleNamespace(
        name=name, device_type=dev,
        kernels=[SimpleNamespace(duration=d) for d in kernels],
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def _trace(counters=None, units=2, window_s=1e-3):
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    kernels = [_ev("fused_head_tc_kernel<bf16>", cuda, 100, 200),
               _ev("segment_sum_kernel<2, true, true>", cuda, 150, 250),
               _ev("elementwise", cuda, 450, 500)]
    host = [_ev("field", cpu, 0, 600),
            _ev("aten::mm", cpu, 10, 20, kernels=[100.0]),
            # launched from the autograd thread while the span is open
            _ev("aten::add", cpu, 50, 60, kernels=[300.0]),
            _ev("aten::sum", cpu, 700, 710, kernels=[50.0]),
            _ev("cudaStreamSynchronize", cpu, 300, 500),
            _ev("field", cuda, 100, 600)] + kernels   # GPU-side annotation
    return Trace((kernels, window_s, units), (host, 1), counters or {}, CFG)


def test_portbench_trace_reads_spans_kernels_and_busy():
    t = _trace()
    # 0.4 ms of kernels launched inside the span, per host unit (1), in
    # units of the device part (2)
    assert t.span_ms("field") == pytest.approx(0.8)
    assert t.span_ms("backward") is None
    assert t.kernel_s("fused_head_tc_kernel") == (pytest.approx(1e-4), 1)
    assert t.kernel_s("fused_head_f32_kernel") is None
    # union of [100, 250] and [450, 500]: the overlap counts once
    assert t.busy_s == pytest.approx(200e-6)
    b = t.breakdown()
    assert b["device_ops"][0][0] == "fused_head_tc_kernel<bf16>"
    # the host waits in a synchronise through the middle of gap 250-450
    assert b["idle_gaps"] == [["cudaStreamSynchronize",
                               pytest.approx(200e-6)]]


def test_portbench_readers_on_a_synthetic_trace():
    t = _trace({"samples": 1 << 18, "rm_s": [10.0, 20.0], "grid_cells": 0})
    idle = harness.reader("train.idle_share")(t)
    assert idle == pytest.approx(80.0)
    assert harness.reader("train.samples_per_ray")(t) == 15.0
    roof = harness.reader("head_bf16_roofline")(t)
    assert roof == pytest.approx(100 * 15.96e-6 / 1e-4, rel=2e-3)
    mfu = harness.reader("train.mfu")(t)
    assert mfu == pytest.approx(100 * (1 << 18) * 56480 / (1e-3 * 989e12))
    assert harness.reader("head_f32_roofline")(t) is None
    assert harness.reader("train.join_ms")(t) is None
    assert harness.reader("view.field_ms")(t) == pytest.approx(0.4)


def test_portbench_readers_say_nothing_without_device_time():
    host = [_ev("field", DeviceType.CPU, 0, 10)]
    t = Trace((host, 1e-3, 1), (host, 1), {"samples": 100}, CFG)
    for m in ("train.idle_share", "train.mfu", "view.mfu", "view.field_ms",
              "head_bf16_roofline", "segment_sum_roofline"):
        assert harness.reader(m)(t) is None
