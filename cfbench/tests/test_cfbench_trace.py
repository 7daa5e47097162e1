"""Stage attribution, busy time and the breakdown on hand-made profiler
events: each device record lands in the innermost stage range open at its
launch, the meter's records in none."""

import cfbench_paths  # noqa: F401
import pytest
import torch

from harness import trace as tr


class Ev:
    def __init__(self, name, dev, start, end, corr=0, linked=0, tid=1):
        self._n, self._d, self._s, self._e = name, dev, start, end
        self._c, self._l, self._t = corr, linked, tid

    def name(self):
        return self._n

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def start_thread_id(self):
        return self._t


def events():
    us = 1000
    return [
        Ev("tracking", 0, 0, 100 * us, corr=1),
        Ev("preprocess", 0, 10 * us, 20 * us, corr=2),          # nested inside tracking
        Ev("aten::add", 0, 12 * us, 13 * us, corr=3),
        Ev("cudaLaunchKernel", 0, 12 * us, 13 * us, corr=1001),
        Ev("add_kernel", 1, 50 * us, 60 * us, corr=1001, linked=3),
        Ev("aten::mul", 0, 30 * us, 31 * us, corr=4),
        Ev("cudaLaunchKernel", 0, 30 * us, 31 * us, corr=1002),
        Ev("mul_kernel", 1, 60 * us, 80 * us, corr=1002, linked=4),
        Ev("tracking", 1, 40 * us, 90 * us),                      # the device's projection
        Ev(tr.METER, 0, 85 * us, 95 * us, corr=5),
        Ev("cudaLaunchKernel", 0, 86 * us, 87 * us, corr=1003),
        Ev("sum_kernel", 1, 100 * us, 105 * us, corr=1003, linked=5),
        Ev("aten::copy_", 0, 120 * us, 121 * us, corr=6),
        Ev("cudaMemcpyAsync", 0, 120 * us, 121 * us, corr=1004),
        Ev("Memcpy HtoD (Pageable -> Device)", 1, 130 * us, 140 * us, corr=1004, linked=6),
    ]


def test_innermost_stage_meter_and_other():
    recs = tr.records_from_kineto(events(), ["tracking", "preprocess"])
    by = {r.name: r for r in recs}
    assert set(by) == {"add_kernel", "mul_kernel", "sum_kernel", "Memcpy HtoD (Pageable -> Device)"}
    assert by["add_kernel"].stage == "preprocess" and by["add_kernel"].host_op == "aten::add"
    assert by["mul_kernel"].stage == "tracking"
    assert by["sum_kernel"].stage == tr.METER
    assert by["Memcpy HtoD (Pageable -> Device)"].stage == "other"
    assert not by["Memcpy HtoD (Pageable -> Device)"].is_kernel
    counted = tr.counted(recs)
    assert len(counted) == 3
    assert tr.union_us(counted) == pytest.approx(10 + 20 + 10)  # 50-80 and 130-140 us


def test_readers_add_up_and_breakdown():
    recs = tr.records_from_kineto(events(), ["tracking", "preprocess"])
    rec = tr.TraceRecords(frames=2, span_us=200.0, records=recs, host_enqueue_ms=[3.0, 5.0],
                          splat_bounds=[], bilateral_inputs=[], max_depth=4.5)
    from harness import cell as cells

    vals = {}
    for name in ("stage_ms.tracking", "stage_ms.preprocess", "stage_ms.other", "launches_per_frame",
                 "stage_launches.tracking", "device_busy_ms", "device_idle_pct", "host_enqueue_ms",
                 "stage_ms.segmentation", "kernel_roofline_pct.splat_window"):
        read, arg = cells.metric_reader(name)
        vals[name] = read(rec, arg)
    total_ms = sum(r.end_us - r.start_us for r in tr.counted(recs)) / 1e3 / 2
    assert vals["stage_ms.tracking"] + vals["stage_ms.preprocess"] + vals["stage_ms.other"] == \
        pytest.approx(total_ms)
    assert vals["launches_per_frame"] == 1.0 and vals["stage_launches.tracking"] == 0.5
    assert vals["device_busy_ms"] == pytest.approx(0.02)
    assert vals["device_idle_pct"] == pytest.approx(80.0)
    assert vals["host_enqueue_ms"] == 4.0
    assert vals["stage_ms.segmentation"] is None
    assert vals["kernel_roofline_pct.splat_window"] is None
    b = tr.breakdown(recs, 2)
    assert b["device_ops"][0] == ["tracking:aten::mul", pytest.approx(10e-6)]
    assert len(b["idle_gaps"]) >= 1 and all(len(g) == 2 for g in b["idle_gaps"])


def test_stage_wrapper_ranges_and_restores():
    import types

    mod = types.ModuleType("cfbench_fake_stage_mod")
    mod.f = lambda x: x + 1
    import sys

    sys.modules[mod.__name__] = mod
    w = tr.StageWrapper({"s": [f"{mod.__name__}:f", f"{mod.__name__}:missing"]})
    orig = mod.f
    assert w.install() == [f"{mod.__name__}:missing"]
    assert mod.f is not orig and mod.f(1) == 2
    w.restore()
    assert mod.f is orig
