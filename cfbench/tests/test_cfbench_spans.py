"""The reductions of the program's spans (harness/spans.py) on hand-made
span records, section totals and profiler events: host ms per stage and
`Run`'s self time, the slowest frames' excess by stage, idle device time
intersected with nested and back-to-back stage ranges, the object slots'
host and device ms, the sums they must meet, the harness's own readers
unchanged by `step.*` ranges among the events; and the tool
(`trace_spans.py`) on the CPU."""

import dataclasses

import cfbench_paths  # noqa: F401
import pytest

import trace_spans
from harness import cell as cells
from harness import spans as sp
from harness import trace as tr
from cofusion_tpu_torch.utils.stopwatch import Span
from test_cfbench_trace import Ev, events


def _frame(tick, t0):
    """One frame's spans at ms offsets from t0, in ns: Run 0-100 holding
    preprocess 0-10 and 90-95, tracking 10-50, fuse/clean 50-80 (slots
    50-60, 60-70, 70-78) and the active-flag wait 82-86."""
    ms = 1_000_000

    def s(name, parent, a, b):
        return Span(name, parent, tick, (t0 + a) * ms, (t0 + b) * ms)

    return [
        s("step.preprocess", "Run", 0, 10), s("step.tracking", "Run", 10, 50),
        s("step.fuse_clean.slot0", "step.fuse_clean", 50, 60),
        s("step.fuse_clean.slot1", "step.fuse_clean", 60, 70),
        s("step.fuse_clean.slot2", "step.fuse_clean", 70, 78),
        s("step.fuse_clean", "Run", 50, 80), s("frame.active_readback", "Run", 82, 86),
        s("step.preprocess", "Run", 90, 95), s("Run", "", 0, 100),
    ]


SPANS = _frame(5, 0) + _frame(6, 200) + [Span("Run", "", 7, 400 * 10**6, 900 * 10**6)]


def test_per_frame_self_time():
    frames = sp.per_frame(SPANS, [5, 6, 7])
    assert sorted(frames) == [5, 6, 7]
    for tick in (5, 6):
        d = frames[tick]
        assert d == pytest.approx({"Run": 100.0, "preprocess": 15.0, "tracking": 40.0,
                                   "fuse_clean": 30.0, "other": 15.0})  # the wait and the glue
        assert sum(v for k, v in d.items() if k != "Run") == pytest.approx(d["Run"])
    assert frames[7] == pytest.approx({"Run": 500.0, "other": 500.0})
    assert sp.per_frame(SPANS, [9]) == {}


def test_slow_frames():
    slow = sp.slow_frames(SPANS, [5, 6, 7])
    # the slowest frame (7: Run 500, all of it outside the stages) against
    # the medians over the three frames
    assert slow == pytest.approx({"frames": 1, "Run": 400.0, "other": 485.0, "preprocess": -15.0,
                                  "tracking": -40.0, "fuse_clean": -30.0})
    assert sp.slow_frames(SPANS, [5]) is None


def test_totals_per_frame_and_objects():
    before = {"Run": (100.0, 1), "step.tracking": (40.0, 1), "Init": (50.0, 1)}
    after = {"Run": (300.0, 3), "step.tracking": (120.0, 3), "step.preprocess": (30.0, 4),
             "step.fuse_clean": (20.0, 2), "step.fuse_clean.slot0": (6.0, 2),
             "step.fuse_clean.slot1": (8.0, 2), "step.fuse_clean.slot2": (4.0, 2),
             "Init": (50.0, 1), "download": (9.0, 1), "frame.active_readback": (3.0, 1)}
    got = sp.totals_per_frame(before, after, 2)
    assert got == pytest.approx({"Run": 100.0, "step.tracking": 40.0, "step.preprocess": 15.0,
                                 "step.fuse_clean": 10.0, "step.fuse_clean.slot0": 3.0,
                                 "step.fuse_clean.slot1": 4.0, "step.fuse_clean.slot2": 2.0,
                                 "other": 35.0, "fuse_clean_objects": 6.0})
    # one slot, or none: no objects
    assert "fuse_clean_objects" not in sp.totals_per_frame({}, {"Run": (1.0, 1),
                                                                "step.fuse_clean.slot0": (1.0, 1)}, 1)


@dataclasses.dataclass
class Rec:
    start_us: float
    end_us: float
    stage: str = "tracking"


# two frames: Run 0-100 and 120-200 us; stages back to back, slots nested
RANGES = sorted([
    ("Run", 0.0, 100.0, 1), ("step.preprocess", 0.0, 10.0, 1), ("step.tracking", 10.0, 50.0, 1),
    ("step.fuse_clean", 50.0, 80.0, 1), ("step.fuse_clean.slot0", 50.0, 65.0, 1),
    ("step.fuse_clean.slot1", 65.0, 80.0, 1),
    ("Run", 120.0, 200.0, 1), ("step.tracking", 120.0, 190.0, 1),
    ("step.tracking", 0.0, 300.0, 2),  # another thread's: not the host loop's
], key=lambda r: r[1])
RECORDS = [Rec(5, 20), Rec(40, 45), Rec(60, 90), Rec(150, 160), Rec(170, 175, tr.METER),
           Rec(195, 250)]


def test_device_idle_intersection():
    # idle over [0, 200]: 0-5, 20-40, 45-60, 90-150, 160-195 (the meter's
    # record is not the program's work)
    idle = sp.idle_intervals(RECORDS, 0.0, 200.0)
    assert idle == [(0.0, 5), (20, 40), (45, 60), (90, 150), (160, 195)]
    got = {s: sp.device_idle_ms(RANGES, RECORDS, 2, s) for s in sp.STAGES + ("other",)}
    us = {"preprocess": 5, "tracking": 20 + 5 + 30 + 30, "fuse_clean": 10,
          "other": 10 + 20 + 5}  # tracking: 20-40, 45-50, 120-150, 160-190
    for s, v in us.items():
        assert got[s] == pytest.approx(v / 1e3 / 2), s
    assert got["segmentation"] is None and got["predict"] is None
    total = sp.idle_total_ms(RANGES, RECORDS, 2)
    assert total == pytest.approx(sum(e - s for s, e in idle) / 1e3 / 2)
    assert sum(v for v in got.values() if v is not None) == pytest.approx(total)
    assert sp.device_idle_ms([], RECORDS, 2, "tracking") is None


def test_merge_and_overlap():
    assert sp.merge([(5, 9), (0, 2), (1, 3), (9, 10), (4, 4)]) == [(0, 3), (5, 10)]
    assert sp.overlap_us([(0, 3), (5, 10)], [(2, 6), (8, 20)]) == pytest.approx(1 + 1 + 2)


def _with_program_ranges():
    """test_cfbench_trace's events with the program's function-scope ranges
    (host events only, as the profiler keeps them) around them."""
    us = 1000
    return events() + [
        Ev("Run", 0, 0, 125 * us, corr=900),
        Ev("step.tracking", 0, 1 * us, 100 * us, corr=901),
        Ev("step.fuse_clean", 0, 28 * us, 35 * us, corr=902),
        Ev("step.fuse_clean.slot0", 0, 29 * us, 30 * us, corr=903),
        Ev("step.fuse_clean.slot1", 0, 30 * us, 34 * us, corr=904),
    ]


def test_object_records_by_slot_range():
    evs = _with_program_ranges()
    ranges = sp.ranges_from_kineto(evs)
    assert [r[0] for r in ranges][:2] == ["Run", "step.tracking"]
    assert sp.slot_names(ranges) == ["step.fuse_clean.slot0", "step.fuse_clean.slot1"]
    recs = tr.records_from_kineto(evs, sp.slot_names(ranges))
    by = {r.name: r.stage for r in recs}
    # mul_kernel's launch (30-31 us) is inside slot1: an object slot's record
    assert by["mul_kernel"] == "step.fuse_clean.slot1" and by["add_kernel"] == "other"
    assert sp.objects_device_ms(recs, 2) == pytest.approx(20 / 1e3 / 2)
    assert sp.objects_device_ms([r for r in recs if r.name != "mul_kernel"], 2) is None


def test_existing_readers_unchanged_by_program_ranges():
    stages = ["tracking", "preprocess"]
    plain = tr.records_from_kineto(events(), stages)
    ranged = tr.records_from_kineto(_with_program_ranges(), stages)
    assert plain == ranged
    for recs in (plain, ranged):
        rec = tr.TraceRecords(frames=2, span_us=200.0, records=recs, host_enqueue_ms=[3.0],
                              splat_bounds=[], bilateral_inputs=[], max_depth=4.5)
        vals = [cells.metric_reader(n)[0](rec, cells.metric_reader(n)[1])
                for n in ("stage_ms.tracking", "stage_launches.preprocess", "launches_per_frame",
                          "device_busy_ms", "device_idle_pct")]
        assert vals == [0.01, 0.5, 1.0, pytest.approx(0.02), pytest.approx(80.0)]


@pytest.mark.parametrize("trace", [0, 1])
def test_trace_spans_dry_run(capsys, trace):
    """The tool end to end on the CPU's dry-run sizes (nothing profiled
    there): host ms per stage from the section totals, beside the span
    records, with and without the stage ranges of a traced run."""
    import json

    assert trace_spans.main(["--workload", "static.orbit", "--seed", str(2**31 + 5), "--seconds",
                             "1", "--trace", str(trace), "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    host = res["host_ms"]
    assert res["correct"] is True and res["frames_read"] >= 1
    assert host["step.tracking"] > 0 and "fuse_clean_objects" not in host
    assert sum(v for k, v in host.items() if sp.stage_of(k)) + host["other"] \
        == pytest.approx(host["Run"])
    assert host["Run"] <= res["enqueue_ms"]
    assert "device_idle_ms" not in res
    assert res["spans_recorded"] > 0 and res["spans_dropped"] == 0
    assert (res["slow_frames"] is None) == (res["frames_read"] < 2)
