"""The engine's Stopwatch as the frame step's span recorder
(cofusion_tpu_torch/utils/stopwatch.py, the `step.*` sections of
engine.py), on the CPU at 160x128, 3 frames a path (2 under '-rl -cl'):

  * every `step.*` stage section occurs once a frame (`step.preprocess`
    twice: the frame's filter and the next frame's SO(3) reference), and
    `step.fuse_clean.slot<m>` once per slot, in the static path under
    '-rl -cl' (with `step.reloc` and `step.loop`, between segmentation and
    fuse/clean; 16 graph nodes keep the CPU's dense solve small), the CRF
    multi-model path and the '-p' path;
  * each span has its parent section and its frame's tick, and the stage
    spans of a frame sum to no more than its `Run`;
  * poses, counts and maps are bit-identical with the switch on and off;
  * with the switch on, a torch.profiler trace holds the `step.*` ranges,
    and with it off none;
  * the Stopwatch alone: host totals always, spans only while on, the
    nested parent, the tick and the bounded list.

Three tests in all: the tier-1 run's collected count must stay where
xdist's first dispatch keeps `tests/test_hot_params.py`'s module fixture
and its readers on one worker (ROADMAP.md, "Tier-1 verify").
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.engine import CoFusion
from cofusion_tpu_torch.io.synthetic import make_sequence
from cofusion_tpu_torch.utils import stopwatch
from cofusion_tpu_torch.utils.stopwatch import Stopwatch

torch.set_num_threads(1)
CAM = tcfg.CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
FRAMES = {"static": 2, "crf": 3, "gt_pose": 3}
STAGES = ("step.preprocess", "step.tracking", "step.segmentation", "step.reloc", "step.loop",
          "step.fuse_clean", "step.predict")
# sections a frame, by path (the frame's first call is Init)
PER_FRAME = {
    "static": {"step.preprocess": 2, "step.tracking": 1, "step.segmentation": 1,
               "step.reloc": 1, "step.loop": 1, "step.fuse_clean": 1, "step.predict": 1},
    "crf": {"step.preprocess": 2, "step.tracking": 1, "step.segmentation": 1,
            "step.fuse_clean": 1, "step.predict": 1},
    "gt_pose": {"step.preprocess": 2, "step.fuse_clean": 1},
}
SLOTS = {"static": 1, "crf": 3, "gt_pose": 3}


def _engine(path):
    M = SLOTS[path]
    cfg = tcfg.CoFusionConfig(camera=CAM, max_models=M, max_surfels=1 << 15,
                              active_surfels=1 << 14, object_active_surfels=1 << 12,
                              deform_nodes=16)
    loop = path == "static"
    return CoFusion(cfg, fusion_params=tcfg.FusionParams(depth_cutoff=4.5),
                    enable_multi_model=M > 1, enable_relocalization=loop, close_loops=loop,
                    device="cpu")


def _frames(path):
    n = FRAMES[path]
    frames, gt, _ = make_sequence(CAM, n, kind="orbit", moving_object=path == "crf")
    if path == "crf":
        frames = [dict(f, mask=None) for f in frames]  # no masks: the CRF segments
    return frames, gt if path == "gt_pose" else [None] * n


def _run(path, spans_on, profile_last=False):
    eng = _engine(path)
    eng.sw.spans_on = spans_on
    prof = None
    for k, (f, p) in enumerate(zip(*_frames(path))):
        if profile_last and k == FRAMES[path] - 1:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                eng.process_frame(f, gt_pose=p)
        else:
            eng.process_frame(f, gt_pose=p)
    return eng, prof


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [leaf for item in x for leaf in _leaves(item)]
    return []


def _by_tick(spans):
    out = {}
    for s in spans:
        out.setdefault(s.tick, []).append(s)
    return out


def _stopwatch_alone(monkeypatch):
    monkeypatch.setattr(stopwatch, "MAX_SPANS", 2)
    sw = Stopwatch()
    with sw.section("a"):
        pass
    assert sw.totals()["a"][1] == 1 and sw.spans() == [] and sw.timings()["a"] >= 0
    sw.spans_on, sw.tick = True, 7
    with sw.section("a"):
        with sw.section("b"):
            pass
    with sw.section("c"):
        pass
    assert [(s.name, s.parent, s.tick) for s in sw.spans()] == [("b", "a", 7), ("a", "", 7)]
    assert sw.dropped == 1 and sw.totals()["c"] == (sw.timings()["c"], 1)
    assert "a " in sw.report()
    assert sw.report({"g": {"x": 1, "y": 2}}).endswith("\ng: x=1 y=2")


@pytest.mark.parametrize("path", ["static", "crf", "gt_pose"])
def test_step_spans_and_outputs_bit_identical(path, monkeypatch):
    _stopwatch_alone(monkeypatch)
    monkeypatch.undo()
    off, prof_off = _run(path, False, profile_last=path == "gt_pose")
    on, prof_on = _run(path, True, profile_last=path == "gt_pose")

    # the switch changes nothing the step computes
    a, b = _leaves(off.state), _leaves(on.state)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    pa, pb = off.materialized_pose_log(), on.materialized_pose_log()
    assert [t for t, _ in pa] == [t for t, _ in pb]
    for (_, x), (_, y) in zip(pa, pb):
        np.testing.assert_array_equal(x, y)
    assert not off.sw.spans()

    frames = _by_tick(on.sw.spans())
    assert sorted(frames) == list(range(1, FRAMES[path] + 1))
    assert [s.name for s in frames[1]] == ["Init", "Run"]
    M = SLOTS[path]
    for tick in range(2, FRAMES[path] + 1):
        spans = frames[tick]
        names = [s.name for s in spans]
        want = dict(PER_FRAME[path], Run=1, **{f"step.fuse_clean.slot{m}": 1 for m in range(M)})
        assert {n: names.count(n) for n in set(names)} == want, tick
        tops = [s.name for s in spans if s.parent == "Run"]
        assert tops.index("step.tracking" if path != "gt_pose" else "step.preprocess") \
            < tops.index("step.fuse_clean")
        if path == "static":
            assert tops.index("step.segmentation") < tops.index("step.reloc") \
                < tops.index("step.loop") < tops.index("step.fuse_clean")
        run = next(s for s in spans if s.name == "Run")
        for s in spans:
            want_parent = ("" if s.name == "Run" else "step.fuse_clean"
                           if s.name.startswith("step.fuse_clean.slot") else "Run")
            assert s.parent == want_parent, s
            assert run.start_ns <= s.start_ns <= s.end_ns <= run.end_ns, s
        stages = sum(s.end_ns - s.start_ns for s in spans if s.name in STAGES)
        assert 0 < stages <= run.end_ns - run.start_ns
        slots = sum(s.end_ns - s.start_ns for s in spans if s.name.startswith("step.fuse_clean.slot"))
        fuse = next(s for s in spans if s.name == "step.fuse_clean")
        assert slots <= fuse.end_ns - fuse.start_ns
    # the always-on totals count every section, on or off
    assert off.sw.totals()["Run"][1] == on.sw.totals()["Run"][1] == FRAMES[path]
    assert "step.tracking" in off.sw.totals() or path == "gt_pose"
    assert "odom+fuse" not in on.sw.totals()

    if prof_on is not None:
        def ranges(prof):
            return {e.name() for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("step.")}
        assert ranges(prof_on) == set(PER_FRAME[path]) | {f"step.fuse_clean.slot{m}" for m in range(M)}
        assert ranges(prof_off) == set()

