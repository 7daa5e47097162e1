"""The traced run: stage ranges, the profiler over a fixed number of frames,
and the reduction of its device records to what the metric readers read.

Stage ranges are the benchmark's own.  `StageWrapper` replaces each target
function (a "module:attribute" of the program, looked up by the engine at
call time) with one that runs it inside `torch.profiler.record_function`
named after the stage, and puts the originals back on `restore`.  Every
device record is attributed to the innermost stage range that was open on
the host when its launch was issued; records under the harness's own meter
range are left out of every number.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import importlib
from collections import defaultdict

METER = "cfbench.meter"


class StageWrapper:
    def __init__(self, stages: dict):
        self.stages = stages
        self._saved = []

    def install(self) -> list[str]:
        """Wrap every target; returns the targets that are missing (their
        stage then reads nothing)."""
        from torch.profiler import record_function

        missing = []
        for stage, targets in self.stages.items():
            for target in targets:
                mod_name, _, attr = target.partition(":")
                try:
                    mod = importlib.import_module(mod_name)
                    fn = getattr(mod, attr)
                except (ImportError, AttributeError):
                    missing.append(target)
                    continue

                def ranged(*a, _fn=fn, _stage=stage, **kw):
                    with record_function(_stage):
                        return _fn(*a, **kw)

                self._saved.append((mod, attr, fn))
                setattr(mod, attr, functools.wraps(fn)(ranged))
        return missing

    def restore(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()


class SplatMeter:
    """Counts of each window-splat launch's inputs for its roofline bound,
    taken as device scalars under the meter range while `on` (no host
    read inside the window) and read once the window has closed."""

    def __init__(self):
        self.on = False
        self.rows = []
        self._saved = None

    def install(self):
        import torch
        import torch.nn.functional as F
        from torch.profiler import record_function

        mod, attr = importlib.import_module("cofusion_tpu_torch.ops.cuda_splat"), "splat_window"
        orig = getattr(mod, attr)
        meter = self

        @functools.wraps(orig)
        def metered(cand_pos, cand_norm, cand_rad, cand_valid, r, cam_tup):
            out = orig(cand_pos, cand_norm, cand_rad, cand_valid, r, cam_tup)
            if meter.on:
                with record_function(METER):
                    k = 2 * int(r) + 1
                    v = cand_valid.to(torch.float32)[:, None]
                    taps = F.avg_pool2d(v, k, stride=1, padding=int(r), count_include_pad=True)
                    meter.rows.append((cand_valid.numel(), v.sum(), taps.sum() * (k * k)))
            return out

        self._saved = (mod, attr, orig)
        setattr(mod, attr, metered)

    def restore(self) -> None:
        if self._saved:
            mod, attr, orig = self._saved
            setattr(mod, attr, orig)
            self._saved = None

    def read(self) -> list[tuple[int, int, int]]:
        return [(int(n), int(round(float(v))), int(round(float(t)))) for n, v, t in self.rows]


@dataclasses.dataclass
class DeviceRecord:
    name: str
    start_us: float
    end_us: float
    stage: str          # innermost stage range at launch, "other" outside all
    host_op: str        # the host event the launch is linked to
    is_kernel: bool     # False for memory copies and sets


@dataclasses.dataclass
class TraceRecords:
    """What the metric readers read from one traced run."""

    frames: int                      # frames profiled
    span_us: float                   # host-clock length of the profiled span
    records: list                    # DeviceRecord of the profiled span
    host_enqueue_ms: list            # host ms per process_frame call (unprofiled frames)
    splat_bounds: list               # (n_px, n_valid, n_tests) per metered splat launch
    bilateral_inputs: list           # depth images the profiled frames filtered
    max_depth: float                 # the bilateral's depth cutoff


def _ns(ev, which: str) -> float:
    return float(getattr(ev, f"{which}_ns")())


def _is_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


def records_from_kineto(events, stage_names) -> list:
    """DeviceRecords from the profiler's raw events: each device record is
    linked to its launch (the runtime call of the same correlation id, else
    the host op it is linked to) and given the innermost range named in
    `stage_names` (or the meter's) that was open at that moment on the
    launching thread."""
    ranged = set(stage_names) | {METER}
    cpu, runtime, ranges = {}, {}, defaultdict(list)
    devs = []
    for ev in events:
        name = ev.name()
        if _is_device(ev):
            if name in ranged:
                continue  # the device's projection of a host range
            devs.append(ev)
            continue
        cid = ev.correlation_id()
        if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
            runtime[cid] = ev
        else:
            cpu[cid] = ev
        if name in ranged:
            ranges[ev.start_thread_id()].append((_ns(ev, "start"), _ns(ev, "end"), name))
    index = {}
    for tid, rs in ranges.items():
        rs.sort()
        index[tid] = ([r[0] for r in rs], rs)

    def innermost(tid, t):
        if tid not in index:
            return "other"
        starts, rs = index[tid]
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, -1, -1):  # the latest-starting range that still holds t
            if rs[j][1] >= t:
                return rs[j][2]
        return "other"

    out = []
    for ev in devs:
        launch = runtime.get(ev.correlation_id())
        op_ev = cpu.get(ev.linked_correlation_id())
        host = launch or op_ev
        if host is None:
            stage, op = "other", ""
        else:
            stage = innermost(host.start_thread_id(), _ns(host, "start"))
            op = (op_ev or host).name()
            if op in ranged:
                stage = op
        name = ev.name()
        out.append(DeviceRecord(name, _ns(ev, "start") / 1e3, _ns(ev, "end") / 1e3, stage, op,
                                not name.startswith(("Memcpy", "Memset"))))
    out.sort(key=lambda r: r.start_us)
    return out


def counted(records) -> list:
    """The records every metric counts: all but the meter's own."""
    return [r for r in records if r.stage != METER]


def union_us(records, lo: float | None = None, hi: float | None = None) -> float:
    """Length of the union of the records' intervals (clipped to [lo, hi])."""
    total, cur_s, cur_e = 0.0, None, None
    for r in sorted(records, key=lambda r: r.start_us):
        s, e = r.start_us, r.end_us
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def breakdown(records, frames: int, top: int = 10) -> dict:
    """The device operations that took most time per frame, by the stage and
    host op that launched them, and the device's idle gaps per frame grouped
    by what the host was launching after them (the next record's stage and
    host op), each as [name, seconds]."""
    recs = counted(records)
    by_name = defaultdict(float)
    for r in recs:
        by_name[f"{r.stage}:{r.host_op or r.name[:60]}"] += (r.end_us - r.start_us) / 1e6 / frames
    gaps = defaultdict(float)
    cur_e = None
    for r in sorted(recs, key=lambda r: r.start_us):
        if cur_e is not None and r.start_us > cur_e:
            gaps[f"{r.stage}:{r.host_op or r.name[:60]}"] += (r.start_us - cur_e) / 1e6 / frames
        cur_e = r.end_us if cur_e is None else max(cur_e, r.end_us)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}
