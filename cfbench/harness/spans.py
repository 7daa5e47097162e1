"""The program's own spans, reduced to per-stage numbers.

The engine's Stopwatch (`cofusion_tpu_torch/utils/stopwatch.py`) times
every frame as a `Run` section holding one `step.<stage>` section per stage
of the step (`step.fuse_clean` holding one `step.fuse_clean.slot<m>` per
model slot).  With its switch on it keeps each as a span record (name,
parent, tick, start and end in ns on the host clock) and opens a profiler
range of the same name, so a traced window's kineto events hold them on
the clock of the device records.

Host side: host ms per frame of each stage, of `Run` less its stages and
of the object slots, from two readings of the always-on section totals;
and, from the span records of a run with the switch on, the same per
frame, where the slowest frames' extra time goes.  Device side, from the
profiler's ranges and the harness's device records (`harness.trace`): idle
ms per frame while the host was inside a stage, over the extent from the
first `Run` range's start to the last one's end, and the device ms launched
inside the object slots' ranges.  Stages and `other` add up to `Run` on the
host and to the idle time over the extent on the device by construction:
`other` is defined as what the stages leave.
"""

from __future__ import annotations

import statistics

from harness import trace as tr

RUN = "Run"
PREFIX = "step."
STAGES = ("preprocess", "tracking", "segmentation", "fuse_clean", "predict", "reloc", "loop")
SLOT = "step.fuse_clean.slot"


def stage_of(name: str) -> str | None:
    """The stage a top-level `step.<stage>` section names, else None."""
    if name.startswith(PREFIX) and name[len(PREFIX):] in STAGES:
        return name[len(PREFIX):]
    return None


def _slot(name: str) -> int | None:
    return int(name[len(SLOT):]) if name.startswith(SLOT) else None


# --- host side: the always-on section totals, and span records for the
# per-frame view

def totals_per_frame(before: dict, after: dict, frames: int) -> dict:
    """Host ms per frame of `Run`, each `step.*` stage and each
    `step.fuse_clean.slot<m>` between two `Stopwatch.totals()` readings
    (the always-on sections: no switch needed), with `other` for `Run` less
    its stages and `fuse_clean_objects` for the slots 1..M-1."""
    out = {}
    for name, (ms, _) in after.items():
        if name == RUN or stage_of(name) or _slot(name) is not None:
            out[name] = (ms - before.get(name, (0.0, 0))[0]) / frames
    if RUN in out:
        out["other"] = out[RUN] - sum(v for k, v in out.items() if stage_of(k))
    objects = [v for k, v in out.items() if (_slot(k) or 0) > 0]
    if objects:
        out["fuse_clean_objects"] = sum(objects)
    return out


def per_frame(spans, ticks) -> dict[int, dict[str, float]]:
    """Host ms of `Run`, of each stage (the `step.*` spans whose parent is
    `Run`) and of `other` in each frame of `ticks` that has a `Run` span."""
    ticks = set(ticks)
    frames = {}
    for s in spans:
        if s.tick not in ticks:
            continue
        key = RUN if s.name == RUN else stage_of(s.name) if s.parent == RUN else None
        if key is not None:
            d = frames.setdefault(s.tick, {})
            d[key] = d.get(key, 0.0) + (s.end_ns - s.start_ns) / 1e6
    out = {}
    for tick, d in frames.items():
        if RUN in d:
            d["other"] = d[RUN] - sum(v for k, v in d.items() if k != RUN)
            out[tick] = d
    return out


def slow_frames(spans, ticks, share: float = 0.1) -> dict | None:
    """Where the slowest frames' host time goes: over the `share` of the
    frames of `ticks` with the longest `Run` (at least one), the mean ms by
    which `Run`, each stage and `other` exceed their median over all those
    frames; `frames` counts the slow ones.  None under two frames."""
    frames = per_frame(spans, ticks)
    if len(frames) < 2:
        return None
    rows = sorted(frames.values(), key=lambda d: d[RUN])
    slow = rows[-max(1, round(len(rows) * share)):]
    out = {"frames": len(slow)}
    for key in sorted({k for d in rows for k in d}):
        out[key] = (statistics.fmean(d.get(key, 0.0) for d in slow)
                    - statistics.median(d.get(key, 0.0) for d in rows))
    return out


# --- device side: profiler ranges (name, start_us, end_us, thread) and
# harness.trace.DeviceRecord

def ranges_from_kineto(events) -> list[tuple[str, float, float, int]]:
    """The host ranges of `Run` and of every `step.*` section among the
    profiler's events, on the clock of its device records (us)."""
    out = []
    for ev in events:
        name = ev.name()
        if tr._is_device(ev) or not (name == RUN or name.startswith(PREFIX)):
            continue
        out.append((name, tr._ns(ev, "start") / 1e3, tr._ns(ev, "end") / 1e3,
                    ev.start_thread_id()))
    out.sort(key=lambda r: r[1])
    return out


def merge(intervals) -> list[tuple[float, float]]:
    """The union of intervals as sorted, disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap_us(a, b) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def extent(ranges) -> tuple[float, float] | None:
    runs = [r for r in ranges if r[0] == RUN]
    if not runs:
        return None
    return min(r[1] for r in runs), max(r[2] for r in runs)


def idle_intervals(records, lo: float, hi: float) -> list[tuple[float, float]]:
    """The intervals of [lo, hi] in which no counted device record ran."""
    busy = merge((max(r.start_us, lo), min(r.end_us, hi)) for r in tr.counted(records))
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out


def device_idle_ms(ranges, records, frames: int, stage: str) -> float | None:
    """Idle device ms per profiled frame while the host thread that ran
    `Run` was inside `step.<stage>`; `other`: outside every stage range.
    Both over the extent of the `Run` ranges.  None without `Run` ranges,
    or for a stage with no range."""
    ext = extent(ranges)
    if ext is None or frames <= 0:
        return None
    threads = {r[3] for r in ranges if r[0] == RUN}
    idle = idle_intervals(records, *ext)
    staged = [r for r in ranges if r[3] in threads and stage_of(r[0])]
    if stage == "other":
        inside = merge((max(s, ext[0]), min(e, ext[1])) for _, s, e, _ in staged)
        return (sum(e - s for s, e in idle) - overlap_us(idle, inside)) / 1e3 / frames
    mine = [r for r in staged if stage_of(r[0]) == stage]
    if not mine:
        return None
    return overlap_us(idle, merge((s, e) for _, s, e, _ in mine)) / 1e3 / frames


def idle_total_ms(ranges, records, frames: int) -> float | None:
    """Idle device ms per profiled frame over the `Run` ranges' extent."""
    ext = extent(ranges)
    if ext is None or frames <= 0:
        return None
    return (ext[1] - ext[0] - tr.union_us(tr.counted(records), *ext)) / 1e3 / frames


def slot_names(ranges) -> list[str]:
    return sorted({r[0] for r in ranges if _slot(r[0]) is not None})


def objects_device_ms(slot_records, frames: int) -> float | None:
    """Device ms per profiled frame of the records launched inside the
    object slots' ranges: `slot_records` are the device records with
    `harness.trace.records_from_kineto(events, slot_names(...))`, whose
    stage is the slot range open at each launch."""
    recs = [r for r in tr.counted(slot_records) if (_slot(r.stage) or 0) > 0]
    if not recs or frames <= 0:
        return None
    return sum(r.end_us - r.start_us for r in recs) / 1e3 / frames
