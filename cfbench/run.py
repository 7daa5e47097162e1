#!/usr/bin/env python3
"""Run one cell of the benchmark of `cofusion_tpu_torch` once.

    python3 cfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the cell's frames from the seed, builds the engine and feeds
the warm-up frames; then `CoFusion.process_frame` runs back to back for
`--seconds` (a closed loop, as when a recorded log is processed as fast as
it goes), synchronised once at the end.  Once the window has closed the run
reads back what the engine produced (every frame's poses, every slot's
map, the segmentations), frees it and compares that with the generated
scene's exact poses and surfaces (reference/truth.py).  The last line of
standard output is one JSON object: the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics from a profile of the window's first
frames.  The numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.  Without a CUDA card the run
exits with code 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (os.path.join(HERE, "reference"), HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import cell as cells  # noqa: E402
from harness import compare, imports, system  # noqa: E402
from harness import trace as tr  # noqa: E402

# the CPU dry run's sizes: the frame loop and the comparison
# of every cell at 160x128, no device metric
DRY_RUN = {
    "camera": {"width": 160, "height": 128, "fx": 132.0, "fy": 132.0, "cx": 80.0, "cy": 64.0},
    "engine": {"max_surfels": 1 << 15, "active_surfels": 1 << 14, "object_active_surfels": 1 << 12},
}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def card_name_and_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def quantiles(values) -> tuple[float, float, float]:
    q = statistics.quantiles(values, n=4) if len(values) > 1 else [values[0]] * 3
    return q[0], q[1], q[2]


def p95(values) -> float:
    return float(statistics.quantiles(values, n=20)[18]) if len(values) > 1 else float(values[0])


class GcClock:
    """Host seconds spent in the interpreter's garbage collector, by
    generation, while `on` (a line of the log, not a metric)."""

    def __init__(self):
        self.on, self.t, self.seconds, self.count = False, 0.0, [0.0, 0.0, 0.0], [0, 0, 0]

    def __enter__(self):
        gc.callbacks.append(self)
        self.on = True
        return self

    def __exit__(self, *exc):
        self.on = False
        gc.callbacks.remove(self)

    def __call__(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self.t = time.perf_counter()
        else:
            g = info["generation"]
            self.seconds[g] += time.perf_counter() - self.t
            self.count[g] += 1


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device: str,
             overrides: dict | None = None) -> dict:
    """One run of `cell`; returns the result object (its `metrics` empty on
    the CPU, where nothing is timed)."""
    import torch

    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    log(f"[setup] device_ready_s={process_age_s():.3f}")
    gen = cells.generator(cell.traffic["generator"])
    camd = dict(cell.config["camera"], **(overrides or {}).get("camera", {}))
    stream = gen.make_stream(cell.traffic, seed, gen.Camera(**camd))
    log(f"[setup] cell={cell.name} seed={seed} frames_unique={len(stream.unique)} "
        f"period={len(stream.order)} start={stream.start} render_done_s={process_age_s():.3f}")

    eng, events = system.build(cell.config, device, overrides)
    log(f"[setup] engine_built_s={process_age_s():.3f}")
    warm = int(cell.traffic["warmup_frames"])
    for k in range(warm):
        system.feed(eng, stream, k)
    if on_card:
        torch.cuda.synchronize()

    stages = meter = None
    profile_frames = int(cell.traffic.get("profile_frames", 2))
    if trace:
        stages = tr.StageWrapper(cell.stages)
        missing = stages.install()
        if missing:
            log(f"[trace] stage targets not found: {missing}")
        if on_card:
            meter = tr.SplatMeter()
            meter.install()

    if trace and on_card:
        # the profiler's first start initialises CUPTI: keep it out of the window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            torch.cuda.synchronize()
    log(f"[setup] engine_warm_s={process_age_s():.3f}")

    # --- the timed window (with --trace 1 on the card: its first
    # `profile_frames` frames under the profiler, synchronised around them)
    setup_s = process_age_s()
    done, enqueue_ms = [], []
    t_prof = [0.0, 0.0]
    start_ev = torch.cuda.Event(enable_timing=True) if on_card else None
    if on_card:
        start_ev.record()
    gc_clock = GcClock()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = warm
    profiling = False
    with gc_clock:
        while True:
            if trace and on_card and not done:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                meter.on = profiling = True
                t_prof[0] = time.perf_counter()
                prof.start()
            ts = time.perf_counter()
            system.feed(eng, stream, k)
            te = time.perf_counter()
            k += 1
            if on_card:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                done.append(ev)
            else:
                done.append(None)
            if profiling and len(done) == profile_frames:
                torch.cuda.synchronize()
                t_prof[1] = time.perf_counter()
                prof.stop()
                meter.on = profiling = False
            elif not profiling:
                enqueue_ms.append((te - ts) * 1e3)
            if not profiling and time.perf_counter() >= deadline:
                break
    if on_card:
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    n_window = len(done)
    n_frames = warm + n_window
    if stages:
        stages.restore()
    if meter:
        meter.restore()

    metrics, dev_info, extra = {}, {"platform": "cpu", "count": 0}, {}
    if on_card:
        intervals = []
        prev = start_ev
        for ev in done:
            intervals.append(prev.elapsed_time(ev))
            prev = ev
        peak = torch.cuda.max_memory_allocated()
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                    "memory_peak_bytes": int(peak)}
        q1, q2, q3 = quantiles(intervals)
        log(f"[window] frames={n_window} wall_s={wall_s!r} frame_ms={wall_s * 1e3 / n_window!r} "
            f"interval_samples={len(intervals)} interval_q1_ms={q1!r} interval_median_ms={q2!r} "
            f"interval_q3_ms={q3!r} interval_p95_ms={p95(intervals)!r} "
            f"beyond_p95={sum(i > p95(intervals) for i in intervals)} card={card_name_and_limit()}")
        log(f"[gc] collections={gc_clock.count} seconds={gc_clock.seconds}")
        log("[intervals_ms] " + " ".join(f"{i:.1f}" for i in intervals))
        if enqueue_ms:
            log("[enqueue_ms] " + " ".join(f"{e:.1f}" for e in enqueue_ms))
        if not trace:
            values = {
                "setup_s": setup_s,
                "frame_ms": wall_s * 1e3 / n_window,
                "frame_ms_p95": p95(intervals),
            }
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in cell.end_to_end if m["name"] in values}
        else:
            recs = tr.records_from_kineto(prof.profiler.kineto_results.events(), list(cell.stages))
            rec = tr.TraceRecords(
                frames=profile_frames,
                span_us=(t_prof[1] - t_prof[0]) * 1e6,
                records=recs,
                host_enqueue_ms=enqueue_ms,
                splat_bounds=meter.read(),
                bilateral_inputs=[stream.frame(warm + i)["depth"] for i in range(profile_frames)],
                max_depth=float(cell.config["fusion"]["depth_cutoff"]),
            )
            del prof
            counted = tr.counted(recs)
            busy_us = tr.union_us(counted)
            dev_info["busy_s"] = busy_us / 1e6
            dev_info["window_s"] = rec.span_us / 1e6
            for m in cell.per_layer:
                read, arg = cells.metric_reader(m["name"])
                v = read(rec, arg)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            total_ms = sum(r.end_us - r.start_us for r in counted) / 1e3 / profile_frames
            staged = sum(v["value"] for n, v in metrics.items() if n.startswith("stage_ms."))
            log(f"[trace] frames={profile_frames} records={len(recs)} counted={len(counted)} "
                f"device_ms_per_frame={total_ms!r} stage_ms_sum={staged!r} busy_s={busy_us / 1e6!r} "
                f"window_s={rec.span_us / 1e6!r} splat_launches_metered={len(rec.splat_bounds)} "
                f"card={card_name_and_limit()}")
            extra["breakdown"] = tr.breakdown(recs, profile_frames)

    # --- read back, free the program, compare with the scene's exact poses and surfaces
    out = system.collect(eng, events)
    capacity = int(eng.cfg.max_surfels)
    del eng
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = compare.numbers(out, stream)
    ref_s = time.perf_counter() - t_ref
    gt = [stream.gt_pose(i) for i in range(n_frames)]
    ate = compare.ate_rmse(out["poses"][:, 0], gt)
    spawned = sorted({s for _, kind, s in out["events"] if kind == "new"})
    info = f"[outputs] frames={n_frames} window_frames={n_window} ate_rmse_m={ate!r} " \
           f"surfels_held={out['counts'].tolist()} capacity_per_slot={capacity} " \
           f"held_share={[round(int(c) / capacity, 5) for c in out['counts']]} " \
           f"active={out['active'].astype(int).tolist()} spawned_slots={spawned} " \
           f"object_slots(slot,spawn_frame,box)={nums.get('_object_slots', [])} " \
           f"events={out['events']} compare_s={ref_s!r}"
    if out["masks"]:
        last = max(out["masks"])
        info += f" iou_last={compare.best_iou(out['masks'][last], stream.ids(last - 1))}"
    log(info)

    correct, table = compare.judge(nums, cell.limits)
    failed = compare.failed_frames(out, stream, cell.limits, warm)
    found = imports.forbidden_loaded()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    result = {
        "correct": correct,
        "attempted": n_window,
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
        **extra,
        "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in table.items()},
    }
    for k, (v, lim) in table.items():
        log(f"check {k} value={v!r} limit={'not compared' if lim is None else repr(lim)}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, system.PROGRAM)):
        log(f"the program ({system.PROGRAM}/) is not beside the benchmark in {ROOT}")
        return 2
    cell = cells.resolve(args.workload)
    import torch

    log(f"[setup] torch_imported_s={process_age_s():.3f}")
    if not torch.cuda.is_available():
        log("no CUDA card: the benchmark measures the port on one")
        return 2
    chips = next(w["chips"] for w in cells.load_json(cells.manifest_path())["workloads"]
                 if w["name"] == cell.name)
    if torch.cuda.device_count() < chips:
        log(f"{cell.name} needs {chips} cards, {torch.cuda.device_count()} found")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
