#!/usr/bin/env python3
"""The program's own spans over one run of a cell: host ms per stage of the
frame step, where the slowest frames' extra host time goes, and in a traced
run on the card the device's idle ms per stage and the object slots' device
ms.

    python3 cfbench/trace_spans.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A tool beside the benchmark, not a part of it: `run.py` reads none of this
(PERF.md §7 lists the edits that would).  It builds the cell's stream and
engine with the harness's modules, feeds the warm-up frames, then frames
back to back for `--seconds` (at least one), and holds the outputs to the
cell's limits as `run.py` does.  The engine's Stopwatch switch
(`CoFusion.sw.spans_on`) goes on after the warm-up.  With `--trace 1`, on
the card, `profile_frames` frames run first under the profiler inside the
benchmark's stage ranges, as in `run.py`'s traced run.

Host numbers are per frame of the window after the profiled frames:
`host_ms` from the always-on section totals read when those frames begin
and after the last, beside `enqueue_ms`, the host clock around each
`process_frame` call, and `slow_frames` from those frames' span records.
The last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import run  # noqa: E402  (puts the harness and the program on sys.path)
from harness import cell as cells  # noqa: E402
from harness import compare, system  # noqa: E402
from harness import spans as sp  # noqa: E402
from harness import trace as tr  # noqa: E402


def run_window(cell: cells.Cell, seed: int, seconds: float, spans_on: bool, device: str,
               overrides: dict | None = None, profile_frames: int = 0) -> dict:
    """One run of `cell` with the engine's switch set to `spans_on` after
    the warm-up and, where `profile_frames`, the stage ranges installed and
    that many window frames profiled first (on the card); returns what
    `reduce` reads."""
    import torch

    on_card = device.startswith("cuda")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    gen = cells.generator(cell.traffic["generator"])
    camd = dict(cell.config["camera"], **(overrides or {}).get("camera", {}))
    stream = gen.make_stream(cell.traffic, seed, gen.Camera(**camd))
    eng, events = system.build(cell.config, device, overrides)
    k = int(cell.traffic["warmup_frames"])
    for i in range(k):
        system.feed(eng, stream, i)
    sync()
    sw = eng.sw
    sw.spans_on = spans_on
    w = {"sw": sw, "profiled": profile_frames if on_card else 0}

    stages = tr.StageWrapper(cell.stages if profile_frames else {})
    stages.install()
    try:
        if w["profiled"]:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
            with profile(activities=acts):  # CUPTI's first start, outside the frames
                torch.ones(1, device=device).add_(1)
                sync()
            with profile(activities=acts) as prof:
                for _ in range(w["profiled"]):
                    system.feed(eng, stream, k)
                    k += 1
                sync()
            evs = list(prof.profiler.kineto_results.events())
            w["ranges"] = sp.ranges_from_kineto(evs)
            w["records"] = tr.records_from_kineto(evs, list(cell.stages))
            w["slot_records"] = tr.records_from_kineto(evs, sp.slot_names(w["ranges"]))
            del prof, evs
        w["before"], w["enqueue_ms"], w["ticks"] = sw.totals(), [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            ts = time.perf_counter()
            system.feed(eng, stream, k)
            w["enqueue_ms"].append((time.perf_counter() - ts) * 1e3)
            w["ticks"].append(sw.tick)
            k += 1
            if time.perf_counter() >= deadline:
                break
        sync()
        w["frame_ms"] = (time.perf_counter() - t0) * 1e3 / len(w["ticks"])
        w["after"] = sw.totals()
    finally:
        stages.restore()

    out = system.collect(eng, events)
    del eng
    if on_card:
        sync()
        torch.cuda.empty_cache()
    w["correct"], _ = compare.judge(compare.numbers(out, stream), cell.limits)
    return w


def stage_metrics(cell: cells.Cell, w: dict) -> dict:
    """The benchmark's own readers of launches and stage device time over
    the profiled frames (`launches_per_frame`, `stage_launches.*`,
    `stage_ms.*`)."""
    rec = tr.TraceRecords(frames=w["profiled"], span_us=0.0, records=w["records"],
                          host_enqueue_ms=[], splat_bounds=[], bilateral_inputs=[], max_depth=0.0)
    out = {}
    for m in cell.per_layer:
        if m["name"] == "launches_per_frame" or m["name"].startswith(("stage_launches.", "stage_ms.")):
            read, arg = cells.metric_reader(m["name"])
            v = read(rec, arg)
            if v is not None:
                out[m["name"]] = v
    return out


def reduce(cell: cells.Cell, w: dict) -> dict:
    host = sp.totals_per_frame(w["before"], w["after"], len(w["ticks"]))
    out = {
        "correct": w["correct"],
        "frames_read": len(w["ticks"]),
        "frame_ms": w["frame_ms"],
        "enqueue_ms": statistics.fmean(w["enqueue_ms"]),
        "host_ms": host,
    }
    spans = w["sw"].spans()
    if spans:
        out.update(spans_recorded=len(spans), spans_dropped=w["sw"].dropped,
                   slow_frames=sp.slow_frames(spans, w["ticks"]))
    f = w["profiled"]
    if f:
        ranges, records = w["ranges"], w["records"]
        idle = {s: sp.device_idle_ms(ranges, records, f, s) for s in sp.STAGES + ("other",)}
        ext = sp.extent(ranges)
        out.update(
            device_idle_ms={s: v for s, v in idle.items() if v is not None},
            device_idle_total_ms=sp.idle_total_ms(ranges, records, f),
            extent_ms_per_frame=None if ext is None else (ext[1] - ext[0]) / 1e3 / f,
            fuse_clean_objects_ms=sp.objects_device_ms(w["slot_records"], f),
            device_records=len(records),
            stage_metrics=stage_metrics(cell, w),
        )
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help="cpu: the dry run's sizes, nothing profiled")
    args = ap.parse_args(argv)

    import torch

    cell = cells.resolve(args.workload)
    on_card = args.device.startswith("cuda")
    if on_card and not torch.cuda.is_available():
        run.log("no CUDA card")
        return 2
    w = run_window(cell, args.seed, args.seconds, True, args.device,
                   None if on_card else run.DRY_RUN,
                   int(cell.traffic.get("profile_frames", 2)) if args.trace else 0)
    res = reduce(cell, w)
    if on_card:
        res["card"] = run.card_name_and_limit()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
