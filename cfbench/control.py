#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from.

    python3 cfbench/control.py --workload <name> --seeds 11,12,13 --seconds <s> [--side control]

For each seed, one run of the cell as the benchmark makes it (set-up,
warm-up, a closed-loop window of `--seconds`, the comparison with the
scene's exact poses and surfaces), all in one process.  The side:
  program   the program as it is: the lower readings
  control   the program's float32 matmuls in TF32: the control, which has
            to fail one of the cell's numbers
  stuck     fault: a step that returns its state unchanged
  half      fault: the lower half of every depth frame left out
  nudge     fault: the tracked pose altered by 1 cm where it is produced
Prints one JSON line per seed with every number the comparison computes.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (os.path.join(HERE, "reference"), HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import run  # noqa: E402
from harness import cell as cells  # noqa: E402
from harness import compare  # noqa: E402


@contextlib.contextmanager
def _patched(obj, attr: str, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def step_returns_state_unchanged():
    from cofusion_tpu_torch import engine

    def make(orig):
        def stuck(state, *a, **kw):
            _, outputs = orig(state, *a, **kw)
            return state, outputs
        return stuck
    return _patched(engine, "_step", make)


def half_of_each_frame_left_out():
    import numpy as np

    from cofusion_tpu_torch import engine

    def make(orig):
        def half(self, frame, *a, **kw):
            depth = np.array(frame["depth"])
            depth[depth.shape[0] // 2:] = 0.0
            return orig(self, dict(frame, depth=depth), *a, **kw)
        return half
    return _patched(engine.CoFusion, "process_frame", make)


def pose_altered_where_produced():
    from cofusion_tpu_torch.ops import odometry

    def make(orig):
        def nudged(*a, **kw):
            res = orig(*a, **kw)
            pose = res.pose.clone()
            pose[:, 0, 3] += 1e-2
            return res._replace(pose=pose)
        return nudged
    return _patched(odometry, "track_models", make)


SIDES = {
    "program": contextlib.nullcontext,
    "control": compare.tf32,
    "stuck": step_returns_state_unchanged,
    "half": half_of_each_frame_left_out,
    "nudge": pose_altered_where_produced,
}


def readings(cell, seed: int, seconds: float, side: str, device: str,
             overrides: dict | None = None) -> dict:
    with SIDES[side]():
        res = run.run_cell(cell, seed, seconds, False, device, overrides)
    return {"seed": seed, "side": side, "correct_under_limits": res["correct"],
            "frames": res["attempted"], **{k: v["value"] for k, v in res["checks"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--side", choices=sorted(SIDES), default="control")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, args.seconds, args.side, "cuda")
        r["seconds"] = time.perf_counter() - t
        print(json.dumps({"workload": cell.name, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
