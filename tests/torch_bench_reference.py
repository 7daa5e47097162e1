"""The bench workload's lifecycle in the JAX engine and in the port, on the
CPU, at a reduced camera: bench.py's 3 moving boxes and ping-pong orbit
(`make_multi_object_frames(cam, 12)` replayed), 4 model slots, 2^22 surfels
a slot, CRF segmentation, bench.py's fusion parameters.  Prints, per
engine, the frames at which object slots become active and the per-frame
active flags; then, per frame, the camera pose gap between the runs and
one JAX step replayed from the port's state (how far the port's step is
from the reference's on the same input, and how far the reference's own
step from the port's state lands from its own run); then one JSON line.

This is how the port's spawn frames on the card (chip_smoke.py's
`multi_crf` phase, 640x480) are held against what the reference does on
the same scene.  It is not collected by pytest: at the default 320x240 it
takes several minutes (the JAX step compiles once).

    JAX_PLATFORMS=cpu python tests/torch_bench_reference.py [--frames 40] [--scale 2]
"""

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from cofusion_tpu.config import CameraConfig, CoFusionConfig, FusionParams  # noqa: E402
from cofusion_tpu.engine import CoFusion as JaxCoFusion  # noqa: E402
from cofusion_tpu_torch import config as tcfg  # noqa: E402
from cofusion_tpu_torch import convert  # noqa: E402
from cofusion_tpu_torch.engine import CoFusion  # noqa: E402
from cofusion_tpu_torch.io.synthetic import make_multi_object_frames  # noqa: E402

FUSION = dict(depth_cutoff=4.5, confidence_object=0.01, confidence_global=1.5,
              model_spawn_offset=4, model_deactivate_count=3)  # bench.py:91-94


def _flags(eng):
    st = eng.stats()
    return np.asarray(st["active"]).astype(int).tolist(), np.asarray(st["poses"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--scale", type=int, default=2, help="camera = 640x480 / scale")
    opts = ap.parse_args(argv)
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    full = CameraConfig()
    s = opts.scale
    cam = CameraConfig(width=full.width // s, height=full.height // s, fx=full.fx / s,
                       fy=full.fy / s, cx=full.cx / s, cy=full.cy / s)
    tcam = tcfg.CameraConfig(**dataclasses.asdict(cam))
    unique = make_multi_object_frames(tcam, 12)
    frames = [dict(unique[i % 12], mask=None, timestamp=i) for i in range(opts.frames)]
    out = {"camera": [cam.width, cam.height], "frames": opts.frames}
    jeng = JaxCoFusion(CoFusionConfig(camera=cam, max_models=4, max_surfels=1 << 22),
                       fusion_params=FusionParams(**FUSION), enable_multi_model=True)
    calls, get = [], jeng._get_step

    def recording_get(*a, **k):
        fn = get(*a, **k)
        return lambda state, *args: calls.append((fn, args)) or fn(state, *args)

    jeng._get_step = recording_get
    teng = CoFusion(tcfg.CoFusionConfig(camera=tcam, max_models=4, max_surfels=1 << 22),
                    fusion_params=tcfg.FusionParams(**FUSION), enable_multi_model=True, device="cpu")
    # both engines in lockstep; before each port step, one JAX step from the
    # port's state (one state copy at a time: a copy holds 4 x 2^22 surfels)
    active = {"jax": [], "port": []}
    per_frame = []
    seconds = {"jax": 0.0, "port": 0.0}
    for k, f in enumerate(frames):
        snap = None if k == 0 else [jnp.asarray(np.array(a)) for a in
                                    jax.tree.leaves(convert.state_to_numpy(teng.state))]
        t0 = time.perf_counter()
        jeng.process_frame(f)
        ja, jp = _flags(jeng)
        seconds["jax"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        teng.process_frame(f)
        ta, tp = _flags(teng)
        seconds["port"] += time.perf_counter() - t0
        active["jax"].append(ja)
        active["port"].append(ta)
        if snap is None:
            continue
        fn, args = calls[-1]
        new, _ = fn(jax.tree.unflatten(jax.tree.structure(jeng.state), snap), *args)
        rp = np.asarray(new.models.pose)
        row = dict(frame=k, camera_gap=float(np.abs(tp[0] - jp[0]).max()),
                   port_vs_replay=float(np.abs(tp - rp).max()),
                   replay_vs_jax_run=float(np.abs(rp - jp).max()),
                   replay_active_equal_port=np.asarray(new.models.active).astype(int).tolist() == ta,
                   active_jax=ja, active_port=ta)
        per_frame.append(row)
        print(json.dumps(row), flush=True)
    for name in ("jax", "port"):
        a = active[name]
        spawns = [i for i in range(1, len(a)) for m in range(1, 4) if a[i][m] and not a[i - 1][m]]
        out[name] = dict(spawn_frames=spawns, seconds=round(seconds[name], 1))
        print(f"{name}: object slots turn active at frames {spawns}", flush=True)
    out["per_frame"] = per_frame
    out["max_camera_pose_diff"] = max(r["camera_gap"] for r in per_frame)
    out["max_port_vs_replay"] = max(r["port_vs_replay"] for r in per_frame)
    out["active_equal"] = active["jax"] == active["port"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
