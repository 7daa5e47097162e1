"""tests/test_reloc.py's blackout scenario through the JAX package on the
CPU at 640x480: 6 frames of the synthetic scene, 14 of a blacked-out
sensor (rgb 10, no depth), 3 of the scene seen from (6, -3, 2) cm away;
`FusionParams(depth_cutoff=4.5, fern_min_age=3, confidence_global=1.0)`,
relocalisation on, one model.  Prints per frame the lost flag, the
keyframe count and the camera position, then the final error to the
re-appearance pose and one JSON line.

This is the reference outcome that chip_smoke.py's `[reloc]` phase (the
port on the card, same scenario and width) is held against.  It is not
collected by pytest: the JAX step compiles once (~40 s) and each 640x480
frame takes seconds on the CPU.  `--surfels` sets the capacity (2^19 holds
the one-frame map; the card runs 2^20).

    JAX_PLATFORMS=cpu python tests/torch_reloc_reference.py [--surfels 19]
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from cofusion_tpu.config import CameraConfig, CoFusionConfig, FusionParams  # noqa: E402
from cofusion_tpu.engine import CoFusion  # noqa: E402
from cofusion_tpu.io.synthetic import SyntheticScene  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--surfels", type=int, default=19, help="log2 of the surfel capacity")
    opts = ap.parse_args(argv)
    cam = CameraConfig()
    eng = CoFusion(
        CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << opts.surfels),
        fusion_params=FusionParams(depth_cutoff=4.5, fern_min_age=3, confidence_global=1.0),
        enable_relocalization=True,
    )
    scene = SyntheticScene()
    T_re = np.eye(4)
    T_re[:3, 3] = (0.06, -0.03, 0.02)
    rgb0, d0, _ = scene.render(cam, np.eye(4))
    rgb_re, d_re, _ = scene.render(cam, T_re)
    seq = [(rgb0, d0)] * 6 + [(np.full_like(rgb0, 10), np.zeros_like(d0))] * 14 + [(rgb_re, d_re)] * 3
    t0 = time.time()
    lost = []
    for i, (rgb, d) in enumerate(seq):
        eng.process_frame({"rgb": rgb, "depth": d, "mask": None, "timestamp": i})
        p = np.asarray(eng.state.models.pose[0])
        lost.append(bool(eng.state.lost))
        print(i, lost[-1], int(eng.state.fern_db.count), np.round(p[:3, 3], 6),
              f"{time.time() - t0:.1f}s", flush=True)
    err = float(np.linalg.norm(p[:3, 3] - T_re[:3, 3]))
    print("final error to T_re", err)
    print(json.dumps({"lost_frames": [i for i, x in enumerate(lost) if x],
                      "keyframes": int(eng.state.fern_db.count),
                      "recovered_at": next((i for i in range(20, len(seq)) if not lost[i]), None),
                      "final_error_m": err}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
