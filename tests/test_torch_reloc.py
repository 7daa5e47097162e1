"""The port's relocalisation ('-rl': lost detection, fern keyframes and
recovery; cofusion_tpu_torch/engine.py's `_relocalise`) against the JAX
engine on the CPU, on tests/test_reloc.py's blackout scenario and
configuration (small_cam, 2^16 surfels, fern_min_age 3, the fern ICP gate
1.2e-3 for 20x16 fern maps, confidence 1): 6 frames of the scene, 14 of a
blacked-out sensor, 3 of the scene seen from (6, -3, 2) cm away.

The JAX conservatory (its `jax.random` probes) is carried into the port's
state before the first step (convert.py), so both engines code frames
alike (the port's own probes differ: ROADMAP C9).  Both engines run in one
test function (a module fixture would be rebuilt on every xdist worker).

Bars (those of tests/test_torch_local_loop.py): `lost`, the keyframe count
and `loop_closed` exact on every frame of both runs and every replayed
step; the surfel counts on every replayed step exact, or, where they part,
within the overlap of both engines' counts under about an ulp of depth
noise (the recovery frame fuses a new view whose counts JAX itself moves
by up to 2 under that noise: ROADMAP C11); the stored
keyframe codes and times exact at the end;
every step replayed both ways with the camera within 1e-5 x max(1,
condition / 1e2), the condition that of the step's worst 6x6 system (the
tracker's or the fern ICP's); the whole runs within the per-frame bar
plus the reference's own response.  And test_reloc.py's own bars on the
port: lost during the blackout, a keyframe stored, recovered within 3 cm.
"""

import jax
import numpy as np
import torch

from cofusion_tpu.config import CoFusionConfig, FusionParams
from cofusion_tpu.engine import CoFusion as JaxCoFusion
from cofusion_tpu.io.synthetic import SyntheticScene
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.engine import CoFusion

import test_torch_local_loop as tl

torch.set_num_threads(1)
FUSION = dict(depth_cutoff=4.5, fern_min_age=3, fern_icp_error_thresh=1.2e-3, confidence_global=1.0)
T_RE = np.eye(4)
T_RE[:3, 3] = (0.06, -0.03, 0.02)


def _blackout_frames(cam):
    scene = SyntheticScene()
    rgb0, depth0, _ = scene.render(cam, np.eye(4))
    rgb_re, depth_re, _ = scene.render(cam, T_RE)
    seq = ([(rgb0, depth0)] * 6 + [(np.full_like(rgb0, 10), np.zeros_like(depth0))] * 14
           + [(rgb_re, depth_re)] * 3)
    return [{"rgb": r, "depth": d, "mask": None, "timestamp": i} for i, (r, d) in enumerate(seq)]


def test_blackout_matches_jax_engine(small_cam, monkeypatch):
    frames = _blackout_frames(small_cam)
    conds = tl.Conditions(monkeypatch)
    jeng = JaxCoFusion(CoFusionConfig(camera=small_cam, max_models=1, max_surfels=1 << 16),
                       fusion_params=FusionParams(**FUSION), enable_relocalization=True)
    tcam = tcfg.CameraConfig(width=small_cam.width, height=small_cam.height, fx=small_cam.fx,
                             fy=small_cam.fy, cx=small_cam.cx, cy=small_cam.cy)
    teng = CoFusion(tcfg.CoFusionConfig(camera=tcam, max_models=1, max_surfels=1 << 16),
                    fusion_params=tcfg.FusionParams(**FUSION), enable_relocalization=True,
                    device="cpu")
    calls = tl._record_steps(jeng)
    jrun = tl.play(jeng, frames)

    def carry_conservatory(eng):
        db = jax.tree.map(np.array, jrun[2][0].fern_db)
        eng.state = eng.state._replace(fern_db=convert.fern_db_from_numpy(tuple(db)))

    trun = tl.play(teng, frames, {1: carry_conservatory})
    jlost = [rec[2] for rec in jrun[0]]
    tlost = [rec[2] for rec in trun[0]]
    print("lost at", [i for i, x in enumerate(tlost) if x])
    assert tlost == jlost
    for k in range(len(frames)):
        assert int(trun[2][k].fern_db.count) == int(jrun[2][k].fern_db.count), k

    response, scales = tl.replay_both_ways(jeng, teng, calls, jrun, trun, frames, conds)
    tl.compare_runs(jrun[0], trun[0], response, scales)
    tdb, jdb = trun[2][len(frames) - 1].fern_db, jrun[2][len(frames) - 1].fern_db
    for f in ("codes", "good_codes", "src_time", "count"):
        np.testing.assert_array_equal(getattr(tdb, f), getattr(jdb, f), err_msg=f)

    # tests/test_reloc.py's bars, on the port
    assert not any(tlost[:6]) and any(tlost[6:20]) and not tlost[-1]
    assert int(teng.state.fern_db.count) >= 1
    recovered = next(i for i in range(20, len(frames)) if not tlost[i])
    assert recovered == next(i for i in range(20, len(frames)) if not jlost[i])
    err = np.linalg.norm(trun[0][-1][0][:3, 3] - T_RE[:3, 3])
    assert err < 0.03, err


def test_blackout_in_multi_model_mode(small_cam):
    """'-rl' in the multi-model mode (3 slots, ground-truth masks of
    background only): relocalisation acts on the global model as in the
    one-model run above (lost during the blackout, recovered within 3 cm
    on the first frame back) and the idle object slots stay empty."""
    tcam = tcfg.CameraConfig(width=small_cam.width, height=small_cam.height, fx=small_cam.fx,
                             fy=small_cam.fy, cx=small_cam.cx, cy=small_cam.cy)
    eng = CoFusion(tcfg.CoFusionConfig(camera=tcam, max_models=3, max_surfels=1 << 16),
                   fusion_params=tcfg.FusionParams(**FUSION), enable_multi_model=True,
                   enable_relocalization=True, device="cpu")
    lost = []
    for f in _blackout_frames(small_cam):
        eng.process_frame(dict(f, mask=np.zeros(f["depth"].shape, np.uint8)))
        lost.append(bool(eng.state.lost))
    assert not any(lost[:6]) and any(lost[6:20]) and not any(lost[20:]), lost
    assert int(eng.state.fern_db.count) >= 1
    err = np.linalg.norm(eng.camera_pose()[:3, 3] - T_RE[:3, 3])
    assert err < 0.03, err
    assert (eng.state.models.store.count[1:] == 0).all()
