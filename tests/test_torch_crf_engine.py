"""The port's motion-cue CRF engine against the JAX engine on the CPU, on
`tests/test_crf_engine.py`'s teleport scenario and exact configuration
(small_cam, max_models=3, 2^16 surfels, superpixel size 6), so the JAX
package's compile cache serves both files: a low-threshold map warms on a
static box for 6 frames, the box jumps, and the next frames must spawn a
model for it.  One test function runs both engines (a module fixture would
be rebuilt on every xdist worker).

Bars (those of tests/test_torch_multimodel.py):
  * camera poses within 1e-5 + 2e-6*step, active flags exact, on every
    frame; the spawn frame and the lifecycle events equal;
  * one CRF step of the JAX engine from the port's own state at every
    frame, and one of the port from the JAX state at every frame: every
    pose within 1e-5, counts, active flags and the segmentation mask
    exact;
  * the whole runs: poses within the bar plus the reference's own response
    to the port's state, counts equal wherever the reference's step from
    the port's state keeps its counts, and the drained masks exact on
    every frame;
  * the port's own run: the object spawns and its settled masks overlap
    the renderer's with IoU > 0.6 (test_crf_engine.py's bars).
"""

import dataclasses

import numpy as np
import torch

from cofusion_tpu.config import CoFusionConfig, FusionParams
from cofusion_tpu.engine import CoFusion as JaxCoFusion
from cofusion_tpu.io.synthetic import SyntheticScene, camera_trajectory, object_trajectory
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.engine import CoFusion, _step

import test_torch_multimodel as mm

torch.set_num_threads(1)
FUSION = dict(depth_cutoff=4.5, confidence_object=0.01, confidence_global=1.5,
              model_spawn_offset=4, model_deactivate_count=3)


def _pose_bar(step):
    return 1e-5 + 2e-6 * step


def _teleport_frames(cam):
    """test_crf_engine.py's frames and the renderer's object masks."""
    n_warm, n_after = 6, 4
    n = n_warm + n_after
    scene = SyntheticScene()
    h = 0.28
    scene.add_moving_box(model_id=1, lo=[-h, -h, -h], hi=[h, h, h])
    base = object_trajectory(1, translation=(0, 0, 0), center=(0.14, -0.32, 1.82), tilt=(0.35, 0.5, 0.0))[0]
    jump = np.eye(4)
    jump[:3, 3] = (0.40, 0.18, 0.0)
    cam_poses = camera_trajectory(n, kind="orbit", scale=0.4)
    obj_poses = [base.copy() for _ in range(n_warm)] + [jump @ base for _ in range(n_after)]
    frames, gt_masks = [], []
    for i in range(n):
        rgb, depth, mask = scene.render(cam, cam_poses[i], object_poses={1: obj_poses[i]})
        frames.append({"rgb": rgb, "depth": depth, "mask": None, "timestamp": i})
        gt_masks.append(np.asarray(mask))
    return frames, gt_masks


def _play(eng, frames, snapshot=False):
    log, events, states, _ = mm._play(eng, frames, snapshot)
    eng.flush_lifecycle()
    masks = {tick - 1: m for tick, m in eng.drain_segmentation(flush=True)}
    return log, [e[1:] for e in events], states, masks


def _iou(a, b):
    union = float(np.logical_or(a, b).sum())
    return float(np.logical_and(a, b).sum()) / union if union else 0.0


def test_crf_engine_matches_jax_engine(small_cam):
    frames, gt_masks = _teleport_frames(small_cam)
    n = len(frames)
    jeng = JaxCoFusion(
        CoFusionConfig(camera=small_cam, max_models=3, max_surfels=1 << 16, superpixel_size=6),
        fusion_params=FusionParams(**FUSION), enable_multi_model=True,
    )
    tcam = tcfg.CameraConfig(**dataclasses.asdict(small_cam))
    tc = tcfg.CoFusionConfig(camera=tcam, max_models=3, max_surfels=1 << 16, superpixel_size=6)
    teng = CoFusion(tc, fusion_params=tcfg.FusionParams(**FUSION), enable_multi_model=True, device="cpu")
    calls = mm._record_steps(jeng)
    jlog, jev, states, jmasks = _play(jeng, frames, snapshot=True)
    tlog, tev, tstates, tmasks = _play(teng, frames, snapshot=True)

    spawn = [i for i, (_, a, _) in enumerate(jlog) if a[1:].any()]
    assert spawn and spawn == [i for i, (_, a, _) in enumerate(tlog) if a[1:].any()]
    assert jev == tev and ("new", 1) in tev, (jev, tev)
    mm._compare_runs(jlog, tlog, mm._cross_steps(jeng, calls, tstates, tlog))
    for step in range(1, n):
        np.testing.assert_array_equal(tmasks[step], jmasks[step], err_msg=f"mask, frame {step}")

    # one CRF step from each JAX state (the CRF path picks its spawn slot
    # and cooldown on the device, so the host nominations stay unset)
    fparams = dict(teng._fparams, weight_multiplier=1.0, new_slot=-1, allow_new=False, gt_masks=False)
    for k in range(1, n):
        f = frames[k]
        new, _ = _step(
            convert.state_from_numpy(states[k]), torch.from_numpy(f["rgb"].astype(np.float32)),
            torch.from_numpy(f["depth"]), torch.zeros(tcam.shape, dtype=torch.int32), fparams,
            cam=tcam, cfg=tc, tparams=tcfg.TrackingParams(), sparams=teng.segmentation, use_crf=True,
        )
        ref = states[k + 1]
        np.testing.assert_allclose(new.models.pose.numpy(), ref.models.pose, atol=1e-5, err_msg=f"step {k}")
        np.testing.assert_array_equal(new.models.store.count.numpy(), ref.models.store.count)
        np.testing.assert_array_equal(new.models.active.numpy(), ref.models.active)
        np.testing.assert_array_equal(new.prev_mask.numpy(), ref.prev_mask, err_msg=f"mask {k}")

    # the port's own segmentation bars (test_crf_engine.py's)
    active = tlog[-1][1]
    slot = 1 + int(np.argmax(active[1:]))
    assert teng.surfel_count(slot) > 50
    settled = [_iou(tmasks[i] == slot, gt_masks[i] == 1) for i in (n - 2, n - 1)]
    assert min(settled) > 0.6, settled
