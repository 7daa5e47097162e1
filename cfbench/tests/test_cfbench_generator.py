"""The frozen generator: the same frames for the same seed, a continuous
ping-pong across its wrap, and at phase 0 the port's own renderer."""

import cfbench_paths  # noqa: F401
import numpy as np
import pytest

from harness import cell as cells

gen = cells.generator("synthetic_room")
CAM = gen.Camera(80, 64, 66.0, 66.0, 40.0, 32.0)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, -5, 10**20])
def test_same_seed_same_frames(seed):
    t = {"scene": "boxes3", "unique_frames": 5, "masks": True}
    a, b = gen.make_stream(t, seed, CAM, workers=2), gen.make_stream(t, seed, CAM, workers=1)
    for k in range(10):
        fa, fb = a.frame(k), b.frame(k)
        assert np.array_equal(fa["rgb"], fb["rgb"]) and np.array_equal(fa["depth"], fb["depth"])
        assert np.array_equal(fa["mask"], fb["mask"]) and np.array_equal(a.gt_pose(k), b.gt_pose(k))


def test_seeds_change_texture_and_start_not_geometry():
    t = {"scene": "orbit", "unique_frames": 4}
    a, b = gen.make_stream(t, 1, CAM), gen.make_stream(t, 2, CAM)
    assert not np.array_equal(a.unique[0][0], b.unique[0][0])
    assert all(np.array_equal(x[1], y[1]) for x, y in zip(a.unique, b.unique))
    assert a.frame(0)["mask"] is None and not a.feeds_gt_pose


def test_ping_pong_is_continuous_across_its_wrap():
    t = {"scene": "orbit", "unique_frames": 6}
    s = gen.make_stream(t, 3, CAM)
    period = len(s.order)
    assert period == 10
    idx = [s.index(k) for k in range(3 * period)]
    assert all(abs(i - j) == 1 for i, j in zip(idx, idx[1:]))
    assert np.allclose(s.gt_pose(0), np.eye(4))
    assert np.allclose(s.gt_pose(period), np.eye(4), atol=1e-6)


def test_phase_zero_matches_the_port_renderer():
    from cofusion_tpu_torch.config import CameraConfig
    from cofusion_tpu_torch.io import synthetic

    frames = synthetic.make_multi_object_frames(CameraConfig(width=80, height=64, fx=66.0, fy=66.0,
                                                             cx=40.0, cy=32.0), 8, masks=True)
    scene = gen.SyntheticScene(phase0=0.0)
    m = 5
    trajs = {}
    for mid, center, trans, tilt, h in gen.BOXES3:
        scene.add_moving_box(model_id=mid, lo=[-h] * 3, hi=[h] * 3)
        trajs[mid] = gen.object_trajectory(m, trans, center, tilt)
    poses = gen.camera_orbit(m)
    for i in range(m):
        rgb, depth, ids = scene.render(CAM, poses[i], {mid: tr[i] for mid, tr in trajs.items()})
        assert np.array_equal(rgb, frames[i]["rgb"]) and np.array_equal(depth, frames[i]["depth"])
        assert np.array_equal(ids, frames[i]["mask"])
