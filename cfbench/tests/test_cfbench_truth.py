"""The plain reference: exact surfaces and pose errors, against hand values
and against the renderer itself (every rendered pixel, back-projected with
its exact pose, lies on a surface of the scene)."""

import cfbench_paths  # noqa: F401
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import truth
from harness import cell as cells
from harness import compare

gen = cells.generator("synthetic_room")
CAM = gen.Camera(80, 64, 66.0, 66.0, 40.0, 32.0)


def test_box_distance_and_normal_by_hand():
    f = truth.box([-1, -1, -1], [1, 1, 1])
    d, n = f(np.array([[2.0, 0, 0], [0, 0.5, 0], [2.0, 2.0, 0], [0, 0, -1.0]]))
    assert np.allclose(d, [1.0, 0.5, np.sqrt(2.0), 0.0])
    assert np.allclose(n[0], [1, 0, 0]) and np.allclose(n[1], [0, 1, 0])
    assert np.allclose(n[2], [np.sqrt(0.5), np.sqrt(0.5), 0]) and np.allclose(n[3], [0, 0, -1])


def test_placed_box_and_sphere_and_plane():
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec([0, 0, np.pi / 2]).as_matrix()
    T[:3, 3] = [5.0, 0, 0]
    d, n = truth.box([-1, -2, -1], [1, 2, 1], T)(np.array([[5.0, 1.5, 0.0], [8.0, 0.0, 0.0]]))
    # rotated a quarter turn about z: the box's long y side lies along x
    assert np.allclose(d, [0.5, 1.0]) and np.allclose(np.abs(n[1]), [1, 0, 0])
    d, n = truth.sphere([0, 0, 1], 0.5)(np.array([[0, 0, 2.0]]))
    assert np.allclose(d, 0.5) and np.allclose(n, [[0, 0, 1]])
    d, n = truth.plane(1, 1.2)(np.array([[3.0, 1.0, -7.0]]))
    assert np.allclose(d, 0.2) and np.allclose(n, [[0, 1, 0]])


def test_pose_errors_and_orthonormality():
    a = np.eye(4)
    b = np.eye(4)
    b[:3, :3] = Rotation.from_rotvec([0.0, 0.01, 0.0]).as_matrix()
    b[:3, 3] = [0.003, 0.0, 0.004]
    dt, dr = truth.pose_errors(a[None], b[None])
    assert np.allclose(dt, 0.005) and np.allclose(dr, 0.01)
    c = b.copy()
    c[:3, :3] *= 1.001
    assert truth.orthonormality_error(b[None]).max() < 1e-12
    assert truth.orthonormality_error(c[None]).max() == pytest.approx(0.002001, rel=1e-3)
    assert truth.pose_errors(b[None], c[None])[1].max() > 0


@pytest.mark.parametrize("scene", ["orbit", "boxes3"])
def test_rendered_pixels_lie_on_the_scene(scene):
    s = gen.make_stream({"scene": scene, "unique_frames": 5}, 2**31 + 3, CAM)
    for k in (0, 3, 7):
        depth, ids = s.frame(k)["depth"].astype(np.float64), s.ids(k)
        v, u = np.nonzero(depth > 0)
        z = depth[v, u]
        p_cam = np.stack([(u - CAM.cx) / CAM.fx * z, (v - CAM.cy) / CAM.fy * z, z], axis=1)
        p_w = truth.transform(s.cam_pose_w(k), p_cam)
        static = ids[v, u] == 0
        d, _ = truth.surface_distance(p_w[static], np.ones_like(p_w[static]), truth.static_surfaces(s.scene))
        assert d.max() < 1e-4
        for b in (b for b in s.scene.boxes if b.model_id):
            on = ids[v, u] == b.model_id
            d, _ = truth.surface_distance(p_w[on], np.ones_like(p_w[on]),
                                          [truth.box(b.lo, b.hi, s.obj_pose_w(b.model_id, k))])
            assert on.sum() == 0 or d.max() < 1e-4


def test_exact_outputs_read_zero_and_moved_ones_do_not():
    """The comparison's numbers on outputs built from the truth itself."""
    s = gen.make_stream({"scene": "orbit", "unique_frames": 5}, 7, CAM)
    poses = np.stack([s.gt_pose(k)[None] for k in range(6)]).astype(np.float64)
    pts = np.array([[0.1, 0.2, 3.2], [3.2, 0.0, 1.0], [0.0, 1.2, 2.0]])
    nrm = np.array([[0, 0, 1.0], [1.0, 0, 0], [0, 1.0, 0]])
    Winv = np.linalg.inv(s.origin)
    out = {"poses": poses, "maps": [{"pos": truth.transform(Winv, pts), "normal": truth.rotate(Winv, nrm)}]}
    n = compare.numbers(out, s)
    assert n["cam_t_err_m"] < 1e-6 and n["cam_r_err_rad"] < 1e-3 and n["pose_orth_err"] < 1e-6
    assert n["map_med_mm"] < 1e-6 and n["normal_med_deg"] < 1e-3 and n["map_far_share"] == 0.0
    poses[3, 0, 0, 3] += 0.01
    out["maps"][0]["pos"] = out["maps"][0]["pos"] + 0.05
    n = compare.numbers(out, s)
    assert n["cam_t_err_m"] == pytest.approx(0.01, abs=1e-6) and n["map_far_share"] > 0.5
