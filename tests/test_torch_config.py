"""The port's own configuration and synthetic frames against the JAX
package's: every field the port keeps has the reference's name and default,
the derived capacities agree, and the synthetic sequences (the static
orbit, the moving-object sequence with its object ids, the bench's
multi-object workload) are the same frame for frame, byte for byte (both
are numpy)."""

import dataclasses

import numpy as np
import pytest

from cofusion_tpu import config as jcfg
from cofusion_tpu.io import synthetic as jsyn
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.io import synthetic as tsyn


@pytest.mark.parametrize(
    "name", ["CameraConfig", "CoFusionConfig", "TrackingParams", "FusionParams", "SegmentationParams"]
)
def test_fields_and_defaults_match(name):
    port, ref = getattr(tcfg, name)(), getattr(jcfg, name)()
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):  # the nested camera
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name


@pytest.mark.parametrize(
    "kw",
    [{}, dict(max_surfels=1 << 17), dict(max_surfels=1 << 21, active_surfels=1 << 20),
     dict(active_surfels=1 << 12, expel_block_log2=14), dict(object_active_surfels=1 << 10)],
)
def test_derived_capacities_match(kw):
    port, ref = tcfg.CoFusionConfig(**kw), jcfg.CoFusionConfig(**kw)
    assert (port.active_capacity, port.expel_block, port.object_active_capacity) == (
        ref.active_capacity, ref.expel_block, ref.object_active_capacity
    )


@pytest.mark.parametrize(
    "name,fields",
    [("CoFusionConfig", ["object_active_surfels", "superpixel_size", "crf_iterations", "slic_iterations"]),
     ("FusionParams", ["confidence_object", "model_spawn_offset", "model_deactivate_count"]),
     ("CoFusionConfig", ["deform_nodes", "cons_sample"]),
     ("FusionParams", ["fern_min_age", "fern_icp_error_thresh", "fern_photo_thresh", "fern_thresh",
                       "local_loop_cov_thresh", "local_loop_err_thresh", "local_loop_count_thresh"])],
)
def test_multi_model_fields_present(name, fields):
    """The multi-model path's, relocalisation's and loop closure's fields
    exist in the port under the JAX names, with the JAX defaults."""
    port, ref = getattr(tcfg, name)(), getattr(jcfg, name)()
    for f in fields:
        assert getattr(port, f) == getattr(ref, f), f


@pytest.mark.parametrize("level", [0, 1, 2])
def test_camera_levels_match(level):
    port = tcfg.CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
    ref = jcfg.CameraConfig(**dataclasses.asdict(port))
    assert dataclasses.asdict(port.at_level(level)) == dataclasses.asdict(ref.at_level(level))
    assert port.at_level(level).mean_focal == ref.at_level(level).mean_focal


@pytest.mark.parametrize("n_frames", [1, 4])
def test_synthetic_orbit_matches(n_frames):
    cam = dict(width=80, height=64, fx=66.0, fy=66.0, cx=40.0, cy=32.0)
    frames_t, gt_t, obj_t = tsyn.make_sequence(tcfg.CameraConfig(**cam), n_frames)
    frames_j, gt_j, obj_j = jsyn.make_sequence(jcfg.CameraConfig(**cam), n_frames, kind="orbit")
    assert obj_t is None and obj_j is None
    _assert_frames_equal(frames_t, frames_j)
    for t, j in zip(gt_t, gt_j):
        np.testing.assert_array_equal(t, j)


_CAM = dict(width=80, height=64, fx=66.0, fy=66.0, cx=40.0, cy=32.0)


def _assert_frames_equal(frames_t, frames_j):
    assert len(frames_t) == len(frames_j)
    for t, j in zip(frames_t, frames_j):
        assert t.keys() == j.keys()
        for k in t:
            if t[k] is None or j[k] is None:
                assert t[k] is None and j[k] is None, k
            else:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("kind,noise", [("orbit", 0.0), ("forward", 0.01), ("still", 0.0)])
def test_moving_object_sequence_matches(kind, noise):
    """One sliding tilted box with object id 1 (depth noise from the seed)."""
    frames_t, gt_t, obj_t = tsyn.make_sequence(
        tcfg.CameraConfig(**_CAM), 5, kind=kind, moving_object=True, depth_noise=noise, seed=2
    )
    frames_j, gt_j, obj_j = jsyn.make_sequence(
        jcfg.CameraConfig(**_CAM), 5, kind=kind, moving_object=True, depth_noise=noise, seed=2
    )
    _assert_frames_equal(frames_t, frames_j)
    assert (frames_t[-1]["mask"] == 1).sum() > 20
    for a, b in zip(gt_t + obj_t, gt_j + obj_j):
        np.testing.assert_array_equal(a, b)


def test_scene_with_moving_sphere_matches():
    poses = {2: np.array([[1, 0, 0, 0.1], [0, 1, 0, 0.0], [0, 0, 1, 0.05], [0, 0, 0, 1]], float)}
    cam_pose = tsyn.camera_trajectory(3, kind="orbit", scale=0.5)[1]
    assert np.array_equal(cam_pose, jsyn.camera_trajectory(3, kind="orbit", scale=0.5)[1])
    out = []
    for syn, cfg in ((tsyn, tcfg), (jsyn, jcfg)):
        scene = syn.SyntheticScene()
        scene.add_moving_sphere(2, center=(0.0, 0.1, 1.6))
        out.append(scene.render(cfg.CameraConfig(**_CAM), cam_pose, object_poses=poses))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert (out[0][2] == 2).sum() > 20


def test_multi_object_frames_match_bench():
    """The port's copy of bench.py's workload (3 tilted sliding boxes, an
    orbiting camera, ping-pong playback) equals the bench's frames; with
    `masks` it carries the renderer's object ids."""
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "bench", pathlib.Path(__file__).resolve().parents[1] / "bench.py"
    )
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    frames_j = bench.make_multi_object_frames(jcfg.CameraConfig(**_CAM), 8)
    frames_t = tsyn.make_multi_object_frames(tcfg.CameraConfig(**_CAM), 8)
    _assert_frames_equal(frames_t, frames_j)
    with_ids = tsyn.make_multi_object_frames(tcfg.CameraConfig(**_CAM), 8, masks=True)
    assert set(np.unique(with_ids[0]["mask"]).tolist()) == {0, 1, 2, 3}
    for a, b in zip(with_ids, frames_t):
        np.testing.assert_array_equal(a["depth"], b["depth"])
