"""The port's own configuration and synthetic frames against the JAX
package's: every field the port keeps has the reference's name and default,
the derived capacities agree, and the static synthetic orbit is the same
frame for frame, byte for byte (both are numpy)."""

import dataclasses

import numpy as np
import pytest

from cofusion_tpu import config as jcfg
from cofusion_tpu.io import synthetic as jsyn
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.io import synthetic as tsyn


@pytest.mark.parametrize("name", ["CameraConfig", "CoFusionConfig", "TrackingParams", "FusionParams"])
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
     dict(active_surfels=1 << 12, expel_block_log2=14)],
)
def test_derived_capacities_match(kw):
    port, ref = tcfg.CoFusionConfig(**kw), jcfg.CoFusionConfig(**kw)
    assert (port.active_capacity, port.expel_block) == (ref.active_capacity, ref.expel_block)


@pytest.mark.parametrize("level", [0, 1, 2])
def test_camera_levels_match(level):
    port = tcfg.CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
    ref = jcfg.CameraConfig(**dataclasses.asdict(port))
    assert dataclasses.asdict(port.at_level(level)) == dataclasses.asdict(ref.at_level(level))
    assert port.at_level(level).mean_focal == ref.at_level(level).mean_focal


@pytest.mark.parametrize("n_frames", [1, 4])
def test_synthetic_orbit_matches(n_frames):
    cam = dict(width=80, height=64, fx=66.0, fy=66.0, cx=40.0, cy=32.0)
    frames_t, gt_t = tsyn.make_sequence(tcfg.CameraConfig(**cam), n_frames)
    frames_j, gt_j, _ = jsyn.make_sequence(jcfg.CameraConfig(**cam), n_frames, kind="orbit")
    for t, j in zip(frames_t, frames_j):
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    for t, j in zip(gt_t, gt_j):
        np.testing.assert_array_equal(t, j)
