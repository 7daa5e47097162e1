"""Synthetic RGB-D sequence of a static scene (analytic raycaster, numpy) —
the static part of cofusion_tpu/io/synthetic.py, frame for frame the same
(tests/test_torch_config.py): a textured room (walls, floor, ceiling) with a
sphere and a box, seen from a slow orbit of the camera.  Depth is exact.
"""

from __future__ import annotations

import numpy as np

from cofusion_tpu_torch.config import CameraConfig

# the front wall's depth, and (centre, radius, texture phase) and
# (lo, hi, texture phase) of the objects in the room
_DEPTH_WALL = 3.2
_SPHERES = ((np.array([0.35, 0.25, 2.1]), 0.30, 4.0),)
_BOXES = ((np.array([-0.95, 0.10, 1.55]), np.array([-0.35, 0.70, 2.15]), 9.0),)


def _texture(p: np.ndarray, seed_phase) -> np.ndarray:
    """Smooth procedural RGB texture of 3D points (has usable image gradients)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.25 * np.sin(3.1 * x + seed_phase) + 0.25 * np.sin(7.3 * y + 1.7)
    g = 0.5 + 0.25 * np.sin(2.3 * y + 2.1 + seed_phase) + 0.25 * np.cos(5.9 * z)
    b = 0.5 + 0.25 * np.cos(4.1 * z + 0.6) + 0.25 * np.sin(6.1 * x + seed_phase * 0.5)
    return np.stack([r, g, b], axis=-1)


def render(cam: CameraConfig, T_wc: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rgb uint8 (H,W,3), depth float32 metres (H,W), mask uint8 (H,W)) seen
    from the camera-to-world pose `T_wc` (x right, y down, z forward)."""
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1)
    d = d_cam @ T_wc[:3, :3].T  # world-frame rays; the ray parameter is camera-z depth
    o = T_wc[:3, 3]

    best_t = np.full((H, W), np.inf)
    hit_point = np.zeros((H, W, 3))
    hit_phase = np.zeros((H, W))

    def consider(t_hit, phase):
        nonlocal best_t, hit_point, hit_phase
        ok = np.isfinite(t_hit) & (t_hit > 0.05) & (t_hit < best_t)
        best_t = np.where(ok, t_hit, best_t)
        with np.errstate(invalid="ignore"):
            p = o + np.where(np.isfinite(t_hit), t_hit, 0.0)[..., None] * d
        hit_point = np.where(ok[..., None], p, hit_point)
        hit_phase = np.where(ok, phase, hit_phase)

    # walls: front z=+D, sides x=+-D, floor y=+1.2, ceiling y=-1.2
    for axis, value, phase in (
        (2, _DEPTH_WALL, 0.0),
        (0, _DEPTH_WALL, 1.0),
        (0, -_DEPTH_WALL, 2.0),
        (1, 1.2, 3.0),
        (1, -1.2, 3.5),
    ):
        denom = d[..., axis]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_hit = (value - o[axis]) / denom
        consider(np.where(np.abs(denom) > 1e-9, t_hit, np.inf), phase)

    for center, radius, phase in _SPHERES:
        oc = o - center
        b = np.sum(d * oc, axis=-1)
        a = np.sum(d * d, axis=-1)
        c = np.sum(oc * oc, axis=-1) - radius**2
        disc = b * b - a * c
        with np.errstate(invalid="ignore"):
            t_hit = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
        consider(np.where(disc > 0, t_hit, np.inf), phase)

    for lo, hi, phase in _BOXES:
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (lo - o) / d
            t2 = (hi - o) / d
        tmin = np.max(np.minimum(t1, t2), axis=-1)
        tmax = np.min(np.maximum(t1, t2), axis=-1)
        consider(np.where((tmax > tmin) & (tmax > 0), tmin, np.inf), phase)

    depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
    rgb = np.clip(_texture(hit_point, hit_phase) * 255.0, 0, 255).astype(np.uint8)
    # no 0-intensity pixels: the reference treats intensity 0 as invalid
    rgb = np.maximum(rgb, 8)
    return rgb, depth, np.zeros((H, W), np.uint8)


def camera_trajectory(n_frames: int) -> list[np.ndarray]:
    """Ground-truth camera-to-world poses: a slow arc with slight rotation
    (the reference package's 'orbit')."""
    poses = []
    for i in range(n_frames):
        T = np.eye(4)
        s = i / max(n_frames - 1, 1)
        ang = 0.12 * s
        ca, sa = np.cos(ang), np.sin(ang)
        T[:3, :3] = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        T[:3, 3] = np.array([0.25 * s, 0.05 * np.sin(2 * np.pi * s), 0.10 * s])
        poses.append(T)
    return poses


def make_sequence(cam: CameraConfig, n_frames: int):
    """(frames, gt_cam_poses): each frame a dict with rgb/depth/mask/timestamp
    (the reference's FrameData, Core/FrameData.h:25-42)."""
    cam_poses = camera_trajectory(n_frames)
    frames = []
    for i, T in enumerate(cam_poses):
        rgb, depth, mask = render(cam, T)
        frames.append({"rgb": rgb, "depth": depth, "mask": mask, "timestamp": i})
    return frames, cam_poses
