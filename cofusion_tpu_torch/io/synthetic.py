"""Synthetic RGB-D sequences (analytic raycaster, numpy) — the port's own
copy of cofusion_tpu/io/synthetic.py, frame for frame the same
(tests/test_torch_config.py): a textured room (walls, floor, ceiling) with a
sphere and a box, optional independently moving objects with their exact
per-pixel object ids, and ground-truth camera and object trajectories.
Depth is exact unless noise is asked for.

`make_multi_object_frames` is the multi-object workload: 3 tilted boxes
sliding through the room while the camera orbits, played as a ping-pong so a
loop over it is a continuous trajectory.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cofusion_tpu_torch.config import CameraConfig


def _texture(p: np.ndarray, seed_phase) -> np.ndarray:
    """Smooth procedural RGB texture of 3D points (has usable image gradients)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.25 * np.sin(3.1 * x + seed_phase) + 0.25 * np.sin(7.3 * y + 1.7)
    g = 0.5 + 0.25 * np.sin(2.3 * y + 2.1 + seed_phase) + 0.25 * np.cos(5.9 * z)
    b = 0.5 + 0.25 * np.cos(4.1 * z + 0.6) + 0.25 * np.sin(6.1 * x + seed_phase * 0.5)
    return np.stack([r, g, b], axis=-1)


@dataclasses.dataclass
class Sphere:
    center: np.ndarray
    radius: float
    model_id: int = 0  # 0 = part of the static background
    phase: float = 4.0


@dataclasses.dataclass
class Box:
    lo: np.ndarray
    hi: np.ndarray
    model_id: int = 0
    phase: float = 9.0


class SyntheticScene:
    """A room: walls at z=+D (front), x=+-D, floor at y=+1.2 (y points down),
    plus spheres/boxes.  Camera convention: x right, y down, z forward."""

    def __init__(self, depth_wall: float = 3.2, seed: int = 0):
        self.depth_wall = depth_wall
        self.rng = np.random.default_rng(seed)
        self.spheres: list[Sphere] = [Sphere(center=np.array([0.35, 0.25, 2.1]), radius=0.30)]
        self.boxes: list[Box] = [
            Box(lo=np.array([-0.95, 0.10, 1.55]), hi=np.array([-0.35, 0.70, 2.15])),
        ]

    def add_moving_sphere(self, model_id: int, center, radius: float = 0.22) -> Sphere:
        s = Sphere(center=np.asarray(center, np.float64), radius=radius, model_id=model_id,
                   phase=13.0 + model_id)
        self.spheres.append(s)
        return s

    def add_moving_box(self, model_id: int, lo, hi) -> Box:
        b = Box(lo=np.asarray(lo, np.float64), hi=np.asarray(hi, np.float64), model_id=model_id,
                phase=17.0 + model_id)
        self.boxes.append(b)
        return b

    def render(
        self,
        cam: CameraConfig,
        T_wc: np.ndarray,
        object_poses: dict[int, np.ndarray] | None = None,
        depth_noise: float = 0.0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rgb uint8 (H,W,3), depth float32 metres (H,W), object id uint8
        (H,W)) seen from the camera-to-world pose `T_wc`.  `object_poses`
        maps model_id -> 4x4 object-to-world pose applied on top of the
        object's rest geometry."""
        H, W = cam.height, cam.width
        u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
        d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1)
        R, t = T_wc[:3, :3], T_wc[:3, 3]
        d = d_cam @ R.T  # world-frame rays; the ray parameter is camera-z depth
        o = t

        best_t = np.full((H, W), np.inf)
        hit_point = np.zeros((H, W, 3))
        hit_id = np.zeros((H, W), np.uint8)
        hit_phase = np.zeros((H, W))

        def consider(t_hit, model_id, phase):
            nonlocal best_t, hit_point, hit_id, hit_phase
            ok = np.isfinite(t_hit) & (t_hit > 0.05) & (t_hit < best_t)
            best_t = np.where(ok, t_hit, best_t)
            with np.errstate(invalid="ignore"):
                p = o + np.where(np.isfinite(t_hit), t_hit, 0.0)[..., None] * d
            hit_point = np.where(ok[..., None], p, hit_point)
            hit_id = np.where(ok, np.uint8(model_id), hit_id)
            hit_phase = np.where(ok, phase, hit_phase)

        # walls: front z=+D, sides x=+-D, floor y=+1.2, ceiling y=-1.2
        for axis, value, phase in (
            (2, self.depth_wall, 0.0),
            (0, self.depth_wall, 1.0),
            (0, -self.depth_wall, 2.0),
            (1, 1.2, 3.0),
            (1, -1.2, 3.5),
        ):
            denom = d[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_hit = (value - o[axis]) / denom
            consider(np.where(np.abs(denom) > 1e-9, t_hit, np.inf), 0, phase)

        for s in self.spheres:
            center = s.center
            if object_poses and s.model_id in object_poses:
                T = object_poses[s.model_id]
                center = T[:3, :3] @ s.center + T[:3, 3]
            oc = o - center
            b = np.sum(d * oc, axis=-1)
            a = np.sum(d * d, axis=-1)
            c = np.sum(oc * oc, axis=-1) - s.radius**2
            disc = b * b - a * c
            with np.errstate(invalid="ignore"):
                t_hit = (-b - np.sqrt(np.maximum(disc, 0.0))) / a
            consider(np.where(disc > 0, t_hit, np.inf), s.model_id, s.phase)

        for box in self.boxes:
            lo, hi = box.lo, box.hi
            o_l, d_l = o, d
            if object_poses and box.model_id in object_poses:
                Tinv = np.linalg.inv(object_poses[box.model_id])
                o_l = Tinv[:3, :3] @ o + Tinv[:3, 3]
                d_l = d @ Tinv[:3, :3].T
            with np.errstate(divide="ignore", invalid="ignore"):
                t1 = (lo - o_l) / d_l
                t2 = (hi - o_l) / d_l
            tmin = np.max(np.minimum(t1, t2), axis=-1)
            tmax = np.min(np.maximum(t1, t2), axis=-1)
            consider(np.where((tmax > tmin) & (tmax > 0), tmin, np.inf), box.model_id, box.phase)

        depth = np.where(np.isfinite(best_t), best_t, 0.0).astype(np.float32)
        rgb = np.clip(_texture(hit_point, hit_phase) * 255.0, 0, 255).astype(np.uint8)
        # no 0-intensity pixels: the reference treats intensity 0 as invalid
        rgb = np.maximum(rgb, 8)
        if depth_noise > 0:
            noise = self.rng.standard_normal(depth.shape) * depth_noise * (depth > 0)
            depth = depth + noise.astype(np.float32)
        return rgb, depth, hit_id


def camera_trajectory(n_frames: int, kind: str = "orbit", scale: float = 1.0) -> list[np.ndarray]:
    """Ground-truth camera-to-world poses.  'orbit': slow arc with slight
    rotation; 'still': identity; 'forward': dolly along +z."""
    poses = []
    for i in range(n_frames):
        T = np.eye(4)
        s = i / max(n_frames - 1, 1)
        if kind == "orbit":
            ang = 0.12 * s * scale
            ca, sa = np.cos(ang), np.sin(ang)
            T[:3, :3] = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
            T[:3, 3] = np.array([0.25 * s * scale, 0.05 * np.sin(2 * np.pi * s) * scale, 0.10 * s * scale])
        elif kind == "forward":
            T[:3, 3] = np.array([0.0, 0.0, 0.4 * s * scale])
        poses.append(T)
    return poses


def object_trajectory(
    n_frames: int,
    translation=(0.25, 0.0, 0.0),
    center=(0.0, 0.0, 0.0),
    tilt=(0.0, 0.0, 0.0),
) -> list[np.ndarray]:
    """Object-to-world poses: a linear slide of an object whose rest pose is
    Trans(center) @ Rot(tilt) (a tilted box shows three face normals, so
    geometry alone constrains all 6 DoF)."""
    from scipy.spatial.transform import Rotation

    out = []
    tr = np.asarray(translation, np.float64)
    base = np.eye(4)
    base[:3, :3] = Rotation.from_rotvec(tilt).as_matrix()
    base[:3, 3] = np.asarray(center, np.float64)
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        T = np.eye(4)
        T[:3, 3] = tr * s
        out.append(T @ base)
    return out


def make_sequence(
    cam: CameraConfig,
    n_frames: int,
    kind: str = "orbit",
    moving_object: bool = False,
    depth_noise: float = 0.0,
    seed: int = 0,
    object_half: float = 0.19,
):
    """(frames, gt_cam_poses, gt_obj_poses): each frame a dict with
    rgb/depth/mask/timestamp (the reference's FrameData,
    Core/FrameData.h:25-42); `moving_object` adds one sliding tilted box
    with object id 1 (gt_obj_poses is None without it)."""
    scene = SyntheticScene(seed=seed)
    obj_poses_seq = None
    if moving_object:
        h = object_half
        scene.add_moving_box(model_id=1, lo=[-h, -h, -h], hi=[h, h, h])
        obj_poses_seq = object_trajectory(
            n_frames, translation=(0.22, 0.1, 0.0), center=(0.14, -0.32, 1.82), tilt=(0.35, 0.5, 0.0),
        )
    cam_poses = camera_trajectory(n_frames, kind=kind)
    frames = []
    for i, T in enumerate(cam_poses):
        op = {1: obj_poses_seq[i]} if moving_object else None
        rgb, depth, mask = scene.render(cam, T, object_poses=op, depth_noise=depth_noise)
        frames.append({"rgb": rgb, "depth": depth, "mask": mask, "timestamp": i})
    return frames, cam_poses, obj_poses_seq


def make_multi_object_frames(cam: CameraConfig, n: int, masks: bool = False):
    """3 tilted moving boxes (sliding like the car4 objects) and an orbiting
    camera, `n` frames.  The cycle is a ping-pong (poses run 0..1..0), so
    replaying it in a loop is a continuous trajectory.  Without `masks` the
    frames carry mask None (the CRF path segments them itself); with it,
    the renderer's exact object ids (ids 1-3, the GT-mask path's input)."""
    scene = SyntheticScene()
    specs = [
        (1, (0.14, -0.32, 1.82), (0.22, 0.10, 0.0), (0.35, 0.5, 0.0), 0.19),
        (2, (-0.55, 0.45, 2.30), (-0.18, 0.00, 0.12), (0.2, -0.4, 0.3), 0.16),
        (3, (0.75, 0.55, 2.60), (0.00, -0.20, -0.10), (-0.3, 0.25, 0.4), 0.17),
    ]
    m = n // 2 + 1  # unique poses; playback order 0..m-1, m-2..1 has period n
    trajs = {}
    for mid, center, trans, tilt, h in specs:
        scene.add_moving_box(model_id=mid, lo=[-h, -h, -h], hi=[h, h, h])
        trajs[mid] = object_trajectory(m, translation=trans, center=center, tilt=tilt)
    cam_poses = camera_trajectory(m, kind="orbit")
    uniq = []
    for i in range(m):
        op = {mid: trajs[mid][i] for mid in trajs}
        rgb, depth, ids = scene.render(cam, cam_poses[i], object_poses=op)
        uniq.append({"rgb": rgb, "depth": depth, "mask": ids if masks else None})
    order = list(range(m)) + list(range(m - 2, 0, -1))
    return [dict(uniq[j], timestamp=i) for i, j in enumerate(order[:n])]
