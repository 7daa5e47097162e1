"""Synthetic RGB-D streams for the benchmark: a frozen copy of the port's
`io/synthetic.py` raycaster (a textured room with a sphere and a box, and
optionally tilted boxes that slide through it with their exact per-pixel
ids), with two additions drawn from the run's seed: a phase added to every
surface's texture, and the frame of the ping-pong at which playback starts.
Neither changes the work a frame costs: sizes, poses and the playback
period are the traffic file's.  The scene's exact surfaces and poses stay
with the stream, for the comparison that decides `correct`.

A traffic file names this generator and sets:
  scene          "orbit" (static room, camera orbit) or "boxes3" (three
                 tilted boxes sliding while the camera orbits)
  unique_frames  distinct poses m; playback runs 0..m-1..1, period 2m-2,
                 so looping it is a continuous trajectory
  masks          feed the renderer's object ids as masks (the GT-mask path)
  gt_pose        feed each frame its ground-truth camera pose ('-p')
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy.spatial.transform import Rotation


@dataclasses.dataclass(frozen=True)
class Camera:
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


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
    model_id: int = 0
    phase: float = 4.0


@dataclasses.dataclass
class Box:
    lo: np.ndarray
    hi: np.ndarray
    model_id: int = 0
    phase: float = 9.0


class SyntheticScene:
    """A room: walls at z=+D (front), x=+-D, floor at y=+1.2 (y points down),
    ceiling at y=-1.2, plus spheres/boxes.  Camera convention: x right, y
    down, z forward.  `phase0` is added to every surface's texture phase."""

    def __init__(self, depth_wall: float = 3.2, phase0: float = 0.0):
        self.depth_wall = depth_wall
        self.phase0 = phase0
        D = depth_wall
        # (axis, value, texture phase) of the walls, floor and ceiling
        self.planes = ((2, D, 0.0), (0, D, 1.0), (0, -D, 2.0), (1, 1.2, 3.0), (1, -1.2, 3.5))
        self.spheres: list[Sphere] = [Sphere(center=np.array([0.35, 0.25, 2.1]), radius=0.30)]
        self.boxes: list[Box] = [
            Box(lo=np.array([-0.95, 0.10, 1.55]), hi=np.array([-0.35, 0.70, 2.15])),
        ]

    def add_moving_box(self, model_id: int, lo, hi) -> Box:
        b = Box(lo=np.asarray(lo, np.float64), hi=np.asarray(hi, np.float64), model_id=model_id,
                phase=17.0 + model_id)
        self.boxes.append(b)
        return b

    def render(self, cam: Camera, T_wc: np.ndarray, object_poses: dict | None = None):
        """(rgb uint8 (H,W,3), depth float32 metres (H,W), object id uint8
        (H,W)) seen from the camera-to-world pose `T_wc`; `object_poses`
        maps model_id -> 4x4 object-to-world pose on top of the rest pose."""
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

        for axis, value, phase in self.planes:
            denom = d[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t_hit = (value - o[axis]) / denom
            consider(np.where(np.abs(denom) > 1e-9, t_hit, np.inf), 0, phase)

        for s in self.spheres:
            oc = o - s.center
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
        rgb = np.clip(_texture(hit_point, hit_phase + self.phase0) * 255.0, 0, 255).astype(np.uint8)
        # no 0-intensity pixels: the reference treats intensity 0 as invalid
        rgb = np.maximum(rgb, 8)
        return rgb, depth, hit_id


def camera_orbit(n_frames: int) -> list[np.ndarray]:
    """Ground-truth camera-to-world poses of a slow arc with slight rotation."""
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


def object_trajectory(n_frames: int, translation, center, tilt) -> list[np.ndarray]:
    """Object-to-world poses: a linear slide of an object whose rest pose is
    Trans(center) @ Rot(tilt)."""
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


# the three sliding boxes: (id, rest centre, slide, tilt, half size)
BOXES3 = (
    (1, (0.14, -0.32, 1.82), (0.22, 0.10, 0.0), (0.35, 0.5, 0.0), 0.19),
    (2, (-0.55, 0.45, 2.30), (-0.18, 0.00, 0.12), (0.2, -0.4, 0.3), 0.16),
    (3, (0.75, 0.55, 2.60), (0.00, -0.20, -0.10), (-0.3, 0.25, 0.4), 0.17),
)


class Stream:
    """The cell's frames: `unique` rendered once, played as a ping-pong from
    `start`.  `frame(k)` is the k-th frame fed to the engine (timestamp k),
    `gt_pose(k)` its ground-truth camera pose relative to frame 0's.
    `scene`, `cam_pose_w(k)` and `obj_pose_w(id, k)` are the exact scene and
    poses in the renderer's world frame; `origin` maps the engine's world
    (frame 0's camera) into it."""

    def __init__(self, unique, cam_poses, start: int, masks: bool, gt_pose: bool,
                 scene: SyntheticScene | None = None, obj_poses: dict | None = None):
        m = len(unique)
        self.unique = unique
        self.order = list(range(m)) + list(range(m - 2, 0, -1))
        self.start = start % len(self.order)
        self.masks = masks
        self.feeds_gt_pose = gt_pose
        self.scene = scene
        self._cam_poses = cam_poses
        self._obj_poses = obj_poses or {}
        self.origin = np.asarray(cam_poses[self.order[self.start]], np.float64)
        self._origin_inv = np.linalg.inv(self.origin)

    def index(self, k: int) -> int:
        return self.order[(self.start + k) % len(self.order)]

    def cam_pose_w(self, k: int) -> np.ndarray:
        return np.asarray(self._cam_poses[self.index(k)], np.float64)

    def obj_pose_w(self, model_id: int, k: int) -> np.ndarray:
        """Object-to-world pose of moving box `model_id` in frame k."""
        return np.asarray(self._obj_poses[model_id][self.index(k)], np.float64)

    def frame(self, k: int) -> dict:
        u = self.unique[self.index(k)]
        return {"rgb": u[0], "depth": u[1], "mask": u[2] if self.masks else None, "timestamp": k}

    def gt_pose(self, k: int) -> np.ndarray:
        return (self._origin_inv @ self._cam_poses[self.index(k)]).astype(np.float32)

    def ids(self, k: int) -> np.ndarray:
        return self.unique[self.index(k)][2]


def seed_draws(seed: int, period: int) -> tuple[float, int]:
    """(texture phase in [0, 2 pi), start frame in [0, period)) of a seed;
    any integer seed, negative or wider than 64 bits included."""
    rng = np.random.default_rng(seed % (1 << 64))
    return float(rng.uniform(0.0, 2.0 * np.pi)), int(rng.integers(0, period))


def make_stream(traffic: dict, seed: int, cam: Camera, workers: int | None = None) -> Stream:
    m = int(traffic["unique_frames"])
    phase0, start = seed_draws(seed, 2 * m - 2)
    scene = SyntheticScene(phase0=phase0)
    cam_poses = camera_orbit(m)
    obj = {}
    if traffic["scene"] == "boxes3":
        for mid, center, trans, tilt, h in BOXES3:
            scene.add_moving_box(model_id=mid, lo=[-h, -h, -h], hi=[h, h, h])
            obj[mid] = object_trajectory(m, trans, center, tilt)
    elif traffic["scene"] != "orbit":
        raise ValueError(f"unknown scene {traffic['scene']!r}")

    def render(i):
        return scene.render(cam, cam_poses[i], {mid: tr[i] for mid, tr in obj.items()} or None)

    # numpy releases the interpreter lock in its large array operations
    n = workers or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=n) as pool:
        unique = list(pool.map(render, range(m)))
    return Stream(unique, cam_poses, start, bool(traffic.get("masks")), bool(traffic.get("gt_pose")),
                  scene=scene, obj_poses=obj)
