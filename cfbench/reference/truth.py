"""The plain reference that decides `correct`: the generated scene's exact
surfaces and poses, in NumPy and float64.  It imports nothing of the
program and takes nothing the program made; the generator's scene, camera
poses and object poses are the benchmark's own inputs.

Surfaces are the room's planes, spheres and boxes.  `surface_distance`
gives, for points and their normals, the distance to the nearest surface
and the angle between each normal and that surface's normal (unsigned:
a surfel's normal faces the camera that saw it, either side of a plane).
"""

from __future__ import annotations

import numpy as np

BLOCK = 1 << 20


def plane(axis: int, value: float):
    def f(p):
        n = np.zeros_like(p)
        n[:, axis] = 1.0
        return np.abs(p[:, axis] - value), n
    return f


def sphere(center, radius: float):
    c = np.asarray(center, np.float64)

    def f(p):
        v = p - c
        r = np.linalg.norm(v, axis=1)
        return np.abs(r - radius), v / np.maximum(r, 1e-12)[:, None]
    return f


def box(lo, hi, pose: np.ndarray | None = None):
    """Surface of the box [lo, hi] in its own frame, placed by the 4x4
    `pose` (box frame to the frame of the points; identity if None)."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    c, h = (lo + hi) / 2.0, (hi - lo) / 2.0
    T = np.eye(4) if pose is None else np.asarray(pose, np.float64)
    R, t = T[:3, :3], T[:3, 3]

    def f(p):
        q = (p - t) @ R - c                 # points in the box frame, centred
        d = np.abs(q) - h
        out = np.maximum(d, 0.0)
        outside = np.linalg.norm(out, axis=1)
        inside = d.max(axis=1)
        dist = np.where(inside > 0, outside, -inside)
        # normal: the outward direction of the nearest face (or edge/corner)
        n_out = out * np.sign(q)
        n_in = np.zeros_like(q)
        ax = d.argmax(axis=1)
        n_in[np.arange(len(q)), ax] = np.sign(q[np.arange(len(q)), ax])
        n = np.where((inside > 0)[:, None], n_out, n_in)
        n = n / np.maximum(np.linalg.norm(n, axis=1), 1e-12)[:, None]
        return dist, n @ R.T
    return f


def static_surfaces(scene) -> list:
    """Every surface of `scene` that does not move: planes, spheres and the
    boxes with model id 0."""
    out = [plane(a, v) for a, v, _ in scene.planes]
    out += [sphere(s.center, s.radius) for s in scene.spheres if s.model_id == 0]
    out += [box(b.lo, b.hi) for b in scene.boxes if b.model_id == 0]
    return out


def surface_distance(points: np.ndarray, normals: np.ndarray, surfaces: list):
    """(distance to the nearest surface, unsigned angle in radians between
    each normal and that surface's normal), per point."""
    points = np.asarray(points, np.float64)
    normals = np.asarray(normals, np.float64)
    dist = np.empty(len(points))
    ang = np.empty(len(points))
    for s in range(0, len(points), BLOCK):
        p, nrm = points[s:s + BLOCK], normals[s:s + BLOCK]
        best = np.full(len(p), np.inf)
        best_n = np.zeros_like(p)
        for f in surfaces:
            d, n = f(p)
            take = d < best
            best = np.where(take, d, best)
            best_n = np.where(take[:, None], n, best_n)
        nn = nrm / np.maximum(np.linalg.norm(nrm, axis=1), 1e-12)[:, None]
        cos = np.abs(np.sum(nn * best_n, axis=1))
        dist[s:s + BLOCK] = best
        ang[s:s + BLOCK] = np.arccos(np.clip(cos, 0.0, 1.0))
    return dist, ang


def transform(T: np.ndarray, p: np.ndarray) -> np.ndarray:
    return p @ T[:3, :3].T + T[:3, 3]


def rotate(T: np.ndarray, n: np.ndarray) -> np.ndarray:
    return n @ T[:3, :3].T


def pose_errors(est: np.ndarray, gt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per pose: the translation gap in metres, and the rotation angle from
    the chord |R_est - R_gt|_F = 2 sqrt(2) sin(angle / 2) (both (..., 4, 4));
    a rotation block that is not orthonormal reads as a gap too."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    dt = np.linalg.norm(est[..., :3, 3] - gt[..., :3, 3], axis=-1)
    chord = np.linalg.norm(est[..., :3, :3] - gt[..., :3, :3], axis=(-2, -1))
    return dt, 2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))


def orthonormality_error(poses: np.ndarray) -> np.ndarray:
    """Per pose, the largest entry of |R^T R - I|: a rigid motion's rotation
    block is orthonormal, which float32 arithmetic keeps to about 1e-6."""
    R = np.asarray(poses, np.float64)[..., :3, :3]
    return np.abs(np.swapaxes(R, -1, -2) @ R - np.eye(3)).max(axis=(-2, -1))
