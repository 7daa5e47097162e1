"""The comparison that decides `correct`: what the timed path produced
against the generated scene's exact poses and surfaces (reference/truth.py).

Numbers (each 0 for a perfect result):
  cam_t_err_m      largest translation error of the camera (slot 0) in any
                   frame, against its exact pose relative to frame 0's
  cam_r_err_rad    largest rotation error of the camera, likewise
  pose_orth_err    largest |R^T R - I| entry of any slot's pose in any
                   frame: every pose is a rigid motion
  map_med_mm       median distance of slot 0's surfels to the nearest
                   static surface of the scene, in mm
  map_p90_mm       90th percentile of that distance, in mm
  map_far_share    share of slot 0's surfels more than 2 cm from every
                   static surface
  normal_med_deg   median angle between slot 0's surfel normals and the
                   nearest static surface's normal, in degrees
and with moving objects (multi-model cells):
  obj_t_err_m      largest translation error of any active object slot's
                   pose, in any frame since it spawned, against the exact
                   pose of the box its map lies on
  obj_r_err_rad    largest rotation error, likewise
  obj_map_med_mm   largest, over active object slots, median distance of
                   the slot's surfels to that box's surface, in mm
  label_err        share of pixels, over the segmentations the engine
                   still holds, where "some object slot" disagrees with
                   "a moving box" in the renderer's ids
A cell's checks file names the numbers it compares and their limits; the
others are printed and not compared.  The control (`tf32`) runs the
program with TF32 matmuls.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np

import truth

FAR_M = 0.02


def _inv(T):
    return np.linalg.inv(np.asarray(T, np.float64))


def camera_errors(poses: np.ndarray, stream) -> tuple[np.ndarray, np.ndarray]:
    """Per frame, the camera's translation and rotation error."""
    gt = np.stack([stream.gt_pose(k) for k in range(len(poses))]).astype(np.float64)
    dt, dr = truth.pose_errors(poses[:, 0], gt)
    bad = ~np.isfinite(poses[:, 0]).all(axis=(-2, -1))
    return np.where(bad, math.inf, dt), np.where(bad, math.inf, dr)


def _spawn_frame(poses: np.ndarray, m: int) -> int | None:
    """The last frame at which slot m was (re)spawned: a spawned slot starts
    at exactly the identity pose, its map in that frame's camera coordinates."""
    eye = np.eye(4)
    at = [k for k in range(1, len(poses)) if np.array_equal(poses[k, m], eye)]
    return at[-1] if at else None


def _object_numbers(out: dict, stream) -> dict:
    scene = stream.scene
    movers = [b for b in scene.boxes if b.model_id > 0]
    poses = out["poses"]
    t_err, r_err, med = [0.0], [0.0], [0.0]
    slots = []
    for m in range(1, len(out["maps"])):
        mp = out["maps"][m]
        if not out["active"][m] or len(mp["pos"]) == 0:
            continue
        t0 = _spawn_frame(poses, m)
        if t0 is None:
            return {"obj_t_err_m": math.inf, "obj_r_err_rad": math.inf, "obj_map_med_mm": math.inf}
        C0 = stream.cam_pose_w(t0)
        best = None
        for b in movers:
            # the slot's map lives in frame t0's camera coordinates
            O0 = stream.obj_pose_w(b.model_id, t0)
            d, _ = truth.surface_distance(mp["pos"], mp["normal"], [truth.box(b.lo, b.hi, _inv(C0) @ O0)])
            cand = (float(np.median(d)), b.model_id)
            best = cand if best is None or cand < best else best
        med.append(best[0] * 1e3)
        mid = best[1]
        O0 = stream.obj_pose_w(mid, t0)
        gt = np.stack([_inv(C0) @ O0 @ _inv(stream.obj_pose_w(mid, t)) @ stream.cam_pose_w(t)
                       for t in range(t0, len(poses))])
        dt, dr = truth.pose_errors(poses[t0:, m], gt)
        t_err.append(float(dt.max()))
        r_err.append(float(dr.max()))
        slots.append((m, t0, mid))
    return {"obj_t_err_m": max(t_err), "obj_r_err_rad": max(r_err), "obj_map_med_mm": max(med),
            "_object_slots": slots}


def numbers(out: dict, stream) -> dict:
    dt, dr = camera_errors(out["poses"], stream)
    n = {"cam_t_err_m": float(dt.max()), "cam_r_err_rad": float(dr.max())}
    orth = truth.orthonormality_error(out["poses"])
    n["pose_orth_err"] = float(orth.max()) if np.isfinite(orth).all() else math.inf
    bg = out["maps"][0]
    if len(bg["pos"]) == 0 or not np.isfinite(bg["pos"]).all():
        n.update(map_med_mm=math.inf, map_p90_mm=math.inf, map_far_share=math.inf,
                 normal_med_deg=math.inf)
    else:
        W = stream.origin
        d, a = truth.surface_distance(truth.transform(W, bg["pos"]), truth.rotate(W, bg["normal"]),
                                      truth.static_surfaces(stream.scene))
        n["map_med_mm"] = float(np.median(d)) * 1e3
        n["map_p90_mm"] = float(np.percentile(d, 90)) * 1e3
        n["map_far_share"] = float(np.mean(d > FAR_M))
        n["normal_med_deg"] = float(np.degrees(np.median(a)))
    if len(out["maps"]) > 1:
        n.update(_object_numbers(out, stream))
        ticks = sorted(out["masks"])
        if ticks:
            wrong = sum(int(((out["masks"][t] > 0) != (stream.ids(t - 1) > 0)).sum()) for t in ticks)
            n["label_err"] = wrong / float(sum(out["masks"][t].size for t in ticks))
        else:
            n["label_err"] = math.inf
    return n


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: (value, limit or None)}): correct when every
    limited number was computed, is finite and is within its limit."""
    table = {k: (v, limits.get(k)) for k, v in nums.items() if not k.startswith("_")}
    ok = bool(limits) and all(
        k in nums and math.isfinite(nums[k]) and nums[k] <= lim for k, lim in limits.items()
    )
    return ok, table


def failed_frames(out: dict, stream, limits: dict, first: int) -> int:
    """Frames from `first` on whose camera error passes a camera limit."""
    dt, dr = camera_errors(out["poses"], stream)
    lt = limits.get("cam_t_err_m", math.inf)
    lr = limits.get("cam_r_err_rad", math.inf)
    return int(((dt[first:] > lt) | (dr[first:] > lr)).sum())


def _tf32(x):
    import torch

    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@contextlib.contextmanager
def tf32():
    """The control's precision: TF32 for every float32 matmul on the card
    (`allow_tf32`), and on any device `torch.matmul` and `torch.bmm` with
    their operands rounded to TF32's 10 mantissa bits (round to nearest),
    accumulated in float32 as TF32 tensor cores do."""
    import torch

    mm, bmm = torch.matmul, torch.bmm
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    torch.matmul = lambda a, b, **kw: mm(_tf32(a), _tf32(b), **kw)
    torch.bmm = lambda a, b, **kw: bmm(_tf32(a), _tf32(b), **kw)
    try:
        yield
    finally:
        torch.matmul, torch.bmm = mm, bmm
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def ate_rmse(est, gt) -> float:
    """Absolute trajectory error RMSE (TUM benchmark metric) of the camera
    track, without alignment: both start at the first frame's pose (a
    copy of the port's `utils/export.ate_rmse` with `align=False`)."""
    p = np.asarray([T[:3, 3] for T in est])
    q = np.asarray([T[:3, 3] for T in gt])
    return float(np.sqrt(np.mean(np.sum((p - q) ** 2, axis=1))))


def best_iou(labels: np.ndarray, ids: np.ndarray) -> list[float]:
    """Per object id of the renderer, the best IoU of any object slot's
    pixels against that object's: reported, not compared."""
    out = []
    for obj in sorted(int(v) for v in np.unique(ids) if v):
        gt = ids == obj
        best = 0.0
        for s in range(1, int(labels.max()) + 1):
            seg = labels == s
            union = float(np.logical_or(seg, gt).sum())
            best = max(best, float(np.logical_and(seg, gt).sum()) / union if union else 0.0)
        out.append(round(best, 4))
    return out
