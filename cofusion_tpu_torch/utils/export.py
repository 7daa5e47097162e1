"""Exporters — the port's counterpart of cofusion_tpu/utils/export.py:
TUM-style pose logs and binary PLY point clouds, byte-for-byte the same
formats as the JAX exporter (and the reference's export hooks,
Core/CoFusion.cpp:646-783), so dataset-tools scripts read either, and
`read_ply` reads them back; and the segmentation masks ('-es'), colourised
label images ('-el'), normal maps ('-en') and viewports ('-ev') as 8-bit
PNGs, written by the port's own encoder (`io/png.py`), which encodes as
cv2.imwrite does (libpng's settings there), so for the same arrays the
files equal the JAX exporter's byte for byte.  Numpy plus the port's lie;
no JAX, no OpenCV.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from cofusion_tpu_torch.io.png import write_png
from cofusion_tpu_torch.ops import lie


def _fmt_float(v: float) -> str:
    # default C++ operator<< float formatting (6 significant digits)
    return f"{float(v):.6g}"


def pose_to_tum_line(timestamp, pose: np.ndarray) -> str:
    t = pose[:3, 3]
    R = torch.from_numpy(np.asarray(pose[:3, :3], np.float32).copy())
    q = lie.rotmat_to_quat(R).numpy()
    vals = [t[0], t[1], t[2], q[0], q[1], q[2], q[3]]
    return str(timestamp) + " " + " ".join(_fmt_float(v) for v in vals)


def export_poses(path: str, pose_log: list[tuple[int, np.ndarray]], model: int, export_dir: str) -> str:
    """Write poses-<model>.txt.  `pose_log` entries: (timestamp, (M,4,4) poses).
    `path` is unused (the JAX exporter's signature)."""
    os.makedirs(export_dir, exist_ok=True)
    filename = os.path.join(export_dir, f"poses-{model}.txt")
    with open(filename, "w") as fs:
        for ts, poses in pose_log:
            fs.write(pose_to_tum_line(ts, poses[model]) + "\n")
    return filename


def load_tum_trajectory(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps (T,), poses (T,4,4)) from a TUM
    `ts x y z qx qy qz qw` file (spaces or commas)."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            ts.append(float(parts[0]))
            x, y, z, qx, qy, qz, qw = map(float, parts[1:8])
            T = np.eye(4, dtype=np.float64)
            q = torch.tensor([qx, qy, qz, qw], dtype=torch.float32)
            T[:3, :3] = lie.quat_to_rotmat(q).numpy()
            T[:3, 3] = (x, y, z)
            poses.append(T)
    return np.asarray(ts), np.asarray(poses)


def export_ply(
    path: str,
    surfels: dict,
    conf_threshold: float,
    transform: np.ndarray | None = None,
) -> int:
    """Write a reference-format binary PLY (binary_little_endian; float
    x,y,z; uchar r,g,b; float nx,ny,nz,radius) of the surfels above the
    confidence threshold, normals flipped like the reference
    (CoFusion.cpp:711-713).  Returns the number of points written."""
    conf = surfels["conf"]
    keep = conf > conf_threshold
    pos = surfels["pos"][keep].astype(np.float32)
    col = np.clip(surfels["color"][keep], 0, 255).astype(np.uint8)
    nor = surfels["normal"][keep].astype(np.float32)
    rad = surfels["radius"][keep].astype(np.float32)
    if transform is not None:
        R, t = transform[:3, :3].astype(np.float32), transform[:3, 3].astype(np.float32)
        pos = pos @ R.T + t
        nor = nor @ np.linalg.inv(R).astype(np.float32)
    nor = -nor

    n = pos.shape[0]
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property float radius\n"
        "end_header\n"
    )
    # packed little-endian records, 31 bytes each (struct "<fffBBBffff")
    data = np.empty(n, _PLY_RECORD)
    data["x"], data["y"], data["z"] = pos[:, 0], pos[:, 1], pos[:, 2]
    data["r"], data["g"], data["b"] = col[:, 0], col[:, 1], col[:, 2]
    data["nx"], data["ny"], data["nz"] = nor[:, 0], nor[:, 1], nor[:, 2]
    data["radius"] = rad
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.tobytes())
    return n


_PLY_RECORD = np.dtype(
    [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
     ("r", "u1"), ("g", "u1"), ("b", "u1"),
     ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"), ("radius", "<f4")]
)


def read_ply(path: str) -> dict:
    """Read back a reference-format PLY (`export_ply`'s): pos, color,
    normal, radius."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise IOError(f"{path}: no end_header")
            header += line
        n = int([ln for ln in header.decode().splitlines()
                 if ln.startswith("element vertex")][0].split()[-1])
        data = np.frombuffer(f.read(_PLY_RECORD.itemsize * n), _PLY_RECORD, count=n)
    return {
        "pos": np.stack([data["x"], data["y"], data["z"]], axis=1),
        "color": np.stack([data["r"], data["g"], data["b"]], axis=1),
        "normal": np.stack([data["nx"], data["ny"], data["nz"]], axis=1),
        "radius": data["radius"].copy(),
    }


def ate_rmse(est, gt, align: bool = True) -> float:
    """Absolute trajectory error RMSE (TUM benchmark metric), with optional
    rigid alignment (Horn/Umeyama on the translation tracks)."""
    p = np.asarray([T[:3, 3] for T in est])
    q = np.asarray([T[:3, 3] for T in gt])
    if align and len(p) >= 3:
        mp, mq = p.mean(0), q.mean(0)
        pc, qc = p - mp, q - mq
        U, _, Vt = np.linalg.svd(pc.T @ qc)
        S = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
        R = (U @ S @ Vt).T
        p = (p - mp) @ R.T + mq
    return float(np.sqrt(np.mean(np.sum((p - q) ** 2, axis=1))))


def export_mask_png(path: str, mask: np.ndarray) -> None:
    """'-es' segmentation export (CoFusion.cpp:235-240): model ids as 8-bit
    gray; suppressed 255 labels are zeroed like the reference's
    THRESH_TOZERO_INV at 254."""
    m = mask.astype(np.uint8)
    write_png(path, np.where(m > 254, 0, m).astype(np.uint8))


# per-model label colours (Core/Shaders/color_table.glsl, 31 entries; label
# 0 = dark background, suppressed 255 -> black)
_COLOR_TABLE = np.array(
    [
        (0.1, 0.1, 0.1), (0, 0, 1), (1, 0, 0), (0, 1, 0), (1, 0.10, 0.72),
        (1, 0.82, 0), (0, 0.51, 0.96), (0, 0.55, 0.27), (0.65, 0.37, 0.24),
        (0.31, 0, 0.41), (0, 1, 0.96), (0.24, 0.48, 0.55), (0.93, 0.65, 1),
        (0.82, 1, 0.58), (0.72, 0.31, 1), (0.89, 0.10, 0.34), (0.51, 0.51, 0),
        (0, 1, 0.58), (0.37, 0, 0.17), (0.96, 0.51, 0.06), (0.79, 1, 0),
        (0.17, 0.24, 0), (0, 0.20, 0.75), (1, 0.79, 0.51), (0, 0.17, 0.37),
        (0.62, 0.44, 0.55), (0.31, 0.72, 0.06), (0.62, 0.75, 1),
        (0.58, 0.62, 0.48), (1, 0.48, 0.68), (0.62, 0.03, 0),
    ],
    np.float32,
)


def colorize_labels(mask: np.ndarray) -> np.ndarray:
    """Label ids -> RGB uint8 per color_table.glsl; 255 (suppressed) -> black."""
    ids = mask.astype(np.int64) % len(_COLOR_TABLE)
    rgb = (_COLOR_TABLE[ids] * 255.0).astype(np.uint8)
    return np.where((mask == 255)[..., None], np.uint8(0), rgb)


def export_label_png(path: str, mask: np.ndarray) -> None:
    """'-el' export: the colourised label image (the reference's DRAW_LABEL
    view, GUI/MainController.cpp:394-397, headless)."""
    write_png(path, colorize_labels(mask))


def export_normal_png(path: str, normal: np.ndarray, valid: np.ndarray) -> None:
    """'-en' export: normals as RGB, n * 0.5 + 0.5 (the reference's
    DRAW_NORMALS view, headless); invalid pixels black."""
    img = np.clip((normal * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)
    write_png(path, np.where(valid[..., None], img, np.uint8(0)))


def export_viewport_png(path: str, image: np.ndarray, valid: np.ndarray | None = None) -> None:
    """'-ev' export: the global model's predicted RGB view
    (GUI/MainController.cpp:404-407); invalid pixels black."""
    img = np.clip(image, 0, 255).astype(np.uint8)
    if valid is not None:
        img = np.where(valid[..., None], img, np.uint8(0))
    write_png(path, img)
