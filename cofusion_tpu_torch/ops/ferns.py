"""Randomized-fern keyframe database for relocalisation — PyTorch counterpart
of cofusion_tpu/ops/ferns.py (Core/Ferns.{h,cpp}).

The database is fixed-capacity device tensors; co-occurrence counting is one
(F, N) == (N,) broadcast and sum, so adding and finding a frame run on the
device with no host read.  Where the JAX version skips the O(F^2 N)
eviction scan with `lax.cond` until the database is full, the port computes
it every call and selects its slot with `torch.where`; where JAX writes a
keyframe with `.at[slot].set(mode="drop")`, the port selects the row whose
index equals the slot (no row when the slot is F).

Layout: N random probes (x, y, r/g/b thresholds, depth threshold in mm); a
frame's code per fern packs 4 threshold bits (Ferns.cpp:89-109), 255 where
the probe pixel has no depth.  Keyframes are stored at 1/`factor` (8)
resolution with pose and timestamp.

The probes are drawn with a `torch.Generator` seeded from `seed`, so they
differ from the JAX package's `jax.random` probes for the same seed (ROADMAP
C9); a JAX database carried across by convert.py brings its own probes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cofusion_tpu_torch.config import CameraConfig
from cofusion_tpu_torch.ops.lie import invert_rt


class FernDB(NamedTuple):
    # the conservatory
    probe_xy: torch.Tensor    # (N, 2) int32 (x, y) at fern resolution
    probe_rgbd: torch.Tensor  # (N, 4) float32 thresholds (r, g, b, depth mm)
    # keyframe storage
    codes: torch.Tensor       # (F, N) uint8, 255 = bad probe
    good_codes: torch.Tensor  # (F,) int32
    poses: torch.Tensor       # (F, 4, 4)
    src_time: torch.Tensor    # (F,) int32
    rgb: torch.Tensor         # (F, h, w, 3) float32
    verts: torch.Tensor       # (F, h, w, 3) float32, camera frame
    norms: torch.Tensor       # (F, h, w, 3) float32
    count: torch.Tensor       # () int32


def new_db(
    cam: CameraConfig,
    num_ferns: int = 500,
    capacity: int = 256,
    factor: int = 8,
    max_depth_mm: float = 5000.0,
    seed: int = 0,
    device: str | torch.device = "cpu",
) -> FernDB:
    """The fern conservatory (Ferns::generateFerns) and empty storage.  The
    probes are drawn on the CPU from `seed` and copied to `device`."""
    w, h = cam.width // factor, cam.height // factor
    gen = torch.Generator().manual_seed(seed)
    xs = torch.randint(0, w, (num_ferns, 1), generator=gen)
    ys = torch.randint(0, h, (num_ferns, 1), generator=gen)
    rgb_t = torch.rand((num_ferns, 3), generator=gen, dtype=torch.float64) * 255.0
    d_t = 400.0 + torch.rand((num_ferns, 1), generator=gen, dtype=torch.float64) * (max_depth_mm - 400.0)

    def dev(t):
        return t.to(device, non_blocking=True)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FernDB(
        probe_xy=dev(torch.cat([xs, ys], dim=1).to(torch.int32)),
        probe_rgbd=dev(torch.cat([rgb_t, d_t], dim=1).to(torch.float32)),
        codes=torch.full((capacity, num_ferns), 255, dtype=torch.uint8, device=device),
        good_codes=zeros(capacity, dtype=torch.int32),
        poses=torch.eye(4, device=device).expand(capacity, 4, 4).clone(),
        src_time=torch.full((capacity,), -(10**6), dtype=torch.int32, device=device),
        rgb=zeros(capacity, h, w, 3),
        verts=zeros(capacity, h, w, 3),
        norms=zeros(capacity, h, w, 3),
        count=zeros(dtype=torch.int32),
    )


def _probe_rows(db: FernDB, img: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The (N / stride, C) pixels of an (h, w, C) image at the probes."""
    x, y = db.probe_xy[::stride, 0], db.probe_xy[::stride, 1]
    w = img.shape[1]
    lin = (y * w + x).to(torch.int64)
    return img.reshape(-1, img.shape[-1]).index_select(0, lin)


def encode(db: FernDB, rgb_small: torch.Tensor, verts_small: torch.Tensor):
    """Per-fern 4-bit code of a downsampled frame (Ferns.cpp:89-109).
    Returns (codes (N,) uint8, good (N,) bool).  The depth bit compares the
    millimetres truncated toward zero, as the reference's int casts do."""
    pix = _probe_rows(db, rgb_small)
    z = _probe_rows(db, verts_small)[:, 2]
    good = z > 0
    t = db.probe_rgbd
    code = (
        ((pix[:, 0] > t[:, 0]).to(torch.int32) << 3)
        | ((pix[:, 1] > t[:, 1]).to(torch.int32) << 2)
        | ((pix[:, 2] > t[:, 2]).to(torch.int32) << 1)
        | ((z * 1000.0).to(torch.int32) > t[:, 3].to(torch.int32)).to(torch.int32)
    )
    return torch.where(good, code, 255).to(torch.uint8), good


def _good_count(good: torch.Tensor) -> torch.Tensor:
    return good.sum(dtype=torch.int32)


def _dissimilarity(db: FernDB, codes: torch.Tensor, good_count: torch.Tensor) -> torch.Tensor:
    """(F,) dissimilarity of `codes` to every stored keyframe: co-occurrences
    are equal GOOD codes; dissim = (maxCo - co) / maxCo (Ferns.cpp:110-127),
    inf for empty rows."""
    co = ((db.codes == codes[None, :]) & (codes != 255)[None, :] & (db.codes != 255)).sum(
        dim=1, dtype=torch.int32
    )
    max_co = torch.minimum(good_count, db.good_codes).to(torch.float32)
    dissim = (max_co - co.to(torch.float32)) / torch.clamp(max_co, min=1.0)
    in_db = torch.arange(db.codes.shape[0], device=codes.device) < db.count
    return torch.where(in_db, dissim, float("inf"))


def block_hd(db: FernDB, codes: torch.Tensor, good: torch.Tensor) -> torch.Tensor:
    """Block-Hamming-aware similarity to each keyframe (Ferns::blockHDAware):
    the share of mutually good probes whose codes agree."""
    both_good = (db.codes != 255) & good[None, :]
    eq = (db.codes == codes[None, :]) & both_good
    n_both = torch.clamp(both_good.sum(dim=1, dtype=torch.int32), min=1)
    return eq.sum(dim=1, dtype=torch.int32) / n_both


def _eviction_slot(db: FernDB) -> torch.Tensor:
    """The least unique stored keyframe: the one whose nearest neighbour in
    the database is most similar (first on ties)."""
    F = db.codes.shape[0]
    a, b = db.codes[:, None, :], db.codes[None, :, :]
    co = ((a == b) & (a != 255) & (b != 255)).sum(dim=2, dtype=torch.int32)
    max_co = torch.minimum(db.good_codes[:, None], db.good_codes[None, :]).to(torch.float32)
    pair_dissim = (max_co - co.to(torch.float32)) / torch.clamp(max_co, min=1.0)
    in_db = torch.arange(F, device=co.device) < db.count
    eye = torch.eye(F, dtype=torch.bool, device=co.device)
    pair_ok = in_db[:, None] & in_db[None, :] & ~eye
    nearest = torch.where(pair_ok, pair_dissim, float("inf")).amin(dim=1)
    return torch.argmin(torch.where(in_db, nearest, float("inf"))).to(torch.int32)


def add_frame(
    db: FernDB,
    rgb_small: torch.Tensor,
    verts_small: torch.Tensor,
    norms_small: torch.Tensor,
    pose: torch.Tensor,
    src_time,
    threshold=0.3095,
    allow: torch.Tensor | None = None,
) -> tuple[FernDB, torch.Tensor]:
    """Store the frame as a keyframe if novel enough (Ferns::addFrame).
    Returns (db, added bool).  `allow` (a device bool) vetoes the add, as
    the engine does while tracking is lost.

    Fixed capacity (the reference grows its keyframe vector without bound,
    Ferns.cpp:72-142): when full, a novel frame EVICTS the least unique
    stored keyframe."""
    F = db.codes.shape[0]
    dev = db.codes.device
    codes, good = encode(db, rgb_small, verts_small)
    good_count = _good_count(good)
    dissim = _dissimilarity(db, codes, good_count)
    add = ((dissim.min() > threshold) | (db.count == 0)) & (good_count > 0)
    if allow is not None:
        add = add & allow
    full = db.count >= F
    # the eviction scan runs every call; its slot counts only when full
    slot = torch.where(full, _eviction_slot(db), db.count)
    row = (torch.arange(F, device=dev) == slot) & add  # no row when not adding

    def put(arr, val):
        sel = row.reshape((F,) + (1,) * (arr.dim() - 1))
        return torch.where(sel, val.to(arr.dtype), arr)

    # a fill, not a host-to-device copy of the host tick
    src = torch.full((), src_time, dtype=torch.int32, device=dev)
    return (
        db._replace(
            codes=put(db.codes, codes),
            good_codes=put(db.good_codes, good_count),
            poses=put(db.poses, pose),
            src_time=put(db.src_time, src),
            rgb=put(db.rgb, rgb_small),
            verts=put(db.verts, verts_small),
            norms=put(db.norms, norms_small),
            count=db.count + (add & ~full).to(torch.int32),
        ),
        add,
    )


class FernMatch(NamedTuple):
    found: torch.Tensor       # () bool: passed the co-occurrence and blockHD gates
    keyframe: torch.Tensor    # () int32 best keyframe (-1 if none)
    fern_pose: torch.Tensor   # (4, 4) stored keyframe pose
    fern_rgb: torch.Tensor    # (h, w, 3)
    fern_verts: torch.Tensor  # (h, w, 3)
    fern_norms: torch.Tensor  # (h, w, 3)


def find_frame(
    db: FernDB,
    rgb_small: torch.Tensor,
    verts_small: torch.Tensor,
    time,
    min_age: int = 300,
    block_hd_thresh: float = 0.3,
) -> FernMatch:
    """The best-matching old keyframe (Ferns::findFrame:144-202); the caller
    verifies it with fern-resolution ICP and `photometric_check`.  `argmin`
    takes the first minimum, as jnp.argmin does."""
    codes, good = encode(db, rgb_small, verts_small)
    dissim = _dissimilarity(db, codes, _good_count(good))
    old_enough = (time - db.src_time) > min_age
    dissim = torch.where(old_enough, dissim, float("inf"))
    best = torch.argmin(dissim).reshape(1)

    def take(arr):
        # index_select: indexing with a 0-d device tensor reads it back
        return arr.index_select(0, best)[0]

    found = torch.isfinite(take(dissim)) & (take(block_hd(db, codes, good)) > block_hd_thresh)
    return FernMatch(
        found=found,
        keyframe=torch.where(found, best[0], -1).to(torch.int32),
        fern_pose=take(db.poses),
        fern_rgb=take(db.rgb),
        fern_verts=take(db.verts),
        fern_norms=take(db.norms),
    )


def photometric_check(
    db: FernDB,
    verts_small: torch.Tensor,
    rgb_small: torch.Tensor,
    est_pose: torch.Tensor,
    fern_pose: torch.Tensor,
    fern_rgb: torch.Tensor,
    cam_small: CameraConfig,
    max_depth: float,
) -> torch.Tensor:
    """Mean abs rgb difference at the fern probes reprojected into the
    keyframe (Ferns::photometricCheck, Ferns.cpp:264-307)."""
    h, w = rgb_small.shape[:2]
    v = _probe_rows(db, verts_small)
    ok = (v[:, 2] > 0) & (v[:, 2] < max_depth)
    diff_T = torch.matmul(invert_rt(fern_pose), est_pose)
    vt = v @ diff_T[:3, :3].T + diff_T[:3, 3]
    zs = torch.where(vt[:, 2] == 0, 1.0, vt[:, 2])
    u0 = torch.round(vt[:, 0] * cam_small.fx / zs + cam_small.cx).to(torch.int32)
    v0 = torch.round(vt[:, 1] * cam_small.fy / zs + cam_small.cy).to(torch.int32)
    inb = (u0 >= 0) & (v0 >= 0) & (u0 < w) & (v0 < h)
    lin2 = (torch.clamp(v0, 0, h - 1) * w + torch.clamp(u0, 0, w - 1)).to(torch.int64)
    fern_pix = fern_rgb.reshape(-1, 3).index_select(0, lin2)
    cur_pix = _probe_rows(db, rgb_small)
    use = ok & inb & (fern_pix > 0).any(dim=1)
    diff = (fern_pix - cur_pix).abs().sum(dim=1)
    total = torch.where(use, diff, 0.0).sum()
    return total / torch.clamp(use.sum(dtype=torch.int32), min=1).to(torch.float32)


def sample_constraints(
    db: FernDB,
    verts_small: torch.Tensor,
    curr_pose: torch.Tensor,
    est_pose: torch.Tensor,
    max_depth: float,
    stride: int = 10,
):
    """Surface constraints at every `stride`-th fern probe (Ferns.cpp:240-256):
    each probe's point in the world under the current pose and under the
    recovered one.  Returns (src (K, 3), tgt (K, 3), valid (K,))."""
    v = _probe_rows(db, verts_small, stride)
    ok = (v[:, 2] > 0) & (v[:, 2] < max_depth)
    src = v @ curr_pose[:3, :3].T + curr_pose[:3, 3]
    tgt = v @ est_pose[:3, :3].T + est_pose[:3, 3]
    return src, tgt, ok
