"""Surfel fusion and map maintenance — PyTorch counterpart of
cofusion_tpu/ops/fusion.py (data-association pass data.vert:78-211, update
pass update.vert:38-111, clean pass copy_unstable.vert:53-336, first-frame
initialisation Model.cpp:227-272).

Determinism: the update pass is the reference's scatter-free reverse-window
accumulation (25 masked shifts of one packed contribution image, summed in a
fixed tap order), never a float `index_add_` whose CUDA atomics would add in
a different order on every run; new surfels are appended contiguously after
a stable argsort.  Device-valued offsets (the append cursor) become index
arithmetic (`count + arange`), never a host read.

The tick (`time`) is a Python number or a 0-d float32 tensor on the
frame's device (the engine's fuse/clean pass hands it the latter, so a
captured pass reads it from memory); an integer tick is exact in float32,
so both give the same bits.  The stagger phase `time % 2` picks a strided
sub-grid, so `fuse` takes it as a Python int (`phase`) beside a tensor
tick.

A sharded store (models.surfel_model.ShardedStore) fuses and cleans with
the image-side work done once, on the count's device, and the per-surfel
work shard by shard on the shards' devices: every surfel compares the index
render with its global row, appended rows land in the shard that owns
their global row, and each surfel reads the clean pass's window tables at
its own pixel.  Nothing reduces floats over the surfel axis, so the result
is the unsharded one bit for bit.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.models.surfel_model import SurfelStore
from cofusion_tpu_torch.ops import preprocess as pp
from cofusion_tpu_torch.ops.lie import invert_rt
from cofusion_tpu_torch.ops.preprocess import _shifted
from cofusion_tpu_torch.ops.rasterize import IndexMap, _project_store, _rotate, rotate_planar


class FrameSurfels(NamedTuple):
    """Per-pixel candidate surfels built from the current frame (camera frame)."""

    pos: torch.Tensor     # (H, W, 3) from RAW depth (data.vert:85-87)
    normal: torch.Tensor  # (H, W, 3) from FILTERED depth (data.vert:90,97-99)
    color: torch.Tensor   # (H, W, 3)
    radius: torch.Tensor  # (H, W)
    conf: torch.Tensor    # (H, W) radial-Gaussian confidence x weighting
    valid: torch.Tensor   # (H, W)


class FuseAux(NamedTuple):
    """Where `fuse` appended new surfels, in image space (for overlay_imap)."""

    new_s: torch.Tensor  # stagger-subgrid flat bool: appended at this pixel
    dest: torch.Tensor   # stagger-subgrid flat int64 append row (>= count = dropped)
    count: torch.Tensor  # () post-append count
    phase: int           # stagger phase (time % 2)


def _tick(time):
    """The tick as the passes compare and write it: a 0-d tensor as it is,
    a Python number as a float."""
    return time if isinstance(time, torch.Tensor) else float(time)


def _tick_rows(time, n: int, device) -> torch.Tensor:
    """(n,) float32 rows holding the tick."""
    if isinstance(time, torch.Tensor):
        return time.expand(n)
    return torch.full((n,), float(time), dtype=torch.float32, device=device)


def _get_vertex(depth, cam: CameraConfig):
    H, W = depth.shape
    x = pp._iota(H, W, 1, depth.device)
    y = pp._iota(H, W, 0, depth.device)
    vx = (x - cam.cx) * depth / cam.fx
    vy = (y - cam.cy) * depth / cam.fy
    return torch.stack([vx, vy, depth], dim=-1)


def _central_normal(vmap):
    """Central-difference normal (geometry.glsl getNormal)."""
    del_x = (_shifted(vmap, 0, -1) - _shifted(vmap, 0, 1)) * 0.5
    del_y = (_shifted(vmap, -1, 0) - _shifted(vmap, 1, 0)) * 0.5
    n = pp.cross3(del_x, del_y)
    norm = pp.norm3(n)[..., None]
    ok = norm[..., 0] > 1e-12
    return torch.where(ok[..., None], n / torch.clamp(norm, min=1e-12), 0.0), ok


def _radius(depth, norm_z, cam: CameraConfig):
    """Surfel radius (surfels.glsl getRadius): sqrt(2) z / meanFocal, scaled by
    1/|n_z| capped at 2x."""
    r = depth * math.sqrt(2.0) / cam.mean_focal
    rn = r / torch.clamp(torch.abs(norm_z), min=1e-6)
    return torch.minimum(2.0 * r, rn)


def _confidence(cam: CameraConfig, weighting, device):
    """Radial-Gaussian confidence (surfels.glsl:36-46): exp(-d^2 / (2*0.6^2)),
    d the principal-point distance over the half sensor diagonal (400 px at
    640x480, the reference's hard-coded maxRadDist)."""
    H, W = cam.height, cam.width
    x = pp._iota(H, W, 1, device)
    y = pp._iota(H, W, 0, device)
    max_rad2 = math.sqrt((W * 0.5) ** 2 + (H * 0.5) ** 2) ** 2
    d2 = ((x - cam.cx) ** 2 + (y - cam.cy) ** 2) / max_rad2
    return torch.exp(-d2 / 0.72) * weighting


def make_frame_surfels(
    raw_depth: torch.Tensor,
    filtered_depth: torch.Tensor,
    rgb: torch.Tensor,
    cam: CameraConfig,
    weighting,
    max_depth,
) -> FrameSurfels:
    """Per-pixel surfel candidates (data.vert:84-106): position+colour from raw
    depth, normal+radius from filtered depth."""
    vpos = _get_vertex(raw_depth, cam)
    vpos_f = _get_vertex(filtered_depth, cam)
    normal, n_ok = _central_normal(vpos_f)
    radius = _radius(filtered_depth, normal[..., 2], cam)
    conf = _confidence(cam, weighting, raw_depth.device)
    valid = (raw_depth > 0) & (raw_depth <= max_depth) & n_ok & (filtered_depth > 0)
    return FrameSurfels(
        pos=vpos, normal=normal, color=rgb.to(torch.float32),
        radius=radius, conf=conf, valid=valid,
    )


def _check_neighbours(raw_depth):
    """4-neighbourhood depth-present gate (data.vert checkNeighbours)."""
    ok = raw_depth > 0
    return (
        _shifted(ok, 0, -1, False)
        & _shifted(ok, -1, 0, False)
        & _shifted(ok, 0, 1, False)
        & _shifted(ok, 1, 0, False)
    )


def fuse(
    store,
    frame: FrameSurfels,
    raw_depth: torch.Tensor,
    imap: IndexMap,
    mask_ok: torch.Tensor,
    pose: torch.Tensor,
    cam: CameraConfig,
    cfg: CoFusionConfig,
    time,
    max_depth,
    return_aux: bool = False,
    phase: int | None = None,
):
    """One fuse step: associate each (stagger-decimated) input pixel with a map
    surfel via the index render, merge matched measurements
    (confidence-weighted running average), append unmatched ones.

    CONTRACT (as in the reference): `imap` is `predict_indices(store, pose)`
    of THIS store at THIS pose — a surfel claims a pixel's accumulated
    updates iff the render's index at its own pixel is itself.  `store` may
    be sharded; `imap` is then the combined render.  `phase` is the
    stagger phase `time % 2`, required where `time` is a tensor."""
    H, W = raw_depth.shape
    dev = raw_depth.device
    x = torch.arange(W, device=dev)[None, :]
    y = torch.arange(H, device=dev)[:, None]
    p = time % 2 if phase is None else phase
    stagger = ((x % 2) == p) & ((y % 2) == p)  # data.vert:116
    z = frame.pos[..., 2]
    cand = (
        stagger & mask_ok & _check_neighbours(raw_depth)
        & (z > 0) & (z <= max_depth) & frame.valid
    )

    # --- association: +/-2 px window over the index render (data.vert:124-162)
    xl = pp._iota(H, W, 1, dev)
    yl = pp._iota(H, W, 0, dev)
    xl = (xl - cam.cx) / cam.fx
    yl = (yl - cam.cy) / cam.fy
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)
    ray = torch.stack([xl, yl, torch.ones_like(xl)], dim=-1)
    cos_half = 0.8775825618903728  # cos(0.5 rad), data.vert:150

    cand_pack = torch.cat(
        [imap.vert_conf[..., :3], imap.normal_rad[..., :3],
         imap.valid[..., None].to(torch.float32)],
        dim=-1,
    )  # (H, W, 7)

    best_dist = torch.full((H, W), 1000.0, device=dev)
    best_tap = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    r = cfg.assoc_radius
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            g = _shifted(cand_pack, dy, dx, 0.0)
            c_pos = g[..., 0:3]
            c_nrm = g[..., 3:6]
            c_has = g[..., 6] > 0.5
            zdiff = c_pos[..., 2] - z
            depth_ok = torch.abs(zdiff * lam) < 0.05
            dist = pp.norm3(pp.cross3(ray, c_pos))
            cosang = pp.dot3(c_nrm, frame.normal)
            norm_ok = (torch.abs(c_nrm[..., 2]) < 0.75) | (cosang > cos_half)
            better = c_has & depth_ok & norm_ok & (dist < best_dist)
            best_dist = torch.where(better, dist, best_dist)
            best_tap = torch.where(better, k, best_tap)
            k += 1

    # --- lift measurements to the world frame
    R = pose[:3, :3]
    t = pose[:3, 3]
    wpos = _rotate(R, frame.pos) + t
    wnorm = _rotate(R, frame.normal)

    # --- stagger-phase subsample: `cand` is nonzero only on the 2x2 subgrid
    # (x%2, y%2) == (p, p), so the append path works on that subgrid alone
    halved = (H % 2 == 0) and (W % 2 == 0)

    def sub(img):
        return img[p::2, p::2].reshape(-1) if halved else img.reshape(-1)

    cand_s = sub(cand)
    tap_s = sub(best_tap)
    new_s = cand_s & (tap_s < 0)

    # --- update pass, scatter-free: the point render is injective, so
    # per-surfel sums are per-pixel sums at the winner's pixel.  Reverse the
    # association window in a fixed tap order, then every surfel fetches its
    # sums at its own projected pixel.
    merge_full = cand & (best_tap >= 0)
    a_full = torch.where(merge_full, frame.conf, 0.0)
    contrib = torch.stack(
        [
            a_full,
            a_full * wpos[..., 0], a_full * wpos[..., 1], a_full * wpos[..., 2],
            a_full * frame.radius,
            a_full * frame.color[..., 0], a_full * frame.color[..., 1],
            a_full * frame.color[..., 2],
            a_full * wnorm[..., 0], a_full * wnorm[..., 1], a_full * wnorm[..., 2],
        ],
        dim=-1,
    )  # (H, W, 11): weight, then weighted px,py,pz,radius,cr,cg,cb,nx,ny,nz
    acc_img = torch.zeros((H, W, 11), dtype=torch.float32, device=dev)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            sel = (best_tap == k)[..., None]
            acc_img = acc_img + _shifted(torch.where(sel, contrib, 0.0), -dy, -dx, 0.0)
            k += 1

    # --- new unstable surfels: appended rows are contiguous
    # [count, count+appended).  A stable argsort puts new pixels first in
    # pixel order (sorted row i IS rank i); rows are written at count + i
    # into a P-padded copy, so the offset never runs past the end.
    n = store.capacity
    new_i = new_s.to(torch.int64)
    rank = torch.cumsum(new_i, 0) - 1
    count = store.count.to(torch.int64)
    dest = torch.where(new_s, count + rank, n)
    new_count = torch.clamp(count + new_i.sum(), max=n)

    P = new_s.shape[0]
    order = torch.argsort(torch.where(new_s, 0, 1).to(torch.int32), stable=True)
    w_cols = {
        "px": wpos[..., 0], "py": wpos[..., 1], "pz": wpos[..., 2],
        "nx": wnorm[..., 0], "ny": wnorm[..., 1], "nz": wnorm[..., 2],
        "cr": frame.color[..., 0], "cg": frame.color[..., 1], "cb": frame.color[..., 2],
        "radius": frame.radius, "conf": frame.conf,
    }
    rows = {f: sub(v).index_select(0, order) for f, v in w_cols.items()}
    tf_rows = _tick_rows(time, P, dev)
    rows["init_time"] = tf_rows
    rows["last_time"] = tf_rows
    at = count + torch.arange(P, device=dev)

    # --- per surfel, shard by shard on the shards' devices: the merge, then
    # the append rows that fall in the shard's range (the others land past
    # its end, in the padding)
    acc_flat = acc_img.reshape(H * W, 11)
    index_flat = imap.index.reshape(-1)
    sharded = isinstance(store, sm.ShardedStore)
    shards, offsets = sm.shards_of(store)
    out_shards = []
    for sh, off in zip(shards, offsets):
        n_k, dk = sh.capacity, sh.px.device
        updated = _merge(sh, off, sm.to_device(acc_flat, dk), sm.to_device(index_flat, dk),
                         sm.to_device(pose, dk), cam, sm.to_device(time, dk))
        at_k = sm.to_device(at, dk)
        if sharded:
            at_k = torch.where((at_k >= off) & (at_k < off + n_k), at_k - off,
                               n_k + torch.arange(P, device=dk))

        def put(base, new_rows):
            pad = torch.zeros((P,), dtype=base.dtype, device=dk)
            return torch.cat([base, pad]).index_copy(0, at_k, sm.to_device(new_rows, dk))[:n_k]

        out_shards.append(SurfelStore(
            **{f: put(getattr(updated, f), rows[f]) for f in sm.DATA_FIELDS[:-1]},
            valid=torch.arange(off, off + n_k, device=dk) < sm.to_device(new_count, dk),
            count=None,
        ))
    if sharded:
        out = sm.ShardedStore(tuple(out_shards), new_count.to(torch.int32))
    else:
        out = out_shards[0]._replace(count=new_count.to(torch.int32))
    if return_aux:
        return out, FuseAux(new_s=new_s, dest=dest, count=new_count, phase=p)
    return out


def _merge(store: SurfelStore, off: int, acc_flat, index_flat, pose, cam: CameraConfig, time):
    """The update pass for the surfels of `store`, global rows [off, off +
    capacity): each fetches the window-reversed sums at its own projected
    pixel, with the SAME projection as the index render (surfel s won pixel
    lin_s iff the render's index there is s, compared as integers), and
    merges them confidence-weighted (update.vert:38-111)."""
    H, W = cam.height, cam.width
    _, _, _, _, _, _, uis, vis, _ = _project_store(store, pose, cam)
    lin_s = (torch.clamp(vis, 0, H - 1) * W + torch.clamp(uis, 0, W - 1)).to(torch.int64)
    won = index_flat.index_select(0, lin_s) == torch.arange(
        off, off + store.capacity, dtype=torch.int32, device=lin_s.device
    )
    fetch = acc_flat.index_select(0, lin_s)
    fetch = torch.where(won[:, None], fetch, 0.0)
    sum_a = fetch[:, 0]
    _keys = ("px", "py", "pz", "radius", "cr", "cg", "cb", "nx", "ny", "nz")
    sums = {key: fetch[:, 1 + i] for i, key in enumerate(_keys)}

    hit = sum_a > 0
    a_tot = torch.clamp(sum_a, min=1e-12)
    c_k = store.conf
    denom = torch.clamp(c_k + sum_a, min=1e-12)
    new_rad = sums["radius"] / a_tot
    # radius-growth gate (update.vert:70)
    grow_ok = hit & (new_rad < 1.5 * store.radius)

    def merge_attr(old, key):
        avg = (c_k * old + sums[key]) / denom
        return torch.where(grow_ok, avg, old)

    px_u, py_u, pz_u = (merge_attr(getattr(store, f), f) for f in ("px", "py", "pz"))
    cr_u, cg_u, cb_u = (merge_attr(getattr(store, f), f) for f in ("cr", "cg", "cb"))
    nx_u, ny_u, nz_u = (merge_attr(getattr(store, f), f) for f in ("nx", "ny", "nz"))
    nlen = torch.sqrt(nx_u * nx_u + ny_u * ny_u + nz_u * nz_u)
    n_ok = nlen > 1e-12
    nls = torch.clamp(nlen, min=1e-12)
    nx_u = torch.where(n_ok, nx_u / nls, store.nx)
    ny_u = torch.where(n_ok, ny_u / nls, store.ny)
    nz_u = torch.where(n_ok, nz_u / nls, store.nz)
    rad_u = torch.where(grow_ok, (c_k * store.radius + sums["radius"]) / denom, store.radius)

    tf = _tick(time)
    return store._replace(
        px=px_u, py=py_u, pz=pz_u, nx=nx_u, ny=ny_u, nz=nz_u,
        cr=cr_u, cg=cg_u, cb=cb_u, radius=rad_u,
        conf=torch.where(hit, c_k + sum_a, c_k),
        last_time=torch.where(hit, tf, store.last_time),
    )


_OVERLAY_FIELDS = ("px", "py", "pz", "nx", "ny", "nz", "conf", "radius", "cr", "cg", "cb",
                   "init_time", "last_time")


def overlay_imap(
    fused,
    imap: IndexMap,
    aux: FuseAux,
    frame: FrameSurfels,
    pose: torch.Tensor,
    cam: CameraConfig,
    time,
) -> IndexMap:
    """Index render of the POST-fuse map from the pre-fuse render + the fuse
    result, without a second z-buffer pass: merged surfels keep their pixel
    and take their new attributes; appended surfels are composited at their
    stagger pixels with a z-test against the patched winner (ties keep the
    existing, lower-index surfel)."""
    H, W = cam.height, cam.width
    n = fused.capacity
    dev = imap.index.device

    i0 = torch.where(imap.valid, imap.index, 0).reshape(-1).to(torch.int64)
    # every rendered surfel's fused attributes, from the shard that owns it
    taken = dict(zip(_OVERLAY_FIELDS, sm.take_rows(fused, i0, _OVERLAY_FIELDS)))

    def img(field):
        return taken[field].reshape(H, W)

    px, py, pz = img("px"), img("py"), img("pz")
    nx, ny, nz = img("nx"), img("ny"), img("nz")
    t_inv = invert_rt(pose)
    lx, ly, lz = rotate_planar(t_inv[:3, :3], px, py, pz, t_inv[:3, 3])
    lnx, lny, lnz = rotate_planar(t_inv[:3, :3], nx, ny, nz)
    has = imap.valid

    p = aux.phase
    if aux.new_s.shape[0] == H * W:  # odd dims: fuse used the full grid
        new_img = aux.new_s.reshape(H, W)
        dest_img = aux.dest.reshape(H, W)
    else:
        new_img = torch.zeros((H, W), dtype=torch.bool, device=dev)
        new_img[p::2, p::2] = aux.new_s.reshape(H // 2, W // 2)
        dest_img = torch.full((H, W), n, dtype=aux.dest.dtype, device=dev)
        dest_img[p::2, p::2] = aux.dest.reshape(H // 2, W // 2)
    app = new_img & (dest_img < aux.count)
    app_z = frame.pos[..., 2]
    app_win = app & (~has | (app_z < lz))

    tf = _tick(time)

    def ch(winner, appended):
        return torch.where(app_win, appended, torch.where(has, winner, 0.0))

    vert_conf = torch.stack(
        [ch(lx, frame.pos[..., 0]), ch(ly, frame.pos[..., 1]),
         ch(lz, app_z), ch(img("conf"), frame.conf)],
        dim=-1,
    )
    normal_rad = torch.stack(
        [ch(lnx, frame.normal[..., 0]), ch(lny, frame.normal[..., 1]),
         ch(lnz, frame.normal[..., 2]), ch(img("radius"), frame.radius)],
        dim=-1,
    )
    color_time = torch.stack(
        [ch(img("cr"), frame.color[..., 0]), ch(img("cg"), frame.color[..., 1]),
         ch(img("cb"), frame.color[..., 2]), ch(img("init_time"), tf)],
        dim=-1,
    )
    return IndexMap(
        index=torch.where(app_win, dest_img.to(torch.int32), torch.where(has, imap.index, -1)),
        vert_conf=vert_conf,
        normal_rad=normal_rad,
        color_time=color_time,
        last_time=ch(img("last_time"), tf),
        valid=has | app_win,
    )


def clean_eval(
    store,
    imap: IndexMap,
    depth_input: torch.Tensor,
    pose: torch.Tensor,
    cam: CameraConfig,
    time,
    time_delta,
    conf_threshold,
    outlier_coeff,
    mask: torch.Tensor | None = None,
    mask_id=None,
):
    """Clean/copy pass predicates (copy_unstable.vert:53-150): duplicate
    suppression, unstable-timeout removal, free-space-violation confidence
    decay and, given the frame's model-id `mask`, the mask-mismatch penalty
    of model `mask_id`.  Returns (store with decayed confidences, keep
    mask).  `imap` is the post-fuse index render.  The 3x3 window's image
    tables are built once; a sharded store's shards read them on their own
    devices and return a tuple of per-shard keep masks."""
    H, W = cam.height, cam.width
    # Window taps: shifted image tables gathered at the surfel's own pixel.
    # The reference's dup window is +/-1 px at half-pixel steps
    # (copy_unstable.vert:76-78,87-88) — 9 distinct texels.
    neg_inf, pos_inf = float("-inf"), float("inf")
    imap_has = imap.valid
    q_conf_ok = imap_has & (imap.vert_conf[..., 3] > conf_threshold)
    zq = imap.vert_conf[..., 2]
    z_dup_img = torch.where(q_conf_ok, zq, neg_inf)
    z_zdup_img = torch.where(q_conf_ok & (imap.last_time == time), zq, neg_inf)
    it_img = torch.where(imap_has, imap.color_time[..., 3], pos_inf)
    chans = (
        (z_dup_img, neg_inf), (z_zdup_img, neg_inf), (it_img, pos_inf),
        (imap.vert_conf[..., 0], 0.0), (imap.vert_conf[..., 1], 0.0), (depth_input, 0.0),
    )
    tables = (
        torch.stack([_shifted(c, dy, dx, fill) for c, fill in chans], dim=-1).reshape(H * W, 6)
        for dy in range(-1, 2) for dx in range(-1, 2)
    )
    if not isinstance(store, sm.ShardedStore):
        # one table at a time
        return _clean_surfels(store, tables, pose, cam, time, time_delta, conf_threshold,
                              outlier_coeff, mask, mask_id)
    tables = list(tables)
    outs, keeps = [], []
    for sh in store.shards:
        dk = sh.px.device
        out, keep = _clean_surfels(
            sh, [sm.to_device(t, dk) for t in tables], sm.to_device(pose, dk), cam,
            sm.to_device(time, dk), time_delta, sm.to_device(conf_threshold, dk), outlier_coeff,
            sm.to_device(mask, dk), sm.to_device(mask_id, dk),
        )
        outs.append(out)
        keeps.append(keep)
    return sm.ShardedStore(tuple(outs), store.count), tuple(keeps)


def _clean_surfels(store: SurfelStore, tables, pose, cam: CameraConfig, time, time_delta,
                   conf_threshold, outlier_coeff, mask, mask_id):
    """`clean_eval` for the surfels of `store`: each reads the 9 window
    tables (H*W, 6, in tap order) at its own projected pixel."""
    H, W = cam.height, cam.width
    n = store.capacity
    dev = store.px.device
    t_inv = invert_rt(pose)
    lx, ly, zl = rotate_planar(t_inv[:3, :3], store.px, store.py, store.pz, t_inv[:3, 3])
    _, _, lnz = rotate_planar(t_inv[:3, :3], store.nx, store.ny, store.nz)
    zs = torch.where(zl == 0, 1.0, zl)
    xpix = lx * cam.fx / zs + cam.cx
    ypix = ly * cam.fy / zs + cam.cy
    xi = torch.floor(xpix).to(torch.int32)
    yi = torch.floor(ypix).to(torch.int32)
    inb = (xpix > 0) & (ypix > 0) & (xpix < W) & (ypix < H) & (zl > 0)
    in_window = (time - store.last_time) < time_delta
    search_ok = store.valid & in_window & inb
    lin = (torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)).to(torch.int64)

    count = torch.zeros((n,), dtype=torch.int32, device=dev)
    z_count = torch.zeros((n,), dtype=torch.int32, device=dev)
    violations = torch.zeros((n,), dtype=torch.int32, device=dev)
    viol_sum = torch.zeros((n,), dtype=torch.float32, device=dev)

    steep = torch.abs(lnz) > 0.85
    rad_gate = store.radius * 1.4
    taps = iter(tables)
    for dy in range(-1, 2):
        for dx in range(-1, 2):
            zd, zz, it, qx, qy, d = next(taps).index_select(0, lin).unbind(-1)
            oob = (xi + dx < 0) | (xi + dx >= W) | (yi + dy < 0) | (yi + dy >= H)
            ok_tap = ~oob & search_ok
            # duplicate: older, confident, behind, close, within radius
            dup = (
                ok_tap
                & (it < store.init_time)
                & (zd > zl)
                & (zd - zl < 0.01)
                & ((qx - lx) ** 2 + (qy - ly) ** 2 < rad_gate * rad_gate)
            )
            count = count + dup.to(torch.int32)
            zdup = ok_tap & (zz > zl) & (zz - zl > 0.01) & steep
            z_count = z_count + zdup.to(torch.int32)
            # free-space violation: observed depth beyond the surfel by > 3 cm
            viol = ok_tap & (d - zl > 0.03) & (d > 0)
            violations = violations + viol.to(torch.int32)
            viol_sum = viol_sum + torch.where(viol, d - zl, 0.0)
            if dy == 0 and dx == 0:
                d_centre = d

    # Gates rescaled to the 9 distinct texels visited once each (the
    # reference samples 16 taps: count > 8, zCount > 4)
    keep = ~((count > 4) | (z_count > 2))
    age = time - store.last_time
    drop_unstable = (age > 20) & (store.conf < conf_threshold)  # copy_unstable.vert:134
    keep = keep & ~drop_unstable
    keep = keep | ((store.last_time > 0) & (age > time_delta))  # inactive: immune (:136)
    keep = keep & store.valid

    has_viol = violations > 0
    avg_viol = viol_sum / torch.clamp(violations, min=1).to(torch.float32)
    conf = torch.where(has_viol, store.conf / (1.0 + outlier_coeff * avg_viol), store.conf)
    if mask is not None:
        # a violated surfel whose own pixel belongs to another model, at the
        # observed depth, loses confidence (copy_unstable.vert:143-149)
        m_val = mask.to(torch.float32).reshape(-1).index_select(0, lin)
        mism = (
            has_viol & (m_val != mask_id)
            & (d_centre > zl - 0.05) & (d_centre < zl + 0.05) & search_ok
        )
        conf = torch.where(mism, conf * (0.5 + 0.5 * (1.0 - outlier_coeff / 10.0)), conf)
    return store._replace(conf=conf), keep


def initialise(frame: FrameSurfels, pose: torch.Tensor, capacity: int, time) -> SurfelStore:
    """First-frame map initialisation (Model::initialise, Model.cpp:227-272):
    every valid pixel becomes a surfel."""
    H, W = frame.valid.shape
    dev = frame.valid.device
    R, t = pose[:3, :3], pose[:3, 3]
    wpos = _rotate(R, frame.pos) + t
    wnorm = _rotate(R, frame.normal)
    tf = _tick_rows(time, H * W, dev)
    flat = sm.pack_store(
        pos=wpos.reshape(-1, 3),
        normal=wnorm.reshape(-1, 3),
        color=frame.color.reshape(-1, 3),
        radius=frame.radius.reshape(-1),
        conf=frame.conf.reshape(-1),
        init_time=tf,
        last_time=tf,
        valid=frame.valid.reshape(-1),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )
    return sm.append(sm.empty_store(capacity, dev), flat, frame.valid.reshape(-1))
