"""Point/splat rasterization of surfel maps — PyTorch counterpart of
cofusion_tpu/ops/rasterize.py.

  * `predict_indices(_b)` — z-buffered 1x point render: per pixel the index
    of the nearest surfel projecting into it, plus its camera-frame
    attributes (index_map.vert:38-63).
  * `splat_from_imap` / `splat_predict(_b)` — disk splatting over the point
    render: phase 1 is the (2r+1)^2 window sweep (CUDA kernel,
    ops/cuda_splat.py), phase 2 fetches the winning tap's attributes
    (splat.vert:54-88, combo_splat.frag:37-65).

The z-buffer is one deterministic scatter-min over a packed
(quantized z << idx_bits) | idx int32 key (nearer wins, ties to the smaller
index); capacities above 2^19 take the exact two-pass float form.  Both are
order-independent, so reruns on the card are bit-identical.  Out-of-range
scatter targets go to one spare dump bucket that is sliced off.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.models.surfel_model import SurfelStore
from cofusion_tpu_torch.ops import cuda_splat
from cofusion_tpu_torch.ops.lie import invert_rt


class IndexMap(NamedTuple):
    """Per-pixel nearest-surfel render (camera frame of the rendering pose)."""

    index: torch.Tensor       # (H, W) int32, -1 = empty
    vert_conf: torch.Tensor   # (H, W, 4) camera-frame position + confidence
    normal_rad: torch.Tensor  # (H, W, 4) camera-frame normal + radius
    color_time: torch.Tensor  # (H, W, 4) rgb + init_time
    last_time: torch.Tensor   # (H, W) last-update tick of the rendered surfel
    valid: torch.Tensor       # (H, W) bool


class SplatMap(NamedTuple):
    """Predicted view (combinedPredict outputs)."""

    image: torch.Tensor       # (H, W, 3) rgb
    vert_conf: torch.Tensor   # (H, W, 4)
    normal_rad: torch.Tensor  # (H, W, 4)
    time: torch.Tensor        # (H, W) last-update tick
    valid: torch.Tensor       # (H, W) bool


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3,3) rotation of (..., 3) vectors as explicit multiply-adds."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            R[0, 0] * x + R[0, 1] * y + R[0, 2] * z,
            R[1, 0] * x + R[1, 1] * y + R[1, 2] * z,
            R[2, 0] * x + R[2, 1] * y + R[2, 2] * z,
        ],
        dim=-1,
    )


def rotate_planar(R, x, y, z, t=None):
    """Coordinate-wise rotate (+ optional translate) of component arrays.
    R is (3, 3), or (M, 3, 3) against (M, N) components."""
    if R.dim() == 3:
        def c(i, j):
            return R[:, i, j][:, None]
    else:
        def c(i, j):
            return R[i, j]
    ox = c(0, 0) * x + c(0, 1) * y + c(0, 2) * z
    oy = c(1, 0) * x + c(1, 1) * y + c(1, 2) * z
    oz = c(2, 0) * x + c(2, 1) * y + c(2, 2) * z
    if t is not None:
        if R.dim() == 3:
            ox, oy, oz = ox + t[:, 0:1], oy + t[:, 1:2], oz + t[:, 2:3]
        else:
            ox, oy, oz = ox + t[0], oy + t[1], oz + t[2]
    return ox, oy, oz


def _project_store(store: SurfelStore, pose: torch.Tensor, cam: CameraConfig):
    """Camera-frame transform + projection of a whole store (leaves (N,) with
    a (4,4) pose, or (M, N) with (M, 4, 4) poses).
    Returns (lx, ly, lz, lnx, lny, lnz, ui, vi, inb)."""
    t_inv = invert_rt(pose)
    R, t = t_inv[..., :3, :3], t_inv[..., :3, 3]
    lx, ly, lz = rotate_planar(R, store.px, store.py, store.pz, t)
    lnx, lny, lnz = rotate_planar(R, store.nx, store.ny, store.nz)
    zs = torch.where(lz == 0, 1.0, lz)
    u = lx * cam.fx / zs + cam.cx
    v = ly * cam.fy / zs + cam.cy
    ui = torch.floor(u).to(torch.int32)
    vi = torch.floor(v).to(torch.int32)
    inb = (ui >= 0) & (vi >= 0) & (ui < cam.width) & (vi < cam.height)
    return lx, ly, lz, lnx, lny, lnz, ui, vi, inb


def _window_gate(store: SurfelStore, time, time_delta, active_window: bool):
    """The active time window (index_map.vert:48), or with `active_window`
    off its complement: the INACTIVE surfels the loop closure renders."""
    age = time - store.last_time
    return (age <= time_delta) if active_window else (age > time_delta)


def _zkey_bits(capacity: int) -> int:
    """Quantized-depth bits of the packed int32 key (31 - ceil(log2 N))."""
    idx_bits = max(1, (capacity - 1).bit_length())
    return 31 - idx_bits


def _bucket_min(lin, vals, n_buckets: int, init):
    """Per-bucket minimum of `vals` (`init` where none), through a dump
    bucket `n_buckets` that is sliced off (JAX's mode="drop")."""
    buf = torch.full((n_buckets + 1,), init, dtype=vals.dtype, device=vals.device)
    return buf.scatter_reduce(0, lin, vals, reduce="amin", include_self=True)[:n_buckets]


def _min_over(bufs):
    """Elementwise minimum of per-shard buffers, on the first one's device."""
    out = bufs[0]
    for b in bufs[1:]:
        out = torch.minimum(out, sm.to_device(b, out.device))
    return out


def _zbuffer(parts, n_buckets: int, capacity: int, max_depth):
    """Winner surfel index per bucket (`capacity` = no winner).  `parts`
    holds one (lin, ok, z, idx) per shard of the store: `lin` the
    (batch-folded) bucket of each entry, `n_buckets` where ~ok; `idx` its
    global surfel index.  The keys quantise with the bits of the whole
    store's `capacity`, so shards combine by an elementwise minimum of their
    buffers (min is order-free: the sharded winner is the unsharded one);
    the result is on the first part's device."""
    parts = [(lin.reshape(-1).to(torch.int64), ok.reshape(-1), z.reshape(-1), idx.reshape(-1))
             for lin, ok, z, idx in parts]
    idx_bits = max(1, (capacity - 1).bit_length())
    zbits = _zkey_bits(capacity)
    if zbits < 12:
        # exact two-pass form: float z scatter-min, then the smallest index
        # among entries at the winning depth
        zbuf = _min_over([_bucket_min(lin, torch.where(ok, z, float("inf")), n_buckets, float("inf"))
                          for lin, ok, z, _ in parts])
        cands = []
        for lin, ok, z, idx in parts:
            zwin = sm.to_device(zbuf, z.device).index_select(0, torch.clamp(lin, 0, n_buckets - 1))
            cand = torch.where(ok & (z <= zwin), idx, capacity).to(torch.int32)
            cands.append(_bucket_min(lin, cand, n_buckets, capacity))
        return _min_over(cands)
    zscale = float((1 << zbits) - 1)
    init = 2147483647
    keys = []
    for lin, ok, z, idx in parts:
        md = sm.to_device(max_depth, z.device)
        if isinstance(md, torch.Tensor):
            zdiv = torch.clamp(md, min=1e-6)
        else:
            zdiv = torch.full((), max(float(md), 1e-6), device=z.device)
        zq = torch.clamp((z / zdiv) * zscale, 0.0, zscale).to(torch.int32)
        key = torch.where(ok, (zq << idx_bits) | idx.to(torch.int32), init)
        keys.append(_bucket_min(lin, key, n_buckets, init))
    kbuf = _min_over(keys)
    return torch.where(kbuf != init, kbuf & ((1 << idx_bits) - 1), capacity)


def _assemble_imap(gathered, index, has, out_shape) -> IndexMap:
    """The IndexMap from the rendered surfel's 13 gathered attribute
    channels (zeros where nothing rendered).  `index` is the per-model
    surfel index."""
    (glx, gly, glz, gconf, gnx, gny, gnz, grad, gcr, gcg, gcb, git, glt) = (
        c.reshape(out_shape) for c in gathered
    )
    hasx = has.reshape(out_shape)
    hx = hasx[..., None]
    vert_conf = torch.stack([glx, gly, glz, gconf], dim=-1)
    normal_rad = torch.stack([gnx, gny, gnz, grad], dim=-1)
    color_time = torch.stack([gcr, gcg, gcb, git], dim=-1)
    return IndexMap(
        index=torch.where(hasx, index.reshape(out_shape).to(torch.int32), -1),
        vert_conf=torch.where(hx, vert_conf, 0.0),
        normal_rad=torch.where(hx, normal_rad, 0.0),
        color_time=torch.where(hx, color_time, 0.0),
        last_time=torch.where(hasx, glt, 0.0),
        valid=hasx,
    )


def predict_indices(
    store,
    pose: torch.Tensor,
    cam: CameraConfig,
    time,
    time_delta,
    max_depth,
    conf_threshold=None,
    active_window: bool = True,
) -> IndexMap:
    """Z-buffered 1x point render of the surfel map into the camera at `pose`.
    Gates: 0 < z <= max_depth and time - last_time <= time_delta
    (index_map.vert:45-50; > time_delta with `active_window` off);
    `conf_threshold` adds splat.vert:58's gate.  `time` is the tick, a
    Python number or a 0-d tensor.

    A sharded store renders shard by shard on the shards' devices, each
    keying its surfels by global row; the key buffers combine by minimum
    and each attribute comes from the shard that owns the winner, so the
    map (on the count's device) is the unsharded one bit for bit."""
    H, W = cam.height, cam.width
    n = store.capacity
    shards, offsets = sm.shards_of(store)
    parts, cols = [], []
    for sh, off in zip(shards, offsets):
        dk = sh.px.device
        lx, ly, lz, lnx, lny, lnz, ui, vi, inb = _project_store(sh, sm.to_device(pose, dk), cam)
        ok = sh.valid & (lz > 0) & (lz <= sm.to_device(max_depth, dk)) & inb
        ok = ok & _window_gate(sh, sm.to_device(time, dk), time_delta, active_window)
        if conf_threshold is not None:
            ok = ok & (sh.conf >= sm.to_device(conf_threshold, dk))
        lin = torch.where(ok, vi * W + ui, H * W)
        idx = torch.arange(off, off + sh.capacity, dtype=torch.int32, device=dk)
        parts.append((lin, ok, lz, idx))
        cols.append((lx, ly, lz, sh.conf, lnx, lny, lnz, sh.radius,
                     sh.cr, sh.cg, sh.cb, sh.init_time, sh.last_time))
    ibuf = _zbuffer(parts, H * W, n, max_depth)
    has = ibuf < n
    i0 = torch.where(has, ibuf, 0).to(torch.int64)
    return _assemble_imap(sm.gather_rows(cols, offsets, i0), i0, has, (H, W))


def predict_indices_b(
    store: SurfelStore,
    poses: torch.Tensor,
    cam: CameraConfig,
    time,
    time_delta,
    max_depth: torch.Tensor,
    conf_threshold: torch.Tensor | None = None,
    active_window: bool = True,
) -> IndexMap:
    """Batched `predict_indices` over the model axis (store leaves (M, N),
    poses (M, 4, 4), max_depth/conf_threshold (M,)): the model index folds
    into one flat bucket index, so the z-buffer stays one scatter-min.
    A plain store only: its one caller renders the first frame's map, and
    a state is sharded after its first frame."""
    M, N = store.px.shape
    H, W = cam.height, cam.width
    lx, ly, lz, lnx, lny, lnz, ui, vi, inb = _project_store(store, poses, cam)
    ok = store.valid & (lz > 0) & (lz <= max_depth[:, None]) & inb
    ok = ok & _window_gate(store, time, time_delta, active_window)
    if conf_threshold is not None:
        ok = ok & (store.conf >= conf_threshold[:, None])
    m_iota = torch.arange(M, dtype=torch.int32, device=lz.device)[:, None]
    lin = torch.where(ok, m_iota * (H * W) + vi * W + ui, M * H * W)
    idx = torch.arange(N, dtype=torch.int32, device=lz.device).expand(M, N)
    # per-model max_depth in the quantizer: the max keeps keys comparable
    ibuf = _zbuffer([(lin, ok, lz, idx)], M * H * W, N, torch.max(max_depth)).reshape(M, H * W)
    has = ibuf < N
    i0 = torch.where(has, ibuf, 0).to(torch.int64)
    gi = (torch.arange(M, device=lz.device)[:, None] * N + i0).reshape(-1)
    cols = (lx, ly, lz, store.conf, lnx, lny, lnz, store.radius,
            store.cr, store.cg, store.cb, store.init_time, store.last_time)
    return _assemble_imap([c.reshape(-1).index_select(0, gi) for c in cols], i0, has, (M, H, W))


def splat_from_imap(
    imap: IndexMap, cam: CameraConfig, cfg: CoFusionConfig, conf_threshold=None
) -> SplatMap:
    """The windowed splatting pass over a point render: per pixel, intersect
    the view ray with each candidate disk of the (2r+1)^2 neighbourhood
    (combo_splat.frag:37-49) and keep the nearest hit, then fetch the
    winner's attributes.  Accepts single (H, W, ...) or batched
    (M, H, W, ...) index maps.  `conf_threshold` (scalar or (B,)) gates the
    candidates at the window level (splat.vert:58)."""
    H, W = cam.height, cam.width
    batched = imap.last_time.dim() == 3

    def b3(a):
        return a if batched else a[None]

    vert_conf = b3(imap.vert_conf)
    normal_rad = b3(imap.normal_rad)
    color_time = b3(imap.color_time)
    last_time = b3(imap.last_time)
    B = last_time.shape[0]
    dev = last_time.device

    r = cfg.splat_radius
    cand_valid = b3(imap.valid)
    if conf_threshold is not None:
        thr = conf_threshold
        if isinstance(thr, torch.Tensor) and thr.dim() == 1:
            thr = thr.reshape(B, 1, 1)
        cand_valid = cand_valid & (vert_conf[..., 3] >= thr)

    # the index map's views go to the kernel as they are (one launch)
    best_z, best_tap = cuda_splat.splat_window(
        vert_conf[..., :3], normal_rad[..., :3], normal_rad[..., 3],
        cand_valid, r, (cam.fx, cam.fy, cam.cx, cam.cy),
    )

    valid = best_tap >= 0
    side = 2 * r + 1
    tap = torch.clamp(best_tap, min=0).to(torch.int64)
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    sy = torch.clamp(yy + torch.div(tap, side, rounding_mode="floor") - r, 0, H - 1)
    sx = torch.clamp(xx + tap % side - r, 0, W - 1)
    bofs = torch.arange(B, device=dev)[:, None, None] * (H * W)
    src = (bofs + sy * W + sx).reshape(-1)

    chans = (vert_conf[..., 3], normal_rad[..., 0], normal_rad[..., 1],
             normal_rad[..., 2], normal_rad[..., 3], color_time[..., 0],
             color_time[..., 1], color_time[..., 2], last_time)
    conf, nx_, ny_, nz_, rad, c0, c1, c2, ltime = (
        torch.where(valid, c.reshape(-1).index_select(0, src).reshape(B, H, W), 0.0)
        for c in chans
    )
    col = torch.stack([c0, c1, c2], dim=-1)

    # the vertex is rebuilt from the corrected depth along the pixel ray
    # (combo_splat.frag:53-55)
    z = torch.where(valid, best_z, 0.0)
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    v = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    vx = (u - cam.cx) * z / cam.fx
    vy = (v - cam.cy) * z / cam.fy
    out = SplatMap(
        image=col,
        vert_conf=torch.stack([vx, vy, z, conf], dim=-1),
        normal_rad=torch.stack([nx_, ny_, nz_, rad], dim=-1),
        time=ltime,
        valid=valid,
    )
    if not batched:
        out = SplatMap(*(a[0] for a in out))
    return out


def splat_predict(
    store: SurfelStore, pose: torch.Tensor, cam: CameraConfig, cfg: CoFusionConfig,
    time, time_delta, max_depth, conf_threshold, active_window: bool = True,
) -> SplatMap:
    """Surfel-disk splatting via windowed gather over the point render."""
    imap = predict_indices(
        store, pose, cam, time, time_delta, max_depth, conf_threshold=conf_threshold,
        active_window=active_window,
    )
    return splat_from_imap(imap, cam, cfg)


def splat_predict_b(
    store: SurfelStore, poses: torch.Tensor, cam: CameraConfig, cfg: CoFusionConfig,
    time, time_delta, max_depth: torch.Tensor, conf_threshold: torch.Tensor,
    active_window: bool = True,
) -> SplatMap:
    """Batched `splat_predict` (flat-index batched point render + batch-aware
    window splatting)."""
    imap = predict_indices_b(
        store, poses, cam, time, time_delta, max_depth, conf_threshold=conf_threshold,
        active_window=active_window,
    )
    return splat_from_imap(imap, cam, cfg)


def splat_merge(a: SplatMap, b: SplatMap) -> SplatMap:
    """Z-merge two predictions, the nearest valid hit winning (`a` on ties):
    the per-tier renders of the two-tier map as one predicted view."""
    za = torch.where(a.valid, a.vert_conf[..., 2], float("inf"))
    zb = torch.where(b.valid, b.vert_conf[..., 2], float("inf"))
    pick_a = za <= zb

    def sel(x, y):
        return torch.where(pick_a.reshape(pick_a.shape + (1,) * (x.dim() - pick_a.dim())), x, y)

    return SplatMap(
        image=sel(a.image, b.image),
        vert_conf=sel(a.vert_conf, b.vert_conf),
        normal_rad=sel(a.normal_rad, b.normal_rad),
        time=sel(a.time, b.time),
        valid=a.valid | b.valid,
    )
