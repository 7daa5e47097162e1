"""Motion segmentation and ground-truth mask handling — PyTorch counterpart of
cofusion_tpu/ops/segmentation.py (Core/Segmentation/Segmentation.{h,cpp},
Slic.{h,cpp}, ConnectedLabels.hpp, gSLICr + densecrf).

CRF pipeline (performSegmentationCRF, Segmentation.cpp:124-706): SLIC
superpixels -> superpixel means of rgb/depth/confidence and medians of the
per-model ICP error -> unaries -> dense CRF mean-field (K x K Gaussian
kernels as fp32 matrix products, TF32 off) -> argmax -> connected components
on the superpixel grid -> largest-component / size / border gates ->
per-label depth median and MAD -> upsample.

Determinism on the card: no float sum feeds a gate through an atomic add.
Superpixel sums are the block reductions of `_sp_sums_local` (the only
form the port keeps: the JAX package's scatter fallback for assignments
that are not SLIC's has no caller); the few float scatter-adds left (the
grid's remainder strips, odd superpixel sizes, `gt_mask_stats`) go through
`_segment_sum`, a one-hot matrix product on every device.
Integer counts scatter (integer atomics are exact).  Nothing reads a device
value on the host: counts go into fixed-size buffers (`bincount` would read
the maximum index back).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, SegmentationParams
from cofusion_tpu_torch.ops.preprocess import _shifted


class SegmentationResult(NamedTuple):
    full_segmentation: torch.Tensor  # (H, W) int32 model-slot labels; 255 suppressed
    has_new_label: torch.Tensor      # () bool
    depth_mean: torch.Tensor         # (L,)
    depth_std: torch.Tensor          # (L,)
    superpixel_count: torch.Tensor   # (L,) int32
    bbox: torch.Tensor               # (L, 4) full-res (left, top, right, bottom)
    avg_conf: torch.Tensor           # (L,) mean projected model confidence


def count_ids(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int32 count of each index in [0, n); other indices are dropped."""
    idx = idx.reshape(-1).to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    ones = torch.ones_like(idx, dtype=torch.int32)
    return torch.zeros((n + 1,), dtype=torch.int32, device=idx.device).scatter_add_(0, idx, ones)[:n]


def _segment_sum(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """float32 sum of `vals` per index in [0, n) (others dropped), as a
    one-hot matrix product: a fixed order on every device (no atomics)."""
    idx = idx.reshape(-1).to(torch.int64)
    vals = vals.reshape(-1).to(torch.float32)
    onehot = (idx[:, None] == torch.arange(n, device=idx.device)[None, :]).to(torch.float32)
    return torch.matmul(vals[None, :], onehot)[0]


# ---------------------------------------------------------------------------
# SLIC


def _sh_cells(g: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[cy, cx] = g[cy - dy, cx - dx], zero outside — tiny (GH, GW) grid."""
    return _shifted(g, -dy, -dx, 0.0)


def _sp_sums_local(chans, w, assign, GH: int, GW: int, S: int, stride: int = 2):
    """Per-superpixel weighted sums and count without scatters, by the SLIC
    locality invariant: assign[p] is one of the 3x3 grid cells around p's
    base cell.  Nine masked block reductions plus shifts of the (GH, GW)
    grid; pixels outside the window are dropped (none exist for SLIC
    output).  chans: list of (H, W); w: (H, W) float32 weights.  Returns
    (sums: list of (K,), cnt: (K,)), K = GH*GW.  Where the stride does not
    divide S (an odd superpixel size), the grid has no whole blocks: the
    same sums over the same strided pixels come from `_segment_sum`
    (ROADMAP C4; the JAX package asserts there)."""
    a_s = assign[::stride, ::stride]
    w_s = w[::stride, ::stride]
    ch_s = [c[::stride, ::stride] for c in chans]
    if S % stride:
        K = GH * GW
        return [_segment_sum(a_s, c * w_s, K) for c in ch_s], _segment_sum(a_s, w_s, K)
    T = S // stride
    Hs, Ws = a_s.shape
    Hm, Wm = GH * T, GW * T
    dev = assign.device

    a_m = a_s[:Hm, :Wm]
    ay = torch.div(a_m, GW, rounding_mode="floor")
    ax = a_m % GW
    by = (torch.arange(Hm, device=dev) // T)[:, None]
    bx = (torch.arange(Wm, device=dev) // T)[None, :]
    ry = ay - by + 1
    rx = ax - bx + 1
    inwin = (ry >= 0) & (ry < 3) & (rx >= 0) & (rx < 3)
    tap = torch.where(inwin, ry * 3 + rx, 9)
    w_m = w_s[:Hm, :Wm]

    def block(x):  # (Hm, Wm) -> (GH, GW) tile sums
        return x.reshape(GH, T, GW, T).sum(dim=(1, 3))

    cnt_g = torch.zeros((GH, GW), dtype=torch.float32, device=dev)
    sums_g = [torch.zeros((GH, GW), dtype=torch.float32, device=dev) for _ in chans]
    for k in range(9):
        dy, dx = k // 3 - 1, k % 3 - 1
        wk = torch.where(tap == k, w_m, 0.0)
        cnt_g = cnt_g + _sh_cells(block(wk), dy, dx)
        for i, c in enumerate(ch_s):
            sums_g[i] = sums_g[i] + _sh_cells(block(c[:Hm, :Wm] * wk), dy, dx)

    K = GH * GW
    cnt = cnt_g.reshape(K)
    sums = [s.reshape(K) for s in sums_g]

    # remainder strips (H/W not multiples of S): small fixed-order sums
    if Hs > Hm or Ws > Wm:
        parts = ((slice(Hm, None), slice(None)), (slice(None, Hm), slice(Wm, None)))
        for rows, cols in parts:
            ra = a_s[rows, cols].reshape(-1)
            if ra.shape[0] == 0:
                continue
            rw = w_s[rows, cols].reshape(-1)
            cnt = cnt + _segment_sum(ra, rw, K)
            for i, c in enumerate(ch_s):
                sums[i] = sums[i] + _segment_sum(ra, c[rows, cols].reshape(-1) * rw, K)
    return sums, cnt


def slic_assign(rgb: torch.Tensor, cfg: CoFusionConfig, iterations: int | None = None) -> torch.Tensor:
    """SLIC superpixels: per-pixel cluster index (H, W) int32 in
    [0, (H/S)*(W/S)).  Slic.cpp:32-46: S = superpixel_size, compactness
    0.6, `slic_iterations` rounds, no connectivity enforcement; each pixel
    considers the 3x3 neighbouring grid clusters."""
    S = cfg.superpixel_size
    H, W = rgb.shape[:2]
    GH, GW = H // S, W // S
    iters = iterations if iterations is not None else cfg.slic_iterations
    dev = rgb.device

    x = torch.arange(W, dtype=torch.float32, device=dev).expand(H, W)
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    # integer cell of each pixel (== trunc(x / S), exactly)
    cy_of = torch.clamp(torch.arange(H, device=dev) // S, max=GH - 1)
    cx_of = torch.clamp(torch.arange(W, device=dev) // S, max=GW - 1)
    rgbf = rgb.to(torch.float32)
    feat = [x, y, rgbf[..., 0], rgbf[..., 1], rgbf[..., 2]]
    base_assign = (cy_of[:, None] * GW + cx_of[None, :]).to(torch.int32)

    col_norm = 1.0 / (40.0**2)
    pos_norm = 0.6 / (S * S)
    ones = torch.ones((H, W), dtype=torch.float32, device=dev)

    def up(grid):
        # (GH, GW[, C]) -> (H, W[, C]) nearest upsample by S; edge cells
        # extend over the remainder
        return grid.index_select(0, cy_of).index_select(1, cx_of)

    gy_i = torch.arange(GH, device=dev)[:, None].expand(GH, GW)
    gx_i = torch.arange(GW, device=dev)[None, :].expand(GH, GW)
    assign = base_assign
    for _ in range(iters):
        sums, cnt = _sp_sums_local(feat, ones, assign, GH, GW, S, stride=2)
        centers = torch.stack(sums, dim=-1) / torch.clamp(cnt[:, None], min=1.0)
        cgrid = centers.reshape(GH, GW, 5)
        best_d = torch.full((H, W), float("inf"), device=dev)
        best_k = assign
        for dy in range(-1, 2):
            for dx in range(-1, 2):
                cgy = torch.clamp(gy_i + dy, 0, GH - 1)
                cgx = torch.clamp(gx_i + dx, 0, GW - 1)
                ksh = (cgy * GW + cgx).to(torch.int32)
                c = up(cgrid[cgy, cgx])
                k = up(ksh)
                d_pos = (c[..., 0] - x) ** 2 + (c[..., 1] - y) ** 2
                d_col = (
                    (c[..., 2] - rgbf[..., 0]) ** 2
                    + (c[..., 3] - rgbf[..., 1]) ** 2
                    + (c[..., 4] - rgbf[..., 2]) ** 2
                )
                d = d_col * col_norm + d_pos * pos_norm
                upd = d < best_d
                best_d = torch.where(upd, d, best_d)
                best_k = torch.where(upd, k, best_k)
        assign = best_k
    return assign


def downsample_mean(img, assign, grid, min_threshold=None):
    """Superpixel means (Slic::downsample / downsampleThresholded) over the
    2x2-strided pixels of a SLIC assignment on the grid `grid` = (GH, GW,
    S), by scatter-free block sums.  Returns (means (K,[C]), counts (K,))."""
    chans = [img] if img.dim() == 2 else [img[..., c] for c in range(img.shape[-1])]
    GH, GW, S = grid
    w = torch.ones(assign.shape, dtype=torch.float32, device=assign.device)
    if min_threshold is not None:
        w = (chans[0] > min_threshold).to(torch.float32)
    sums, cnt = _sp_sums_local(chans, w, assign, GH, GW, S, stride=2)
    denom = torch.clamp(cnt, min=1.0)
    if img.dim() == 2:
        return sums[0] / denom, cnt
    return torch.stack(sums, dim=-1) / denom[:, None], cnt


def downsample_mean_b(imgs, assign, grid):
    """Superpixel means of (M, H, W) images -> (M, K): the M images ride one
    block reduction."""
    GH, GW, S = grid
    w = torch.ones(assign.shape, dtype=torch.float32, device=assign.device)
    sums, cnt = _sp_sums_local(list(imgs), w, assign, GH, GW, S, stride=2)
    return torch.stack(sums) / torch.clamp(cnt, min=1.0)[None]


def _lexsort(vals: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Order sorting by `keys`, then by `vals` (jnp.lexsort((vals, keys))):
    a stable sort by value, then a stable sort by key, so equal values keep
    their order."""
    by_val = torch.argsort(vals, stable=True)
    return by_val.index_select(0, torch.argsort(keys.index_select(0, by_val), stable=True))


def downsample_median_b(imgs, assign, K: int) -> torch.Tensor:
    """Per-superpixel MEDIAN of (M, H, W) images -> (M, K) over the
    2x2-strided pixels (the ICP-error channels of the unaries: the median
    ignores the boundary spikes a mean would take)."""
    M = imgs.shape[0]
    a_s = assign[::2, ::2].reshape(-1)
    P = a_s.shape[0]
    cnt = count_ids(a_s, K).to(torch.float32)
    start = torch.cumsum(cnt, 0) - cnt  # first sorted slot of each cell
    pos = torch.clamp((start + torch.floor((cnt - 1.0) / 2.0)).to(torch.int64), 0, P - 1)
    out = []
    for m in range(M):
        vals = imgs[m, ::2, ::2].reshape(-1)
        vsorted = vals.index_select(0, _lexsort(vals, a_s))
        out.append(torch.where(cnt > 0, vsorted.index_select(0, pos), 0.0))
    return torch.stack(out)


def upsample(values: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """Per-superpixel values -> full resolution (Slic::upsample, nearest)."""
    flat = values.index_select(0, assign.reshape(-1).to(torch.int64))
    return flat.reshape(tuple(assign.shape) + tuple(values.shape[1:]))


# ---------------------------------------------------------------------------
# dense CRF


def _sym_normalize(Kmat: torch.Tensor) -> torch.Tensor:
    """NORMALIZE_SYMMETRIC (densecrf fork): K~ = D^-1/2 K D^-1/2."""
    d = torch.sum(Kmat, dim=1)
    dinv = 1.0 / torch.sqrt(torch.clamp(d, min=1e-12))
    return Kmat * dinv[:, None] * dinv[None, :]


def crf_mean_field(unary, feats_smooth, feats_app, w_smooth, w_app, iterations: int):
    """Mean-field with dense Gaussian kernels (Segmentation.cpp:436-471):
    Q0 = softmax(-U); Q_{t+1} = softmax(-U + w_s K~_s Q + w_a K~_a Q), over
    the label axis.  unary (L, K) costs; returns Q (L, K).  fp32 products
    (TF32 is off on the card, device.py)."""

    def gauss_kernel(f):
        sq = torch.sum(f * f, dim=-1)
        g = torch.matmul(f, f.T)
        d2 = sq[:, None] + sq[None, :] - 2.0 * g
        return torch.exp(-0.5 * torch.clamp(d2, min=0.0))

    Ks = _sym_normalize(gauss_kernel(feats_smooth))
    Ka = _sym_normalize(gauss_kernel(feats_app))
    U = torch.clamp(unary, min=1e-5)  # Segmentation.cpp:458-460
    Q = torch.softmax(-U, dim=0)
    for _ in range(iterations):
        msg = w_smooth * torch.matmul(Q, Ks.T) + w_app * torch.matmul(Q, Ka.T)
        Q = torch.softmax(-U + msg, dim=0)
    return Q


# ---------------------------------------------------------------------------
# connected components on the superpixel grid


def connected_components(labels: torch.Tensor, iters: int | None = None) -> torch.Tensor:
    """Min-index label propagation on a (GH, GW) int grid: 4-connected cells
    of equal label share a component id, the smallest linear cell index of
    the component (replaces ConnectedLabels.hpp:50-172's union-find).  A
    fixed GH + GW + 2 rounds (the grid's diameter bound)."""
    GH, GW = labels.shape
    if iters is None:
        iters = GH + GW + 2
    dev = labels.device
    comp = torch.arange(GH * GW, dtype=torch.int32, device=dev).reshape(GH, GW)
    big = GH * GW
    nbr_same = []
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        nbr_same.append((dy, dx, _shifted(labels, dy, dx, -1) == labels))
    for _ in range(iters):
        out = comp
        for dy, dx, same in nbr_same:
            out = torch.minimum(out, torch.where(same, _shifted(comp, dy, dx, big), big))
        comp = out
    return comp


# ---------------------------------------------------------------------------
# full CRF segmentation


def take_at(t: torch.Tensor, i) -> torch.Tensor:
    """t[i] for a host int or a 0-d device index, without a host read."""
    if isinstance(i, torch.Tensor):
        return t.index_select(0, i.reshape(1).to(torch.int64))[0]
    return t[i]


def perform_segmentation_crf(
    rgb: torch.Tensor,          # (H, W, 3)
    depth: torch.Tensor,        # (H, W)
    icp_errors: torch.Tensor,   # (M, H, W) per-model per-pixel ICP error
    confidences: torch.Tensor,  # (M, H, W) projected model confidence
    active: torch.Tensor,       # (M,) bool
    next_slot,                  # () int — slot a new label would occupy
    allow_new,                  # () bool
    cam: CameraConfig,
    cfg: CoFusionConfig,
    params: SegmentationParams,
) -> SegmentationResult:
    """One CRF segmentation (Segmentation::performSegmentationCRF); the label
    set is the model slots, the new label lives in `next_slot`."""
    S = cfg.superpixel_size
    H, W = cam.height, cam.width
    GH, GW = H // S, W // S
    K = GH * GW
    M = icp_errors.shape[0]
    MAX_DEPTH = 100.0
    dev = rgb.device
    slot_ids = torch.arange(M, device=dev)

    assign = slic_assign(rgb, cfg)
    grid = (GH, GW, S)
    low_rgb, _ = downsample_mean(rgb.to(torch.float32), assign, grid)
    low_depth, _ = downsample_mean(depth, assign, grid, min_threshold=0.02)
    low_err = downsample_median_b(icp_errors, assign, K)  # (M, K)
    low_conf = downsample_mean_b(confidences, assign, grid)

    dok = (low_depth > 0) & (low_depth < MAX_DEPTH)
    dmin = torch.amin(torch.where(dok, low_depth, float("inf")))
    dmax = torch.amax(torch.where(dok, low_depth, 0.0))
    depth_range = torch.clamp(dmax - dmin, min=1e-6)

    # --- unaries (Segmentation.cpp:237-298)
    err0 = torch.where(low_conf[0] < 0.3, depth_range * 0.01, low_err[0])
    errs = torch.cat([err0[None], low_err[1:]])
    floor = depth_range * params.unary_k_error
    obj_mask = (slot_ids > 0)[:, None]
    errs = torch.where(obj_mask & (low_conf <= 0.4), floor, errs)
    errs = errs / depth_range

    unary_models = torch.where(active[:, None], params.unary_weight_error * errs, 1e5)
    lowest = torch.amin(torch.where(active[:, None], errs, float("inf")), dim=0)
    new_unary = torch.clamp(params.unary_threshold_new - params.unary_weight_error * lowest, min=0.01)
    new_unary = torch.where(allow_new, new_unary, 1e5)
    onehot_next = (slot_ids == next_slot).to(torch.float32)
    unary = unary_models * (1 - onehot_next[:, None]) + onehot_next[:, None] * new_unary[None, :]

    # --- CRF
    k_idx = torch.arange(K, device=dev)
    gxk = (k_idx % GW).to(torch.float32)
    gyk = (k_idx // GW).to(torch.float32)
    feats_smooth = torch.stack([gxk / 2.0, gyk / 2.0], dim=-1)
    feats_app = torch.cat(
        [
            (gxk * params.scale_pos)[:, None],
            (gyk * params.scale_pos)[:, None],
            low_rgb * params.scale_rgb,
            torch.clamp(low_depth * params.scale_depth, max=100.0)[:, None],
        ],
        dim=-1,
    )
    Q = crf_mean_field(
        unary, feats_smooth, feats_app,
        params.weight_smoothness, params.weight_appearance, params.crf_iterations,
    )
    label = torch.argmax(Q, dim=0).to(torch.int64)  # (K,) slot labels

    # --- connected components + gates
    comp = connected_components(label.reshape(GH, GW)).reshape(-1).to(torch.int64)
    comp_size = count_ids(comp, K).to(torch.int64)  # indexed by root

    # largest component per label
    NBIG = K + 1
    is_root = comp == k_idx
    packed = torch.where(is_root, (K - comp_size) * NBIG + k_idx, NBIG * NBIG)
    per_label_best = torch.full((M,), NBIG * NBIG, dtype=torch.int64, device=dev).scatter_reduce(
        0, label, packed, reduce="amin", include_self=True
    )
    best_root = per_label_best % NBIG
    keep_cell = (label == 0) | (comp == best_root.index_select(0, label))

    # new-label size gates (minRelSizeNew/maxRelSizeNew . lowTotal)
    min_size = params.min_rel_size_new * K
    max_size = params.max_rel_size_new * K
    size_of_cell_comp = comp_size.index_select(0, comp).to(torch.float32)
    is_new = label == next_slot
    size_ok = (size_of_cell_comp >= min_size) & (size_of_cell_comp <= max_size)
    keep_cell = keep_cell & (~is_new | size_ok)
    lab255 = torch.where(keep_cell, label, 255)

    # bounding boxes per label (full-res coords); suppressed cells dropped
    gx_cell = k_idx % GW
    gy_cell = k_idx // GW
    kept_idx = torch.where(keep_cell, label, M)

    def box(init, vals, reduce):
        buf = torch.full((M + 1,), init, dtype=torch.int64, device=dev)
        return buf.scatter_reduce(0, kept_idx, vals, reduce=reduce, include_self=True)[:M]

    left, right = box(GW, gx_cell, "amin"), box(-1, gx_cell, "amax")
    top, bottom = box(GH, gy_cell, "amin"), box(-1, gy_cell, "amax")
    bbox = torch.stack([left * S, top * S, right * S + S, bottom * S + S], dim=-1)

    # border suppression (Segmentation.cpp:549-563)
    B = 20
    l, t, r, b = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    at_border = (
        ((t < B) & (b < B)) | ((l < B) & (r < B))
        | ((t > H - B) & (b > H - B)) | ((l > W - B) & (r > W - B))
    )
    at_border = at_border & (slot_ids != 0)
    suppressed = lab255 == 255
    cell_border = at_border.index_select(0, torch.where(suppressed, 0, lab255)) & ~suppressed
    lab255 = torch.where(cell_border, 255, lab255)

    # --- robust per-label depth stats: histogram median + MAD (the JAX
    # package's estimator; robust to a fresh label's vacated ghost region)
    valid_cell = lab255 != 255
    lab_idx = torch.where(valid_cell, lab255, M)
    sp_count = count_ids(lab_idx, M)
    cnt = sp_count.to(torch.float32)
    NB = 128
    dmax_all = torch.clamp(torch.amax(low_depth), min=1e-3)

    def _label_median(vals):
        bins = torch.clamp((vals / dmax_all * NB).to(torch.int64), 0, NB - 1)
        hist = count_ids(lab_idx * NB + bins, M * NB).to(torch.float32).reshape(M, NB)
        c = torch.cumsum(hist, dim=1)
        medbin = torch.argmax((c >= c[:, -1:] / 2.0).to(torch.int32), dim=1)
        return (medbin.to(torch.float32) + 0.5) * (dmax_all / NB)

    med = _label_median(low_depth)
    devm = torch.abs(low_depth - med.index_select(0, torch.where(valid_cell, lab255, 0)))
    mad = _label_median(devm)
    mean2 = torch.where(cnt > 0, med, 0.0)
    std2 = torch.where(cnt > 0, torch.clamp(mad, min=0.04), 0.0)

    has_new = allow_new & (take_at(sp_count, next_slot) > 0)
    full = upsample(lab255.to(torch.int32), assign)
    return SegmentationResult(
        full_segmentation=full,
        has_new_label=has_new,
        depth_mean=mean2,
        depth_std=std2,
        superpixel_count=sp_count,
        bbox=bbox.to(torch.int32),
        avg_conf=torch.mean(low_conf, dim=1),
    )


# ---------------------------------------------------------------------------
# ground-truth mask path (host-side remapping + device stats)


def gt_mask_stats(mask: torch.Tensor, depth: torch.Tensor, num_slots: int):
    """Per-slot depth mean / mean-abs-deviation and pixel count of a
    slot-id mask (Segmentation.cpp:100-117); ids outside [0, num_slots) are
    ignored."""
    flat = mask.reshape(-1).to(torch.int64)
    d = depth.reshape(-1)
    cnt = count_ids(flat, num_slots).to(torch.float32)
    mean = _segment_sum(flat, d, num_slots) / torch.clamp(cnt, min=1.0)
    dev = torch.abs(mean.index_select(0, torch.clamp(flat, 0, num_slots - 1)) - d)
    std = _segment_sum(flat, dev, num_slots) / torch.clamp(cnt, min=1.0)
    return mean, std, cnt


class GtMaskMapper:
    """Host-side persistent mapping from dataset mask ids to model slots
    (the reference's static `mapping` vector, Segmentation.cpp:64-96)."""

    def __init__(self):
        self.mapping: dict[int, int] = {0: 0}

    def purge_slot(self, slot: int) -> None:
        """Drop every id mapped to a freed slot, so a recycled slot never
        inherits a dead object's ids."""
        self.mapping = {k: v for k, v in self.mapping.items() if v != slot}

    def remap(self, mask_np, free_slots: list[int], allow_new: bool):
        """Returns (slot mask uint8, newly assigned slot | None); ids that
        are unmapped and cannot be assigned stay background."""
        out = np.zeros_like(mask_np, dtype=np.uint8)
        new_slot = None
        free = list(free_slots)
        for vid in np.unique(mask_np):
            if vid == 0:
                continue
            if int(vid) in self.mapping:
                out[mask_np == vid] = self.mapping[int(vid)]
            elif allow_new and new_slot is None and free:
                new_slot = free.pop(0)
                self.mapping[int(vid)] = new_slot
                out[mask_np == vid] = new_slot
        return out, new_slot
