"""Dense RGB-D frame-to-model odometry — PyTorch counterpart of the static-path
subset of cofusion_tpu/ops/odometry.py: joint point-to-plane ICP + direct
photometric alignment, coarse-to-fine over a 3-level pyramid, with SO(3)
rotation pre-alignment (Core/Utils/RGBDOdometry.{h,cpp}, Core/Cuda/reduce.cu).

The whole Gauss-Newton loop stays on the device with no host sync:
  * the JAX `lax.while_loop` early exit becomes a fixed {10,5,4} Python loop
    carrying the per-model `done`/`halt` masks — a halted model holds its
    pose and stats, so the values equal the early-exiting loop's;
  * the 6x6 and 3x3 solves use `torch.linalg.solve_ex(check_errors=False)`
    (`solve` checks its `info` on the host) and add `info == 0` to the
    update gate beside `isfinite`: a singular system need not come back as
    inf/NaN;
  * the normal equations are one batched (7xP)@(Px7) float32 matmul per
    model axis (TF32 off, device.py).

On a CUDA device, handed the engine's graph cache (graphs.py),
`track_models` replays the solve (pre-align and all GN iterations, ~9,500
kernels for one model at 640x480) as one captured CUDA graph, the same
kernels in the same order, bit for bit the eager result; the solve reads
each level's K and K^-1 as inputs.  On the CPU the solve runs eagerly.

Math parity with the reference: ICP rows [n, s x n, n.(s-d)] in the previous
camera frame; RGB rows weighted 1/(sigma+|diff|) with the reference's
sigmaVal quirk (the inlier COUNT is the Huber offset); A = A_rgb + w^2 A_icp,
b = b_rgb + w^2 b_icp (consistent weighting, config.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, TrackingParams
from cofusion_tpu_torch.graphs import StepGraphs
from cofusion_tpu_torch.ops import lie
from cofusion_tpu_torch.ops import preprocess as pp


def _gn_stride(cfg: CoFusionConfig, lvl: int) -> int:
    """Frame-side correspondence decimation per pyramid level."""
    if lvl == 0:
        return cfg.gn_stride_l0
    if lvl == 1:
        return cfg.gn_stride_l1
    return 1


class FramePyramid(NamedTuple):
    """Current-frame tracking inputs; tuples indexed by pyramid level."""

    vmap: tuple       # (H, W, 3) camera-frame vertices
    nmap: tuple       # (H, W, 3)
    valid: tuple      # (H, W) bool — vertex+normal validity
    depth: tuple      # (H, W) metric depth, 0 = invalid (capped at max_depth_rgb)
    intensity: tuple  # (H, W) float32 luma [0, 255]
    didx: tuple       # (H, W) unscaled Scharr d/dx
    didy: tuple
    rgb_ok: tuple     # (H, W) bool — photometric-validity window gate


class ModelPyramid(NamedTuple):
    """Model-prediction tracking inputs per level (leading (M,) axis when
    batched).  `icp_pack` / `rgb_pack` are flat gather tables rebuilt once
    per solve and reused by every GN iteration."""

    vmap_w: tuple     # (H, W, 3) world-frame predicted vertices
    nmap_w: tuple     # (H, W, 3) world-frame predicted normals
    valid: tuple      # (H, W) bool
    depth: tuple      # (H, W) predicted camera-frame depth
    intensity: tuple  # (H, W) predicted luma
    icp_pack: tuple   # (H*W, 8) [vx,vy,vz,nx,ny,nz,valid,0]
    rgb_pack: tuple   # (H*W, 2) [depth, intensity]


class OdometryResult(NamedTuple):
    pose: torch.Tensor       # (M, 4, 4) updated camera/model pose
    A: torch.Tensor          # (M, 6, 6) final combined normal matrix
    b: torch.Tensor          # (M, 6)
    icp_error: torch.Tensor  # (M,)
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    so3_error: torch.Tensor


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(3,3) @ (..., 3) as explicit multiply-adds."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [
            R[0, 0] * x + R[0, 1] * y + R[0, 2] * z,
            R[1, 0] * x + R[1, 1] * y + R[1, 2] * z,
            R[2, 0] * x + R[2, 1] * y + R[2, 2] * z,
        ],
        dim=-1,
    )


def _rotate_bm(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(M, 3, 3) rotations applied to (M, h, w, 3) or shared (h, w, 3) points."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]

    def c(i, j):
        return R[:, i, j][:, None, None]

    return torch.stack(
        [
            c(0, 0) * x + c(0, 1) * y + c(0, 2) * z,
            c(1, 0) * x + c(1, 1) * y + c(1, 2) * z,
            c(2, 0) * x + c(2, 1) * y + c(2, 2) * z,
        ],
        dim=-1,
    )


@functools.lru_cache(maxsize=32)
def _intrinsics(cam_l: CameraConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """K and K^-1 of a pyramid level as device tensors (built once, copied
    non-blocking: a blocking host-to-device copy would sync the stream)."""
    K = torch.tensor(
        [[cam_l.fx, 0.0, cam_l.cx], [0.0, cam_l.fy, cam_l.cy], [0.0, 0.0, 1.0]],
        dtype=torch.float32,
    )
    Kinv = torch.tensor(
        [
            [1.0 / cam_l.fx, 0.0, -cam_l.cx / cam_l.fx],
            [0.0, 1.0 / cam_l.fy, -cam_l.cy / cam_l.fy],
            [0.0, 0.0, 1.0],
        ],
        dtype=torch.float32,
    )
    return K.to(device, non_blocking=True), Kinv.to(device, non_blocking=True)


def _gather2d(img: torch.Tensor, vy: torch.Tensor, vx: torch.Tensor) -> torch.Tensor:
    """img[(vy, vx)] with clipped indices; the caller masks out-of-bounds."""
    H, W = img.shape[:2]
    lin = torch.clamp(vy, 0, H - 1) * W + torch.clamp(vx, 0, W - 1)
    flat = img.reshape((H * W,) + img.shape[2:])
    return flat.index_select(0, lin.reshape(-1).to(torch.int64)).reshape(
        vy.shape + img.shape[2:]
    )


def _reduce_system_b(rows: torch.Tensor, found: torch.Tensor):
    """(M, h, w, 7) rows -> per-model (A (M,6,6), b (M,6), err (M,), count (M,)):
    one batched float32 (7xP)@(Px7) product."""
    rows = torch.where(found[..., None], rows, 0.0)
    flat = rows.reshape(rows.shape[0], -1, rows.shape[-1])
    Mm = torch.bmm(flat.transpose(1, 2), flat)
    count = found.to(torch.float32).sum(dim=(1, 2))
    return Mm[:, :6, :6], Mm[:, :6, 6], Mm[:, 6, 6], count


# ---------------------------------------------------------------------------
# pyramid builders


def _window_ok(ok: torch.Tensor) -> torch.Tensor:
    """All-true over the RGB-residual window [y-2, y+1] x [x-2, x+1]
    (reduce.cu:800-812)."""
    out = ok
    for dy in range(-2, 2):
        for dx in range(-2, 2):
            if dy == 0 and dx == 0:
                continue
            out = out & pp._shifted(ok, dy, dx, False)
    return out


def _border(Hl: int, Wl: int, device) -> torch.Tensor:
    u = torch.arange(Wl, device=device)[None, :]
    v = torch.arange(Hl, device=device)[:, None]
    return (u < Wl - 5) & (v < Hl - 1)


def mask_window_bounds(mask_pyrs):
    """Shared per-level (min, max) of the int mask over the RGB-residual
    window [y-2, y+1] x [x-2, x+1]: `_window_ok(mask == id)` for any id is
    then `(min == id) & (max == id)`, so the 15 window shifts run once per
    level, not once per model.  Out-of-image taps fill with -1, which equals
    no mask id (`_window_ok`'s fill=False)."""
    out = []
    for m in mask_pyrs:
        mn, mx = m, m
        for dy in range(-2, 2):
            for dx in range(-2, 2):
                if dy == 0 and dx == 0:
                    continue
                s = pp._shifted(m, dy, dx, fill=-1)
                mn = torch.minimum(mn, s)
                mx = torch.maximum(mx, s)
        out.append((mn, mx))
    return out


def masked_validity_b(frame, mask_pyrs, mask_bounds, model_ids):
    """Per-model frame gates of masked tracking (engine.py's multi-model
    step): ICP validity &= (mask == model id); the photometric window gate
    &= the window holding only that id.  Returns (valid_b, rgb_ok_b), per
    level (M, Hl, Wl)."""
    ids3 = model_ids[:, None, None]
    valid_b = tuple(
        frame.valid[lv][None] & (mask_pyrs[lv][None] == ids3) for lv in range(len(mask_pyrs))
    )
    rgb_ok_b = tuple(
        frame.rgb_ok[lv][None]
        & (mask_bounds[lv][0][None] == ids3)
        & (mask_bounds[lv][1][None] == ids3)
        for lv in range(len(mask_pyrs))
    )
    return valid_b, rgb_ok_b


def build_frame_pyramid(
    filtered_depth: torch.Tensor,
    intensity: torch.Tensor,
    cam: CameraConfig,
    cfg: CoFusionConfig,
    depth_cutoff,
    max_depth_rgb: float = 6.0,
) -> FramePyramid:
    """Current-frame tracking pyramids, unmasked and shared by every model
    (per-model mask gates are applied on top, `masked_validity_b`)."""
    levels = cfg.pyramid_levels
    depths = [filtered_depth]
    intens = [intensity]
    for _ in range(levels - 1):
        depths.append(pp.pyr_down_gauss(depths[-1]))
        intens.append(pp.pyr_down_gauss(intens[-1]))

    vmaps, nmaps, valids, dxs, dys, rgb_oks, dcap = [], [], [], [], [], [], []
    for lvl in range(levels):
        cam_l = cam.at_level(lvl)
        vm, va = pp.compute_vmap(depths[lvl], cam_l, depth_cutoff)
        nm, na = pp.compute_nmap(vm, va)
        vmaps.append(vm)
        nmaps.append(nm)
        valids.append(va & na)
        dx, dy = pp.sobel_gradients(intens[lvl])
        dxs.append(dx)
        dys.append(dy)
        ok = intens[lvl] > 0
        rgb_oks.append(_window_ok(ok) & _border(cam_l.height, cam_l.width, ok.device))
        dcap.append(torch.where(depths[lvl] < max_depth_rgb, depths[lvl], 0.0))

    return FramePyramid(
        vmap=tuple(vmaps), nmap=tuple(nmaps), valid=tuple(valids),
        depth=tuple(dcap), intensity=tuple(intens), didx=tuple(dxs),
        didy=tuple(dys), rgb_ok=tuple(rgb_oks),
    )


def build_frame_pyramid_from_maps(
    vmap_c: torch.Tensor,
    nmap_c: torch.Tensor,
    valid: torch.Tensor,
    intensity: torch.Tensor,
    cam: CameraConfig,
    cfg: CoFusionConfig,
    max_depth_rgb: float = 6.0,
) -> FramePyramid:
    """FramePyramid from PREDICTED camera-frame maps instead of a depth frame:
    the current side of the model-to-model odometry (the splat-prediction
    initICP variant, RGBDOdometry.cpp:120-141)."""
    levels = cfg.pyramid_levels
    vms = [torch.where(valid[..., None], vmap_c, 0.0)]
    nms = [torch.where(valid[..., None], nmap_c, 0.0)]
    oks = [valid]
    for _ in range(levels - 1):
        vm, ok_v = pp.resize_map_half(vms[-1], oks[-1])
        nm, _ = pp.resize_map_half(nms[-1], oks[-1], normalize=True)
        vms.append(vm)
        nms.append(nm)
        oks.append(ok_v)

    depths = [pp.vertices_to_depth(vmap_c, valid, max_depth_rgb)]
    intens = [intensity]
    for _ in range(levels - 1):
        depths.append(pp.pyr_down_gauss(depths[-1]))
        intens.append(pp.pyr_down_gauss(intens[-1]))

    dxs, dys, rgb_oks = [], [], []
    for lvl in range(levels):
        dx, dy = pp.sobel_gradients(intens[lvl])
        dxs.append(dx)
        dys.append(dy)
        Hl, Wl = intens[lvl].shape
        rgb_oks.append(_window_ok(intens[lvl] > 0) & _border(Hl, Wl, intens[lvl].device))

    return FramePyramid(
        vmap=tuple(vms), nmap=tuple(nms), valid=tuple(oks), depth=tuple(depths),
        intensity=tuple(intens), didx=tuple(dxs), didy=tuple(dys), rgb_ok=tuple(rgb_oks),
    )


def build_model_pyramid(
    pred_vmap: torch.Tensor,
    pred_nmap: torch.Tensor,
    pred_valid: torch.Tensor,
    pred_intensity: torch.Tensor,
    pose: torch.Tensor,
    cam: CameraConfig,
    cfg: CoFusionConfig,
    max_depth_rgb: float = 6.0,
) -> ModelPyramid:
    """Model-prediction pyramids (initICPModel + initRGBModel,
    RGBDOdometry.cpp:143-199) of ONE model: camera-frame prediction ->
    world-frame vertex/normal pyramids + depth / intensity pyramids."""
    levels = cfg.pyramid_levels
    R, t = pose[:3, :3], pose[:3, 3]
    vm_w = _rotate(R, pred_vmap) + t
    nm_w = _rotate(R, pred_nmap)
    vms = [torch.where(pred_valid[..., None], vm_w, 0.0)]
    nms = [nm_w]
    oks = [pred_valid]
    for _ in range(levels - 1):
        vm, ok_v = pp.resize_map_half(vms[-1], oks[-1])
        nm, _ = pp.resize_map_half(nms[-1], oks[-1], normalize=True)
        vms.append(vm)
        nms.append(nm)
        oks.append(ok_v)

    depths = [pp.vertices_to_depth(pred_vmap, pred_valid, max_depth_rgb)]
    intens = [pred_intensity]
    for _ in range(levels - 1):
        depths.append(pp.pyr_down_gauss(depths[-1]))
        intens.append(pp.pyr_down_gauss(intens[-1]))

    icp_packs = [
        torch.cat(
            [vms[lv], nms[lv], oks[lv][..., None].to(torch.float32),
             torch.zeros_like(depths[lv])[..., None]],
            dim=-1,
        ).reshape(-1, 8)
        for lv in range(levels)
    ]
    rgb_packs = [torch.stack([depths[lv], intens[lv]], dim=-1).reshape(-1, 2) for lv in range(levels)]
    return ModelPyramid(
        vmap_w=tuple(vms), nmap_w=tuple(nms), valid=tuple(oks),
        depth=tuple(depths), intensity=tuple(intens),
        icp_pack=tuple(icp_packs), rgb_pack=tuple(rgb_packs),
    )


# ---------------------------------------------------------------------------
# batched-model-axis term builders


def _icp_terms_b(Rcurr, tcurr, Rprev_inv, tprev, vm_c, nm_c, f_ok_b, icp_pack,
                 cam_l, params, stride: int = 1, with_dist: bool = True):
    """Projective data association + point-to-plane rows (reduce.cu:283-394)
    for all M models: poses (M, ...), frame geometry shared (h, w, 3),
    per-model validity f_ok_b (M, h, w), model pack (M, Hl*Wl, 8).
    Returns (A, b, err, count, dist_map): dist_map (M, h, w) is the
    ungated correspondence distance (0 where there is none), the CRF's
    error surface; None with `with_dist=False` (the GN iterations, where
    XLA drops it unused and eager PyTorch would compute it)."""
    H, W = cam_l.height, cam_l.width
    if stride > 1:
        vm_c = vm_c[::stride, ::stride]
        nm_c = nm_c[::stride, ::stride]
        f_ok_b = f_ok_b[:, ::stride, ::stride]
    M = Rcurr.shape[0]
    vcurr_g = _rotate_bm(Rcurr, vm_c) + tcurr[:, None, None, :]
    vcurr_cp = _rotate_bm(Rprev_inv, vcurr_g - tprev[:, None, None, :])
    z = vcurr_cp[..., 2]
    zs = torch.where(z == 0, 1.0, z)
    u = torch.round(vcurr_cp[..., 0] * cam_l.fx / zs + cam_l.cx).to(torch.int32)
    v = torch.round(vcurr_cp[..., 1] * cam_l.fy / zs + cam_l.cy).to(torch.int32)
    inb = (u >= 0) & (v >= 0) & (u < W) & (v < H) & (z > 0)

    # one flat row gather for all models: the model id folds into the row
    lin = torch.clamp(v, 0, H - 1) * W + torch.clamp(u, 0, W - 1)
    lin = lin.to(torch.int64) + (torch.arange(M, device=lin.device) * (H * W))[:, None, None]
    rows_m = icp_pack.reshape(M * H * W, 8).index_select(0, lin.reshape(-1))
    rows_m = rows_m.reshape(lin.shape + (8,))
    vprev_g = rows_m[..., 0:3]
    nprev_g = rows_m[..., 3:6]
    m_ok = rows_m[..., 6] > 0.5

    ncurr_g = _rotate_bm(Rcurr, nm_c)
    dist = pp.norm3(vprev_g - vcurr_g)
    sine = pp.norm3(pp.cross3(ncurr_g, nprev_g))
    found = (
        f_ok_b & inb & m_ok
        & (sine < params.angle_thresh_sin)
        & (dist <= params.dist_thresh)
    )

    s_cp = _rotate_bm(Rprev_inv, vcurr_g - tprev[:, None, None, :])
    d_cp = _rotate_bm(Rprev_inv, vprev_g - tprev[:, None, None, :])
    n_cp = _rotate_bm(Rprev_inv, nprev_g)
    r = pp.dot3(n_cp, s_cp - d_cp)
    rows = torch.cat([n_cp, pp.cross3(s_cp, n_cp), r[..., None]], dim=-1)
    A, b, err, count = _reduce_system_b(rows, found)
    if not with_dist:
        return A, b, err, count, None
    dist_map = torch.where(f_ok_b & inb & m_ok & torch.isfinite(dist), dist, 0.0)
    return A, b, err, count, dist_map


def _rgb_terms_b(resultRt, frame, rgb_ok_b, rgb_pack, lvl, cam_l, intrinsics, params,
                 rgb_only, stride: int = 1):
    """Photometric correspondences + Jacobian rows (reduce.cu:521-604,
    785-865) for all M models: resultRt (M, 4, 4), shared frame images,
    per-model gate rgb_ok_b (M, Hl, Wl), model pack (M, Hl*Wl, 2);
    `intrinsics` the level's (K, K^-1)."""
    H, W = frame.intensity[lvl].shape
    M = resultRt.shape[0]
    dev = resultRt.device
    K, Kinv = intrinsics
    Rt = lie.invert_rt(resultRt)
    krkinv = torch.matmul(torch.matmul(K, Rt[:, :3, :3]), Kinv)
    kt = torch.matmul(K, Rt[:, :3, 3:4])[..., 0]

    s = stride
    Hs, Ws = (H + s - 1) // s, (W + s - 1) // s
    x = pp._iota(Hs, Ws, 1, dev) * s
    y = pp._iota(Hs, Ws, 0, dev) * s
    d1 = frame.depth[lvl][::s, ::s]
    cur_i = frame.intensity[lvl][::s, ::s]
    rgb_ok_s = rgb_ok_b[:, ::s, ::s]

    min_scale = (params.min_grad_mags[lvl] ** 2) / (params.sobel_scale ** 2)
    didx, didy = frame.didx[lvl][::s, ::s], frame.didy[lvl][::s, ::s]
    grad_ok = (didx * didx + didy * didy) >= min_scale

    def kc(i, j):
        return krkinv[:, i, j][:, None, None]

    def ktc(i):
        return kt[:, i][:, None, None]

    td1 = d1 * (kc(2, 0) * x + kc(2, 1) * y + kc(2, 2)) + ktc(2)
    td1_safe = torch.where(td1 == 0, 1.0, td1)
    u0 = torch.round((d1 * (kc(0, 0) * x + kc(0, 1) * y + kc(0, 2)) + ktc(0)) / td1_safe).to(torch.int32)
    v0 = torch.round((d1 * (kc(1, 0) * x + kc(1, 1) * y + kc(1, 2)) + ktc(1)) / td1_safe).to(torch.int32)
    inb = (u0 >= 0) & (v0 >= 0) & (u0 < W) & (v0 < H)

    lin0 = torch.clamp(v0, 0, H - 1) * W + torch.clamp(u0, 0, W - 1)
    lin0 = lin0.to(torch.int64) + (torch.arange(M, device=dev) * (H * W))[:, None, None]
    rows_m = rgb_pack.reshape(M * H * W, 2).index_select(0, lin0.reshape(-1))
    rows_m = rows_m.reshape(lin0.shape + (2,))
    d0 = rows_m[..., 0]
    last_i = rows_m[..., 1]
    found = (
        rgb_ok_s & grad_ok & (d1 > 0) & inb & (d0 > 0)
        & (torch.abs(td1 - d0) <= params.max_depth_delta_rgb)
        & (last_i > 0)
    )
    diff = cur_i - last_i
    sigma = torch.where(found, diff * diff, 0.0).sum(dim=(1, 2))
    count = found.to(torch.float32).sum(dim=(1, 2))
    tmp_error = torch.sqrt(sigma) / torch.clamp(count, min=1.0)
    # sigmaVal quirk (RGBDOdometry.cpp:373-386): the inlier COUNT is the
    # Huber offset, or 1 when the error is zero
    sigma_val = torch.where(tmp_error == 0, 1.0, count)[:, None, None]

    if rgb_only:
        w = torch.ones_like(diff)
    else:
        wden = sigma_val + torch.abs(diff)
        w = torch.where(wden > 1.19209290e-07, 1.0 / wden, 1.0)

    cz = d0
    cx_ = (u0.to(torch.float32) - cam_l.cx) / cam_l.fx * d0
    cy_ = (v0.to(torch.float32) - cam_l.cy) / cam_l.fy * d0
    invz = 1.0 / torch.where(cz == 0, 1.0, cz)
    dIdx_v = w * params.sobel_scale * didx
    dIdy_v = w * params.sobel_scale * didy
    r0 = dIdx_v * cam_l.fx * invz
    r1 = dIdy_v * cam_l.fy * invz
    r2 = -(r0 * cx_ + r1 * cy_) * invz
    r3 = -cz * r1 + cy_ * r2
    r4 = cz * r0 - cx_ * r2
    r5 = -cy_ * r0 + cx_ * r1
    r6 = -w * diff
    rows = torch.stack([r0, r1, r2, r3, r4, r5, r6], dim=-1)
    A, b, _, _ = _reduce_system_b(rows, found)
    return A, b, sigma, count, tmp_error


def _so3_prealign(ref_intensity, cur_intensity, intrinsics, iters: int):
    """Rotation-only image pre-alignment at the coarsest level
    (RGBDOdometry.cpp:239-310, reduce.cu:973-1111); `intrinsics` the
    level's (K, K^-1).  Returns (R (3,3), err)."""
    H, W = ref_intensity.shape
    dev = ref_intensity.device
    K, Kinv = intrinsics
    x = pp._iota(H, W, 1, dev)
    y = pp._iota(H, W, 0, dev)

    def half_grad(img):
        # (back - fore)/2 — the reference's sign (reduce.cu:990-1005)
        gx = (pp._shifted(img, 0, -1) - pp._shifted(img, 0, 1)) * 0.5
        gy = (pp._shifted(img, -1, 0) - pp._shifted(img, 1, 0)) * 0.5
        return gx, gy

    ref_gx, ref_gy = half_grad(ref_intensity)
    nxt_gx_img, nxt_gy_img = half_grad(cur_intensity)
    in_frame = (x >= 1) & (x < W - 1) & (y >= 1) & (y < H - 1)
    px = Kinv[0, 0] * x + Kinv[0, 2]
    py = Kinv[1, 1] * y + Kinv[1, 2]

    eye = torch.eye(3, dtype=torch.float32, device=dev)
    R, last_R = eye, eye
    last_err = torch.full((), 3.4e38 / 2, dtype=torch.float32, device=dev)
    last_count = last_err
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        basis = torch.matmul(torch.matmul(K, R), Kinv)
        krlr = torch.matmul(K, R)

        wz = basis[2, 0] * x + basis[2, 1] * y + basis[2, 2]
        wz = torch.where(wz == 0, 1.0, wz)
        wx = torch.round((basis[0, 0] * x + basis[0, 1] * y + basis[0, 2]) / wz).to(torch.int32)
        wy = torch.round((basis[1, 0] * x + basis[1, 1] * y + basis[1, 2]) / wz).to(torch.int32)
        found = (wx >= 1) & (wx < W - 1) & (wy >= 1) & (wy < H - 1) & in_frame

        gx = (_gather2d(nxt_gx_img, wy, wx) + ref_gx) * 0.5
        gy = (_gather2d(nxt_gy_img, wy, wx) + ref_gy) * 0.5
        a_, b_, c_ = krlr[0, 0], krlr[0, 1], krlr[0, 2]
        d_, e_, f_ = krlr[1, 0], krlr[1, 1], krlr[1, 2]
        g_, h_, i_ = krlr[2, 0], krlr[2, 1], krlr[2, 2]
        lp0 = (d_ * gy + a_ * gx) - (gy * g_ * y) - (gx * g_ * x)
        lp1 = (e_ * gy + b_ * gx) - (gy * h_ * y) - (gx * h_ * x)
        lp2 = (f_ * gy + c_ * gx) - (gy * i_ * y) - (gx * i_ * x)
        # jacobian row = leftProduct x point, point.z == 1
        j0 = lp1 * 1.0 - lp2 * py
        j1 = lp2 * px - lp0 * 1.0
        j2 = lp0 * py - lp1 * px
        resid = -(_gather2d(cur_intensity, wy, wx) - ref_intensity)
        rows = torch.stack([j0, j1, j2, resid], dim=-1)
        rows = torch.where(found[..., None], rows, 0.0).reshape(-1, 4)
        Mm = torch.matmul(rows.T, rows)
        jtj, jtr, err_sq = Mm[:3, :3], Mm[:3, 3], Mm[3, 3]
        count = found.to(torch.float32).sum()

        so3_err = torch.sqrt(err_sq) / torch.clamp(count, min=1.0)
        converged = (so3_err < last_err) & (torch.abs(last_err - count) < 0.001)
        diverging = so3_err > last_err + 0.001

        sol, info = torch.linalg.solve_ex(jtj + 1e-12 * eye, jtr[:, None], check_errors=False)
        delta = sol[:, 0]
        delta = torch.where(torch.isfinite(delta).all() & (info == 0), delta, 0.0)
        R_new = torch.matmul(lie.so3_exp(delta), R)

        stop_now = stopped | converged | diverging
        R_out = torch.where(stopped, R, torch.where(diverging, last_R, torch.where(converged, R, R_new)))
        err_out = torch.where(stopped | diverging, last_err, so3_err)
        count_out = torch.where(stopped | diverging, last_count, count)
        last_R = torch.where(stopped | converged | diverging, last_R, R)
        R, last_err, last_count, stopped = R_out, err_out, count_out, stop_now
    return R, last_err


# ---------------------------------------------------------------------------
# the full tracker


def _empty_stats(M: int, dev) -> dict:
    zM = torch.zeros((M,), dtype=torch.float32, device=dev)
    return dict(
        A=torch.zeros((M, 6, 6), dtype=torch.float32, device=dev),
        b=torch.zeros((M, 6), dtype=torch.float32, device=dev),
        icp_err=zM, icp_cnt=zM, rgb_err=zM, rgb_cnt=zM,
        last_rgb_err=torch.full((M,), 3.4e38, dtype=torch.float32, device=dev),
        stopped=torch.zeros((M,), dtype=torch.bool, device=dev),
    )


def track_models(
    poses: torch.Tensor,
    frame: FramePyramid,
    valid_b: tuple,
    rgb_ok_b: tuple,
    model_b: ModelPyramid,
    so3_ref_intensity: torch.Tensor,
    cam: CameraConfig,
    cfg: CoFusionConfig,
    params: TrackingParams,
    icp_weight: float | None = None,
    graphs: StepGraphs | None = None,
) -> OdometryResult:
    """All M models' full GN solves, batched over the model axis.

    `poses` (M, 4, 4); `frame` the shared FramePyramid; `valid_b` /
    `rgb_ok_b` per-level (M, Hl, Wl) validity; `model_b` a ModelPyramid with
    a leading (M,) axis; `icp_weight` overrides `params.icp_weight`.
    `graphs` (the engine's graph cache) replays the solve as a CUDA graph
    on a CUDA device; without it, and on the CPU, the solve runs eagerly."""
    intrinsics = tuple(_intrinsics(cam.at_level(lv), poses.device)
                       for lv in range(cfg.pyramid_levels))
    inputs = (poses, frame, valid_b, rgb_ok_b, model_b, so3_ref_intensity, intrinsics)
    statics = (cam, cfg, params, params.icp_weight if icp_weight is None else icp_weight)
    if graphs is None:
        return _solve(*inputs, *statics)
    res = graphs.run("tracking", lambda x: _solve(*x, *statics), inputs, statics)
    # the next replay overwrites the cache's outputs; callers keep poses
    return OdometryResult(*(t.clone() for t in res))


def _solve(poses, frame, valid_b, rgb_ok_b, model_b, so3_ref_intensity, intrinsics, cam, cfg,
           params, w):
    """`track_models`' body, eager: what a graph captures.  `intrinsics`:
    each level's (K, K^-1)."""
    M = poses.shape[0]
    dev = poses.device
    use_icp = not params.rgb_only
    use_rgb = params.rgb_only or params.icp_weight < 100

    tprev = poses[:, :3, 3]
    Rprev_inv = poses[:, :3, :3].transpose(1, 2)

    levels = cfg.pyramid_levels
    top = levels - 1
    if cfg.use_so3 and use_rgb:
        R_so3, so3_err = _so3_prealign(
            so3_ref_intensity, frame.intensity[top], intrinsics[top], cfg.so3_iters
        )
    else:
        R_so3 = torch.eye(3, dtype=torch.float32, device=dev)
        so3_err = torch.zeros((), dtype=torch.float32, device=dev)
    resultRt = lie.make_rt(R_so3, torch.zeros(3, dtype=torch.float32, device=dev))
    resultRt = resultRt[None].expand(M, 4, 4)

    if cfg.fast_odom:
        iters = (3, 0, 0)
    else:
        iters = tuple(
            n if (lvl == 0 or cfg.use_pyramid) else 0 for lvl, n in enumerate(cfg.gn_iters)
        )

    st = _empty_stats(M, dev)
    zero66, zero6, zM = st["A"], st["b"], st["icp_err"]
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    for lvl in range(levels - 1, -1, -1):
        cam_l = cam.at_level(lvl)
        stride = _gn_stride(cfg, lvl)
        done = torch.zeros((M,), dtype=torch.bool, device=dev)
        # fixed iteration count; a halted model holds pose and stats, so this
        # equals the reference's early-exiting while_loop value for value
        for _ in range(iters[lvl]):
            currentT = lie.compose(poses, lie.invert_rt(resultRt))
            Rcurr = currentT[:, :3, :3]
            tcurr = currentT[:, :3, 3]

            if use_rgb:
                A_rgb, b_rgb, _, rgb_cnt, rgb_err = _rgb_terms_b(
                    resultRt, frame, rgb_ok_b[lvl], model_b.rgb_pack[lvl],
                    lvl, cam_l, intrinsics[lvl], params, params.rgb_only, stride=stride,
                )
            else:
                A_rgb, b_rgb, rgb_cnt, rgb_err = zero66, zero6, zM, zM

            if use_icp:
                A_icp, b_icp, icp_err_sq, icp_cnt, _ = _icp_terms_b(
                    Rcurr, tcurr, Rprev_inv, tprev, frame.vmap[lvl],
                    frame.nmap[lvl], valid_b[lvl], model_b.icp_pack[lvl],
                    cam_l, params, stride=stride, with_dist=False,
                )
                icp_err = torch.sqrt(icp_err_sq) / torch.clamp(icp_cnt, min=1.0)
            else:
                A_icp, b_icp, icp_err, icp_cnt = zero66, zero6, zM, zM

            if use_icp and use_rgb:
                A = A_rgb + (w * w) * A_icp
                b = b_rgb + (w * w if params.consistent_icp_weighting else w) * b_icp
            elif use_icp:
                A, b = A_icp, b_icp
            else:
                A, b = A_rgb, b_rgb

            stop_now = st["stopped"] | (params.rgb_only & (rgb_err > st["last_rgb_err"]))
            halt = stop_now | done

            sol, info = torch.linalg.solve_ex(A + 1e-12 * eye6, b[..., None], check_errors=False)
            xi = sol[..., 0]
            ok = (
                torch.isfinite(xi).all(dim=-1)
                & (info == 0)
                & ((icp_cnt + rgb_cnt) >= params.min_correspondences)
                & (torch.linalg.vector_norm(xi[:, :3], dim=-1) < params.max_translation_jump)
                & ~halt
            )
            xi = torch.where(ok[:, None], xi, 0.0)
            resultRt_new = lie.compose(lie.se3_exp_rt(xi), resultRt)
            # per-level convergence freeze (gn_converge_eps)
            converged = torch.linalg.vector_norm(xi, dim=-1) < params.gn_converge_eps
            done = done | ~ok | converged

            st = dict(
                A=torch.where(ok[:, None, None], A, st["A"]),
                b=torch.where(ok[:, None], b, st["b"]),
                icp_err=torch.where(halt, st["icp_err"], icp_err),
                icp_cnt=torch.where(halt, st["icp_cnt"], icp_cnt),
                rgb_err=torch.where(halt, st["rgb_err"], rgb_err),
                rgb_cnt=torch.where(halt, st["rgb_cnt"], rgb_cnt),
                last_rgb_err=torch.where(halt, st["last_rgb_err"], rgb_err),
                stopped=stop_now,
            )
            resultRt = torch.where(halt[:, None, None], resultRt, resultRt_new)

    currentT = lie.compose(poses, lie.invert_rt(resultRt))
    if use_rgb:
        jumped = (
            torch.linalg.vector_norm(currentT[:, :3, 3] - tprev, dim=-1)
            > params.max_translation_jump
        )
        currentT = torch.where(jumped[:, None, None], poses, currentT)

    return OdometryResult(
        pose=currentT,
        A=st["A"],
        b=st["b"],
        icp_error=st["icp_err"],
        icp_count=st["icp_cnt"],
        rgb_error=st["rgb_err"],
        rgb_count=st["rgb_cnt"],
        so3_error=so3_err.expand(M),
    )


def get_incremental_transformation(
    pose_prev: torch.Tensor,
    frame: FramePyramid,
    model: ModelPyramid,
    so3_ref_intensity: torch.Tensor,
    cam: CameraConfig,
    cfg: CoFusionConfig,
    params: TrackingParams,
    graphs: StepGraphs | None = None,
) -> OdometryResult:
    """One model's full solve against a whole (unmasked) frame: the JAX
    package's unbatched tracker, as a one-model `track_models` call
    (`graphs` as there).  `pose_prev` (4, 4); returns the OdometryResult
    with its model axis dropped (pose (4, 4), A (6, 6), scalars)."""
    res = track_models(
        pose_prev[None], frame, tuple(v[None] for v in frame.valid),
        tuple(v[None] for v in frame.rgb_ok),
        ModelPyramid(*(tuple(lv[None] for lv in field) for field in model)),
        so3_ref_intensity, cam, cfg, params, graphs=graphs,
    )
    return OdometryResult(*(a[0] for a in res))


def icp_error_maps_b(
    poses_new: torch.Tensor,
    poses_prev: torch.Tensor,
    vmap_c: torch.Tensor,
    nmap_c: torch.Tensor,
    valid_c: torch.Tensor,
    model_b: ModelPyramid,
    cam: CameraConfig,
    params: TrackingParams,
    stride: int = 1,
) -> torch.Tensor:
    """(M, H, W) per-pixel ICP error at the final poses, NOT mask-gated (the
    CRF's unary input: masked tracking would zero a model's error exactly
    where the other models' pixels are).  With `stride` the error is taken
    on a strided subset and nearest-filled back to full resolution."""
    M = poses_new.shape[0]
    f_ok_b = valid_c[None].expand((M,) + tuple(valid_c.shape))
    *_, dist_map = _icp_terms_b(
        poses_new[:, :3, :3], poses_new[:, :3, 3],
        poses_prev[:, :3, :3].transpose(1, 2), poses_prev[:, :3, 3],
        vmap_c, nmap_c, f_ok_b, model_b.icp_pack[0],
        cam.at_level(0), params, stride=stride,
    )
    if stride > 1:
        # nearest fill by a broadcast (repeat_interleave would size its
        # output on the host)
        H, W = vmap_c.shape[:2]
        _, Hs, Ws = dist_map.shape
        dist_map = dist_map[:, :, None, :, None].expand(M, Hs, stride, Ws, stride)
        dist_map = dist_map.reshape(M, Hs * stride, Ws * stride)[:, :H, :W]
    return dist_map
