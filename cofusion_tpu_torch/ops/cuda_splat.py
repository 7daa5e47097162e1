"""Window phase of the splat render: hand-written CUDA kernel
(csrc/splat_window.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel `cofusion_tpu/ops/pallas_splat.py`
(`_window_kernel`, launched by `_window_pallas`).  For each pixel's unit view
ray l, sweep the (2r+1)^2 candidate disks of the point render and take
t = (p.n)/(l.n); keep a hit if |l.n| >= 1e-12, |t l - p|^2 <= r^2, z > 0 and
floor(z*4096) is strictly below the best so far (the first tap wins ties).

`splat_window_plain` is the torch form of `rasterize._splat_window_xla`;
`splat_window_cuda` launches the kernel once on the inputs as they are
(strided views included: the kernel computes `pallas_splat`'s packed p.n and
radius^2 itself).  `splat_window` picks by device: the plain version only
for a CPU tensor.

Both take (cand_pos (B,H,W,3), cand_norm (B,H,W,3), cand_rad (B,H,W),
cand_valid (B,H,W) bool, r, (fx, fy, cx, cy)) and return
(best_z (B,H,W) float32, best_tap (B,H,W) int32, -1 on a miss).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F


def view_rays(H: int, W: int, cam_tup, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unit view ray per pixel, ((u-cx)/fx, (v-cy)/fy, 1)/|.|, as (H, W) planes.

    The intrinsics divide as device scalars: CUDA turns a division by a host
    scalar into a multiply by its reciprocal (one ulp off the quotient), and
    the kernel divides exactly — an ulp here can move a hit across a depth
    bucket and change the winning tap."""
    fx, fy, cx, cy = cam_tup

    def scalar(s):
        return torch.full((), s, dtype=torch.float32, device=device)

    u = torch.arange(W, dtype=torch.float32, device=device).expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    lxr = (u - cx) / scalar(fx)
    lyr = (v - cy) / scalar(fy)
    lnorm = torch.sqrt(lxr * lxr + lyr * lyr + 1.0)
    return lxr / lnorm, lyr / lnorm, 1.0 / lnorm


def splat_window_plain(cand_pos, cand_norm, cand_rad, cand_valid, r: int, cam_tup):
    """Plain PyTorch window sweep: one shifted copy of the packed geometry
    image per tap (rasterize._splat_window_xla's math and tap order)."""
    B, H, W = cand_valid.shape
    l0, l1, l2 = view_rays(H, W, cam_tup, cand_pos.device)
    geo = torch.stack(
        [
            cand_pos[..., 0], cand_pos[..., 1], cand_pos[..., 2],
            cand_norm[..., 0], cand_norm[..., 1], cand_norm[..., 2],
            cand_rad, cand_valid.to(torch.float32),
        ],
        dim=1,
    )  # (B, 8, H, W)
    padded = F.pad(geo, (r, r, r, r), value=0.0)

    best_z = torch.full((B, H, W), float("inf"), device=cand_pos.device)
    best_zq = torch.full((B, H, W), float("inf"), device=cand_pos.device)
    best_tap = torch.full((B, H, W), -1, dtype=torch.int32, device=cand_pos.device)
    k = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            g = padded[:, :, r + dy:r + dy + H, r + dx:r + dx + W]
            px, py, pz, nx, ny, nz, crad = (g[:, c] for c in range(7))
            cand_ok = g[:, 7] > 0.5
            ln = l0 * nx + l1 * ny + l2 * nz
            t = (px * nx + py * ny + pz * nz) / torch.where(torch.abs(ln) < 1e-12, 1.0, ln)
            hx = t * l0 - px
            hy = t * l1 - py
            hz = t * l2 - pz
            d2 = hx * hx + hy * hy + hz * hz
            zhit = t * l2
            zq = torch.floor(zhit * 4096.0)
            good = (
                cand_ok
                & (torch.abs(ln) >= 1e-12)
                & (d2 <= crad * crad)
                & (zhit > 0)
                & (zq < best_zq)
            )
            best_zq = torch.where(good, zq, best_zq)
            best_z = torch.where(good, zhit, best_z)
            best_tap = torch.where(good, k, best_tap)
            k += 1
    return best_z, best_tap


def check_window_args(cand_pos, cand_norm, cand_rad, cand_valid, r: int) -> tuple[int, ...]:
    """Validate the kernel's inputs and return their 12 element strides:
    (batch, row, pixel) of cand_pos, cand_norm, cand_rad, cand_valid.

    The kernel reads the index map's views as they are, so any strides are
    taken (`vert_conf[..., :3]` of a (B, H, W, 4) tensor has a pixel stride
    of 4) as long as the three channels of cand_pos and cand_norm lie at
    stride 1.  Raises ValueError on a wrong shape, dtype or device, a
    channel stride other than 1, or a negative radius."""
    B, H, W = cand_valid.shape
    strides = []
    for name, t, shape, dtype in (
        ("cand_pos", cand_pos, (B, H, W, 3), torch.float32),
        ("cand_norm", cand_norm, (B, H, W, 3), torch.float32),
        ("cand_rad", cand_rad, (B, H, W), torch.float32),
        ("cand_valid", cand_valid, (B, H, W), torch.bool),
    ):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != cand_pos.device:
            raise ValueError(
                f"splat_window_cuda: {name} is {t.dtype} {tuple(t.shape)} on {t.device}, "
                f"expected {dtype} {shape} on {cand_pos.device}"
            )
        if t.dim() == 4 and t.stride(3) != 1:
            raise ValueError(f"splat_window_cuda: {name} has channel stride {t.stride(3)}, needs 1")
        strides.extend(t.stride()[:3])
    if r < 0:
        raise ValueError(f"splat_window_cuda: negative radius {r}")
    return tuple(strides)


def splat_window_cuda(cand_pos, cand_norm, cand_rad, cand_valid, r: int, cam_tup):
    """Launch csrc/splat_window.cu on the current stream, once, straight on
    the given views (no packing, no copy).  Inputs must be CUDA tensors as
    `check_window_args` describes."""
    if cand_pos.device.type != "cuda":
        raise ValueError(f"splat_window_cuda needs CUDA tensors, got {cand_pos.device}")
    strides = (ctypes.c_longlong * 12)(
        *check_window_args(cand_pos, cand_norm, cand_rad, cand_valid, r)
    )
    from cofusion_tpu_torch.ops import _build

    lib = _build.load().lib
    B, H, W = cand_valid.shape
    dev = cand_pos.device
    best_z = torch.empty((B, H, W), dtype=torch.float32, device=dev)
    best_tap = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    fx, fy, cx, cy = (float(c) for c in cam_tup)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cofusion_splat_window_f32(
            cand_pos.data_ptr(), cand_norm.data_ptr(), cand_rad.data_ptr(),
            cand_valid.data_ptr(), strides, best_z.data_ptr(), best_tap.data_ptr(),
            B, H, W, int(r), fx, fy, cx, cy, stream,
        )
    _build.check_launch("cofusion_splat_window_f32", err)
    splat_window_cuda.launches += 1
    return best_z, best_tap


splat_window_cuda.launches = 0


def splat_window(cand_pos, cand_norm, cand_rad, cand_valid, r: int, cam_tup):
    """Window sweep: the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    if cand_pos.device.type == "cpu":
        return splat_window_plain(cand_pos, cand_norm, cand_rad, cand_valid, r, cam_tup)
    return splat_window_cuda(cand_pos, cand_norm, cand_rad, cand_valid, r, cam_tup)
