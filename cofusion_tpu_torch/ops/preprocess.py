"""Frame preprocessing — PyTorch counterpart of cofusion_tpu/ops/preprocess.py:
bilateral depth filter (CUDA kernel, ops/cuda_stencil.py), intensity
conversion, Gaussian pyramids, vertex/normal maps, Sobel gradients.

Images are (H, W[, C]) float32 as in the reference; invalid pixels are
explicit bool masks plus zeroed values.  Window ops are statically unrolled
shifted copies, with the reference's tap order, so float sums round alike.
Small vector sums (norms, dot products over 3 components) are written out
left to right for the same reason.
"""

from __future__ import annotations

import torch

from cofusion_tpu_torch.config import CameraConfig
from cofusion_tpu_torch.ops import cuda_stencil


def _shifted(x: torch.Tensor, dy: int, dx: int, fill=0.0) -> torch.Tensor:
    """x shifted so that out[y, x] = x[y + dy, x + dx], padded with `fill`."""
    H, W = x.shape[:2]
    out = torch.full_like(x, fill)
    y0, y1 = max(0, -dy), H - max(0, dy)
    x0, x1 = max(0, -dx), W - max(0, dx)
    if y0 < y1 and x0 < x1:
        out[y0:y1, x0:x1] = x[y0 + dy:y1 + dy, x0 + dx:x1 + dx]
    return out


def _iota(H: int, W: int, dim: int, device, dtype=torch.float32) -> torch.Tensor:
    """(H, W) grid of the column (dim=1) or row (dim=0) index."""
    if dim == 1:
        return torch.arange(W, dtype=dtype, device=device).expand(H, W)
    return torch.arange(H, dtype=dtype, device=device)[:, None].expand(H, W)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over a last axis of 3, summed left to right."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2])


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _fma(x: torch.Tensor, c: float, z: torch.Tensor) -> torch.Tensor:
    """float32 x * c + z rounded once, as a fused multiply-add: the float64
    product of two float32 numbers is exact, so the float64 sum rounds to
    the same float32 on every device.  `x` is promoted inside the add."""
    return torch.add(z.to(torch.float64), x, alpha=c).to(torch.float32)


# the float32 constants as Python floats (a bare 0.299 would be the float64 one)
_LUMA = tuple(float(torch.tensor(c, dtype=torch.float32)) for c in (0.299, 0.587, 0.114))
_SCHARR = tuple(float(torch.tensor(c, dtype=torch.float32)) for c in (0.52201, 0.79451))


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """RGB (H, W, 3) -> luma, float32 in [0, 255], floor-rounded (the
    reference's integer cast, cudafuncs.cu:636-638).

    The floor turns one ulp into a whole grey level, so the sum rounds as
    the reference's compiled form does: fma(b, .114, fma(r, .299, g * .587))
    (XLA contracts the multiply-adds; nvcc's -fmad does too)."""
    rgb = rgb.to(torch.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    cr, cg, cb = _LUMA
    return torch.floor(_fma(b, cb, _fma(r, cr, g * cg)))


def bilateral_filter(depth: torch.Tensor, max_depth: float) -> torch.Tensor:
    """13x13 metric bilateral depth filter (depth_bilateral_metric.frag:30-76):
    sigma_space^2 = 20.25 px^2, sigma_color^2 = 9e-4 m^2; depth outside
    [0.3, max_depth] maps to 0.

    A CUDA tensor goes through the hand-written kernel; only a CPU tensor
    takes the plain PyTorch version (ops/cuda_stencil.py holds both)."""
    if depth.device.type == "cpu":
        return cuda_stencil.bilateral_filter_plain(depth, max_depth)
    return cuda_stencil.bilateral_filter_cuda(depth, max_depth)


_BINOMIAL5 = (1.0, 4.0, 6.0, 4.0, 1.0)


def pyr_down_gauss(img: torch.Tensor) -> torch.Tensor:
    """Halve resolution with a 5x5 binomial kernel, renormalizing over the
    non-zero samples only (pyrDownGaussF / pyrDownUcharGauss)."""
    validf = (img > 0).to(img.dtype)
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            w = float(_BINOMIAL5[dy + 2] * _BINOMIAL5[dx + 2])
            nbr = _shifted(img, dy, dx, 0.0)
            ok = _shifted(validf, dy, dx, 0.0)
            num = num + nbr * ok * w
            den = den + ok * w
    smoothed = num / torch.clamp(den, min=1e-12)
    return smoothed[::2, ::2]


def pyr_down_nearest(img: torch.Tensor) -> torch.Tensor:
    """Mask / label pyramid: nearest-neighbour decimation."""
    return img[::2, ::2]


def compute_vmap(
    depth: torch.Tensor, cam: CameraConfig, depth_cutoff
) -> tuple[torch.Tensor, torch.Tensor]:
    """Back-project a depth map into a camera-frame vertex map.
    Returns (vmap (H, W, 3), valid (H, W)) — computeVmapKernel, cudafuncs.cu:109-150."""
    H, W = depth.shape
    u = _iota(H, W, 1, depth.device)
    v = _iota(H, W, 0, depth.device)
    valid = (depth > 0) & (depth < depth_cutoff)
    z = torch.where(valid, depth, 0.0)
    vx = z * (u - cam.cx) / cam.fx
    vy = z * (v - cam.cy) / cam.fy
    return torch.stack([vx, vy, z], dim=-1), valid


def compute_nmap(vmap: torch.Tensor, valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Normals from right/down finite differences: n = norm((v01-v00) x (v10-v00))
    (computeNmapKernel, cudafuncs.cu:152-205)."""
    v00 = vmap
    v01 = _shifted(vmap, 0, 1)
    v10 = _shifted(vmap, 1, 0)
    ok = valid & _shifted(valid, 0, 1, False) & _shifted(valid, 1, 0, False)
    n = cross3(v01 - v00, v10 - v00)
    norm = norm3(n)[..., None]
    n = torch.where((norm > 1e-12) & ok[..., None], n / torch.clamp(norm, min=1e-12), 0.0)
    ok = ok & (norm[..., 0] > 1e-12)
    return n, ok


def sobel_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Scharr-style 3x3 derivative images (computeDerivativeImages,
    cudafuncs.cu:655-715), truncated toward zero like the reference's short
    store.  Returns (dIdx, dIdy) unscaled.  The sums round as fused
    multiply-adds, like rgb_to_intensity's, since the truncation turns one
    ulp into a whole unit."""
    a, b = _SCHARR
    left = _shifted(img, 0, -1)
    right = _shifted(img, 0, 1)
    up = _shifted(img, -1, 0)
    down = _shifted(img, 1, 0)
    ul = _shifted(img, -1, -1)
    ur = _shifted(img, -1, 1)
    dl = _shifted(img, 1, -1)
    dr = _shifted(img, 1, 1)
    dIdx = _fma(dr - dl, a, _fma(ur - ul, a, b * (right - left)))
    dIdy = _fma(dr - ur, a, _fma(dl - ul, a, b * (down - up)))
    return torch.trunc(dIdx), torch.trunc(dIdy)


def vertices_to_depth(vmap: torch.Tensor, valid: torch.Tensor, max_depth: float) -> torch.Tensor:
    """Predicted vertex map -> depth image; out-of-range/invalid -> 0
    (verticesToDepth, cudafuncs.cu:602-622)."""
    z = vmap[..., 2]
    ok = valid & (z > 0) & (z < max_depth)
    return torch.where(ok, z, 0.0)


def resize_map_half(
    m: torch.Tensor, valid: torch.Tensor, normalize: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """2x downsample of a vertex/normal map by averaging the valid samples of
    each 2x2 block (resizeMapKernel, cudafuncs.cu:366-445)."""
    blocks = (m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2], m[1::2, 1::2])
    oks = tuple(
        o.to(m.dtype)
        for o in (valid[0::2, 0::2], valid[0::2, 1::2], valid[1::2, 0::2], valid[1::2, 1::2])
    )
    den = oks[0] + oks[1] + oks[2] + oks[3]
    acc = blocks[0] * oks[0][..., None]
    for blk, ok in zip(blocks[1:], oks[1:]):
        acc = acc + blk * ok[..., None]
    avg = acc / torch.clamp(den[..., None], min=1.0)
    ok = den > 0
    if normalize:
        norm = norm3(avg)[..., None]
        avg = torch.where(norm > 1e-12, avg / torch.clamp(norm, min=1e-12), 0.0)
        ok = ok & (norm[..., 0] > 1e-12)
    return torch.where(ok[..., None], avg, 0.0), ok
