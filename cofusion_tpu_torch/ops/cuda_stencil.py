"""The 13x13 metric bilateral depth filter: hand-written CUDA kernel
(csrc/bilateral.cu) and its plain PyTorch version.

Replaces the Pallas TPU kernel `cofusion_tpu/ops/pallas_stencil.py`
(`_bilateral_kernel`, launched by `_bilateral_pallas`).  Math, from
depth_bilateral_metric.frag:30-76 as the reference's XLA form writes it
(cofusion_tpu/ops/preprocess.py:74-92):

    w   = exp(-(dpx^2 * 0.024691358 + dd^2 * 555.556))
    out = sum(w * d) / max(sum(w), 1e-12),   0 where the centre is outside
                                             [0.3, max_depth]

Only taps outside the image are dropped; zero-depth neighbours are weighted
like any other (the reference's quirk, kept).

`bilateral_filter_plain` runs anywhere and is what the CPU tests hold to the
JAX package; `bilateral_filter_cuda` launches the kernel and accepts only a
CUDA tensor.  `preprocess.bilateral_filter` picks between them by the tensor's
device, never by catching a failure.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

RADIUS = 6
_SIGMA_SPACE2_INV_HALF = 0.024691358
_SIGMA_COLOR2_INV_HALF = 555.556


def bilateral_filter_plain(depth: torch.Tensor, max_depth: float) -> torch.Tensor:
    """Plain PyTorch form (shift-and-accumulate over the 169 taps, dy-major,
    dx-minor — the order the kernel sums in)."""
    H, W = depth.shape
    R = RADIUS
    padded = F.pad(depth[None, None], (R, R, R, R), value=float("inf"))[0, 0]
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            nbr = padded[R + dy:R + dy + H, R + dx:R + dx + W]
            inb = torch.isfinite(nbr)
            nbr = torch.where(inb, nbr, 0.0)
            space2 = float(dy * dy + dx * dx)
            diff = depth - nbr
            color2 = diff * diff
            w = torch.exp(-(space2 * _SIGMA_SPACE2_INV_HALF + color2 * _SIGMA_COLOR2_INV_HALF))
            w = torch.where(inb, w, 0.0)
            num = num + nbr * w
            den = den + w
    out = num / torch.clamp(den, min=1e-12)
    center_ok = (depth >= 0.3) & (depth <= max_depth)
    return torch.where(center_ok, out, 0.0)


def bilateral_filter_cuda(depth: torch.Tensor, max_depth: float) -> torch.Tensor:
    """Launch csrc/bilateral.cu on the current stream.  `depth` must be a
    contiguous float32 (H, W) CUDA tensor; `max_depth` is passed by value."""
    if depth.device.type != "cuda":
        raise ValueError(f"bilateral_filter_cuda needs a CUDA tensor, got {depth.device}")
    if depth.dtype != torch.float32 or depth.dim() != 2 or not depth.is_contiguous():
        raise ValueError(
            f"bilateral_filter_cuda needs a contiguous float32 (H, W) tensor, got "
            f"{depth.dtype} {tuple(depth.shape)} contiguous={depth.is_contiguous()}"
        )
    from cofusion_tpu_torch.ops import _build

    lib = _build.load().lib
    H, W = depth.shape
    out = torch.empty_like(depth)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        err = lib.cofusion_bilateral_f32(
            depth.data_ptr(), out.data_ptr(), H, W, float(max_depth), stream
        )
    _build.check_launch("cofusion_bilateral_f32", err)
    bilateral_filter_cuda.launches += 1
    return out


bilateral_filter_cuda.launches = 0
