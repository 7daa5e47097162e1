"""Roofline arithmetic of the port's two hand-written kernels: a frozen copy
of `chip_smoke.py`'s `_bound`, `_splat_bound` and `_bilateral_bound`, with
the splat's counts taken from the launch's inputs and the bilateral's from
the depth image on the host.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W power limit (HBM3
bytes per second, fp32 outside the tensor cores); the special-function unit
at 16 results per clock per SM x 132 SMs x 1.98 GHz boost clock.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9


def bound_ms(bytes_moved: float, ops: dict) -> tuple[float, str]:
    """Least time in ms for the work: bytes over the memory rate against
    each kind of operation over its peak rate; and which bounds it."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = max(n / rate for n, rate in ops.values())
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def splat_bound_ms(n_px: int, n_valid: int, n_tests: int) -> tuple[float, str]:
    """One window sweep: each valid candidate's position, normal and radius
    read once (28 B), every validity byte, and best_z/best_tap written
    (8 B/px); ~26 fp32 ops per ray-disk test of a valid in-image candidate,
    6 to fold p.n and r^2, 10 for each ray.  `n_tests` is the number of
    (pixel, valid in-image tap) pairs."""
    return bound_ms(n_valid * 28 + n_px * 9,
                    {"fp32": (n_tests * 26 + n_valid * 6 + n_px * 10, FP32_OPS_PER_S)})


def bilateral_exp_count(depth: np.ndarray, max_depth: float, radius: int = 6) -> int:
    """Finite in-image taps of the 13x13 window summed over the centres
    inside [0.3, max_depth]: one exp each."""
    d = np.asarray(depth, np.float64)
    centre = (d >= 0.3) & (d <= max_depth)
    finite = np.isfinite(d).astype(np.int64)
    k = 2 * radius + 1
    pad = np.pad(finite, radius)
    c = np.pad(pad.cumsum(0).cumsum(1), ((1, 0), (1, 0)))
    H, W = d.shape
    taps = c[k:k + H, k:k + W] - c[0:H, k:k + W] - c[k:k + H, 0:W] + c[0:H, 0:W]
    return int(taps[centre].sum())


def bilateral_bound_ms(depth: np.ndarray, max_depth: float) -> tuple[float, str]:
    """One filter on this depth image: 4 B/px read and written; for each
    centre inside [0.3, max_depth], one exp (special-function unit) and ~10
    fp32 ops per finite in-image tap."""
    n_exp = bilateral_exp_count(depth, max_depth)
    return bound_ms(depth.size * 8, {"sfu": (n_exp, SFU_OPS_PER_S),
                                     "fp32": (n_exp * 10, FP32_OPS_PER_S)})
