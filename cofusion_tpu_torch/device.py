"""Device selection for the port: an explicit `torch.device`, never a global default.

`resolve_device` is the one place that decides where the engine runs.  It
raises when CUDA is asked for and absent (no quiet fall back to the CPU), and
on a CUDA device it turns TF32 off for matmuls and cuDNN: the JAX reference
pins `Precision.HIGHEST` for pose math and the Gauss-Newton normal equations
(cofusion_tpu/ops/lie.py, odometry.py, rasterize.py), and TF32 keeps only
~10 mantissa bits.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected 'cpu' or 'cuda'")
    return dev


def upload(array, device: torch.device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Host array -> device tensor without a host sync: the copy is issued
    non-blocking, so the async frame loop never waits on it (a blocking
    host-to-device copy synchronises the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.to(device, non_blocking=True)
