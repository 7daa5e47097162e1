"""Model-to-model odometry and local loop closure — PyTorch counterpart of
cofusion_tpu/ops/local_loop.py (the local-loop block of
CoFusion::processFrame, Core/CoFusion.cpp:387-459):

  1. the caller renders the global model's INACTIVE surfels into the
     current view (combinedPredict(..., INACTIVE), CoFusion.cpp:390);
  2. RGB-D odometry between the ACTIVE prediction (current geometry) and
     the INACTIVE one (old geometry), without SO(3) pre-alignment
     (CoFusion.cpp:394-405);
  3. gates on the covariance diagonal, inlier count and residual
     (CoFusion.cpp:407-423; the '-cv', '-ic', '-ie' flags);
  4. surface constraints from the cons_sample-strided active vertices
     where the old view has geometry (CoFusion.cpp:424-443), source under
     the current pose and target under the loop-corrected one (the live
     ElasticFusion form; the reference release builds both with one pose).

The odometry always runs: it is the detector.  The covariance is the
diagonal of A^-1 from `inv_ex(check_errors=False)` (`inv` checks its
result on the host).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, TrackingParams
from cofusion_tpu_torch.ops import odometry as od
from cofusion_tpu_torch.ops import preprocess as pp
from cofusion_tpu_torch.ops import rasterize as rz


class LocalLoopResult(NamedTuple):
    est_pose: torch.Tensor         # (4, 4) loop-corrected global pose
    accepted: torch.Tensor         # () bool: covariance/inlier/residual gates passed
    icp_error: torch.Tensor        # () residual of the model-to-model solve
    icp_count: torch.Tensor        # () inlier count
    src: torch.Tensor              # (C, 3) constraint sources (world, current pose)
    tgt: torch.Tensor              # (C, 3) constraint targets (world, corrected pose)
    cons_valid: torch.Tensor       # (C,) bool
    num_constraints: torch.Tensor  # () int32


def local_loop(
    old: rz.SplatMap,
    pose: torch.Tensor,
    splat_active: rz.SplatMap,
    cam: CameraConfig,
    cfg: CoFusionConfig,
    tparams: TrackingParams,
    time,
    time_delta,
    depth_cutoff,
    conf_threshold,
    cov_thresh,
    icp_err_thresh,
    icp_count_thresh,
    graphs=None,
) -> LocalLoopResult:
    """One local-loop attempt for the global model.  `splat_active` is the
    ACTIVE prediction rendered at the post-tracking `pose` (the reference
    calls predict() right before this block, CoFusion.cpp:347), `old` the
    INACTIVE one.  `time`, `time_delta` and `conf_threshold` are the
    renders' (the caller's), kept for the JAX signature.  `graphs`: the
    engine's graph cache (graphs.py), for the solve."""
    # no GN stride: the gates are absolute, calibrated for full-resolution
    # correspondence counts
    loop_cfg = cfg.replace(use_so3=False, gn_stride_l0=1)
    frame_pyr = od.build_frame_pyramid_from_maps(
        splat_active.vert_conf[..., :3], splat_active.normal_rad[..., :3], splat_active.valid,
        pp.rgb_to_intensity(splat_active.image), cam, loop_cfg, tparams.max_depth_rgb,
    )
    model_pyr = od.build_model_pyramid(
        old.vert_conf[..., :3], old.normal_rad[..., :3], old.valid,
        pp.rgb_to_intensity(old.image), pose, cam, loop_cfg, tparams.max_depth_rgb,
    )
    res = od.get_incremental_transformation(
        pose, frame_pyr, model_pyr, frame_pyr.intensity[cfg.pyramid_levels - 1],
        cam, loop_cfg, tparams, graphs=graphs,
    )

    eye6 = torch.eye(6, dtype=torch.float32, device=pose.device)
    cov = torch.diagonal(torch.linalg.inv_ex(res.A + 1e-12 * eye6, check_errors=False).inverse)
    cov_ok = (cov < cov_thresh).all() & torch.isfinite(cov).all()
    accepted = cov_ok & (res.icp_count > icp_count_thresh) & (res.icp_error < icp_err_thresh)

    s = cfg.cons_sample
    sv = splat_active.vert_conf[::s, ::s, :3].reshape(-1, 3)
    # the reference gates on timesBuff > 0 as its "the old view rendered
    # here" (CoFusion.cpp:432); the SplatMap has an explicit validity mask
    ov = old.valid[::s, ::s].reshape(-1)
    cons_valid = (sv[:, 2] > 0) & (sv[:, 2] < depth_cutoff) & ov
    src = sv @ pose[:3, :3].T + pose[:3, 3]
    tgt = sv @ res.pose[:3, :3].T + res.pose[:3, 3]
    return LocalLoopResult(
        est_pose=res.pose,
        accepted=accepted,
        icp_error=res.icp_error,
        icp_count=res.icp_count,
        src=src,
        tgt=tgt,
        cons_valid=cons_valid,
        num_constraints=cons_valid.sum(dtype=torch.int32),
    )
