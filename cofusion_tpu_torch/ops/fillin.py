"""FillIn: composite predicted maps with raw-frame data where the prediction has
holes — PyTorch counterpart of cofusion_tpu/ops/fillin.py (the reference's
FillIn pass, Core/Shaders/FillIn.{h,cpp}; CoFusion::predict, CoFusion.cpp:541).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cofusion_tpu_torch.config import CameraConfig
from cofusion_tpu_torch.ops import preprocess as pp
from cofusion_tpu_torch.ops.rasterize import SplatMap


class FilledPrediction(NamedTuple):
    image: torch.Tensor   # (H, W, 3)
    vert: torch.Tensor    # (H, W, 3) camera-frame vertices
    normal: torch.Tensor  # (H, W, 3)
    valid: torch.Tensor   # (H, W)


def fill_in(
    splat: SplatMap,
    raw_rgb: torch.Tensor,
    filtered_depth: torch.Tensor,
    cam: CameraConfig,
    depth_cutoff,
    passthrough_geom,
    passthrough_rgb,
) -> FilledPrediction:
    """Predicted-over-raw compositing.  The passthrough switches are device
    bools (no host branch), split per channel as Model::performFillIn does
    (Model.cpp:901-910): vertices and normals pass through raw while tracking
    is lost; the image also under '-ftf' (lost | frameToFrameRGB), which
    makes the photometric term frame-to-frame while the geometry stays
    frame-to-model."""
    vmap_raw, raw_ok = pp.compute_vmap(filtered_depth, cam, depth_cutoff)
    nmap_raw, n_ok = pp.compute_nmap(vmap_raw, raw_ok)
    raw_ok = raw_ok & n_ok

    use_pred_g = (splat.valid & ~passthrough_geom)[..., None]
    use_pred_i = (
        use_pred_g if passthrough_rgb is passthrough_geom
        else (splat.valid & ~passthrough_rgb)[..., None]
    )
    image = torch.where(use_pred_i, splat.image, raw_rgb)
    vert = torch.where(use_pred_g, splat.vert_conf[..., :3], vmap_raw)
    normal = torch.where(use_pred_g, splat.normal_rad[..., :3], nmap_raw)
    valid = use_pred_g[..., 0] | raw_ok
    return FilledPrediction(image=image, vert=vert, normal=normal, valid=valid)
