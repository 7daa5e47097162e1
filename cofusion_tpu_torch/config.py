"""Configuration of the port — the fields of cofusion_tpu/config.py that the
static and multi-model paths, relocalisation and loop closure read, with the same names and defaults (tests/test_torch_config.py
holds them equal), so a configuration means the same thing in both packages.

Reference parity (flag defaults of the reference):
  * camera defaults 640x480 @ (fx,fy,cx,cy)=(528,528,320,240) — GUI/MainController.cpp:108-110
  * tracking schedule {10,5,4} iters fine->coarse, SO3 pre-align <=10 @ level 2 —
    Core/Utils/RGBDOdometry.cpp:257,312-314
  * ICP gates dist<=0.10 m / sin(20 deg), icp:rgb weight 10 — Core/Utils/RGBDOdometry.h:35-36,
    Core/CoFusion.h:48
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class CameraConfig:
    """Image resolution + pinhole intrinsics (Core/Utils/Resolution.h, Intrinsics.h)."""

    width: int = 640
    height: int = 480
    fx: float = 528.0
    fy: float = 528.0
    cx: float = 320.0
    cy: float = 240.0

    def at_level(self, level: int) -> "CameraConfig":
        """Intrinsics of pyramid level `level` (0 = full resolution): each level
        halves the resolution and scales (fx, fy, cx, cy) by 2^-level."""
        s = 1.0 / (1 << level)
        return CameraConfig(
            width=self.width >> level,
            height=self.height >> level,
            fx=self.fx * s,
            fy=self.fy * s,
            cx=self.cx * s,
            cy=self.cy * s,
        )

    @property
    def shape(self) -> tuple[int, int]:
        return (self.height, self.width)

    @property
    def mean_focal(self) -> float:
        return 0.5 * (self.fx + self.fy)


@dataclass(frozen=True)
class CoFusionConfig:
    """Shape- and control-flow-determining engine configuration."""

    camera: CameraConfig = CameraConfig()

    # --- capacity
    max_models: int = 4
    # stable-tier surfel capacity per model (the reference allocates 3072^2,
    # Core/Model/Model.cpp:92-98)
    max_surfels: int = 1 << 20
    # active-tier capacity: surfels inside the time window, which every
    # per-frame pass touches.  None -> min(2^19, max_surfels)
    active_surfels: int | None = None
    # object-slot (m > 0) active-tier capacity: object slots run fuse/clean on
    # a [:object_active_capacity] slice.  None -> min(2^17, active_capacity)
    object_active_surfels: int | None = None
    # surfels migrated active -> stable per frame (static block size)
    expel_block_log2: int = 16

    # --- tracking schedule
    pyramid_levels: int = 3
    so3_iters: int = 10
    gn_iters: tuple[int, int, int] = (10, 5, 4)  # level 0, 1, 2
    fast_odom: bool = False
    use_so3: bool = True
    use_pyramid: bool = True
    # correspondence stride at pyramid levels 0 and 1
    gn_stride_l0: int = 2
    gn_stride_l1: int = 1

    # --- rasterizer
    splat_radius: int = 3   # window half-size of the splat render
    assoc_radius: int = 2   # data-association window half-size (data.vert:138)

    # --- segmentation (Segmentation.cpp:55, Slic.cpp:38)
    superpixel_size: int = 16
    crf_iterations: int = 10
    slic_iterations: int = 5

    # --- loop closure
    # deformation-graph nodes (dense normal equations are (12 G)^2) and the
    # local loop's constraint sampling stride in pixels (consSample,
    # Core/CoFusion.cpp:39-44)
    deform_nodes: int = 256
    cons_sample: int = 20

    # --- misc
    time_delta: int = 200   # active/inactive surfel window, ModelProjection.h:41
    max_log_frames: int = 8192   # on-device pose ring (frames)
    mask_ring_frames: int = 64   # on-device mask ring (frames)

    @property
    def active_capacity(self) -> int:
        if self.active_surfels is not None:
            return min(self.active_surfels, self.max_surfels)
        return min(1 << 19, self.max_surfels)

    @property
    def object_active_capacity(self) -> int:
        """Active-tier capacity of object slots; never below `expel_block`."""
        cap = self.object_active_surfels if self.object_active_surfels is not None else 1 << 17
        return max(min(cap, self.active_capacity), self.expel_block)

    @property
    def expel_block(self) -> int:
        return min(1 << self.expel_block_log2, self.max_surfels, self.active_capacity)

    def replace(self, **kw) -> "CoFusionConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrackingParams:
    """Tracking scalars (RGBDOdometry.h:35-36, RGBDOdometry.cpp:31-34,102-105,
    CoFusion.h:48); the meaning of each is documented in cofusion_tpu/config.py."""

    icp_weight: float = 10.0
    dist_thresh: float = 0.10
    angle_thresh_sin: float = math.sin(20.0 * math.pi / 180.0)
    max_depth_delta_rgb: float = 0.07
    max_depth_rgb: float = 6.0
    sobel_scale: float = 1.0 / 8.0
    min_grad_mags: tuple[float, float, float] = (5.0, 3.0, 1.0)
    rgb_only: bool = False
    max_translation_jump: float = 0.3   # RGBDOdometry.cpp:464-467
    min_correspondences: float = 20.0
    gn_converge_eps: float = 1e-5
    consistent_icp_weighting: bool = True


@dataclass(frozen=True)
class SegmentationParams:
    """CRF motion-segmentation parameters: the reference's live GUI values
    (GUI/Tools/GUI.h:210-227), as in cofusion_tpu/config.py."""

    crf_iterations: int = 10
    scale_rgb: float = 1.0 / 10.0     # GUI pairwiseRGBSTD
    scale_depth: float = 1.0 / 0.9    # GUI pairwiseDepthSTD
    scale_pos: float = 1.0 / 1.8      # GUI pairwisePosSTD (superpixel units)
    weight_appearance: float = 7.0
    weight_smoothness: float = 2.0
    unary_threshold_new: float = 5.5
    unary_k_error: float = 0.0375
    unary_weight_error: float = 75.0
    min_rel_size_new: float = 0.015
    max_rel_size_new: float = 0.4


@dataclass(frozen=True)
class FusionParams:
    """Fusion and model-lifecycle scalars (GUI/Tools/GUI.h:184-244)."""

    depth_cutoff: float = 3.0          # '-d'
    confidence_global: float = 10.0    # '-confG'
    confidence_object: float = 9.0     # '-confO'
    # free-space violation decay coefficient (copy_unstable.vert:138-149)
    # and mask-mismatch penalty 0.5+0.5*(1-coeff/10)
    outlier_coefficient: float = 3.0
    # frames between model spawns ('-offset'; CoFusion.cpp:112,230,256)
    model_spawn_offset: int = 22
    # consecutive unseen frames before an object model is deactivated
    # (1 reproduces the reference's first-miss inactivation, CoFusion.cpp:285)
    model_deactivate_count: int = 1
    # relocalisation (Core/Ferns.cpp): least keyframe age for retrieval, the
    # recovery ICP error gate (tuned for 80x60 fern maps), the photometric
    # gate ('-pt') and the keyframe-add dissimilarity threshold ('-ft')
    fern_min_age: int = 300
    fern_icp_error_thresh: float = 3e-4
    fern_photo_thresh: float = 115.0
    fern_thresh: float = 0.3095
    # local loop closure gates ('-cv', '-ie', '-ic'; the count is for
    # 640x480 and scaled by resolution where it is used)
    local_loop_cov_thresh: float = 1e-5
    local_loop_err_thresh: float = 5e-5
    local_loop_count_thresh: float = 40000.0
