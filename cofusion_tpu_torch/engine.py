"""The CoFusion engine, static slice — PyTorch counterpart of
cofusion_tpu/engine.py for the `-static` (ElasticFusion) mode: one global
model (`max_models == 1`), no segmentation, no relocalisation, no loop
closure (Core/CoFusion.cpp processFrame :171-524 with a single model).

One frame (`_step`): bilateral filter (CUDA kernel) -> intensity -> FillIn
of the carried prediction -> frame/model pyramids -> track (SO(3)
pre-align, 3-level ICP+RGB Gauss-Newton) -> fuse/clean (z-buffer render,
fuse, overlay, clean, expel into the stable tier) -> window splat (CUDA
kernel) of the next frame's prediction.  Frame 1 takes `_init_state`.

The host loop is asynchronous: `process_frame` uploads the frame with a
non-blocking copy and queues the step; nothing in it reads a device value
(no `.item()`, no host branch on a device bool, no data-dependent shape).
`stats()` and the pose-log readers synchronise on demand.

The state keeps the JAX engine's layout — a leading (M,) model axis on every
per-model leaf, the same fields in the same order — so convert.py carries a
JAX state across field for field.  The tick is a host int: the host counts
frames anyway, and a device tick would need a read-back to drive the
stagger phase.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams, TrackingParams
from cofusion_tpu_torch.device import resolve_device, upload
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.models.surfel_model import SurfelStore
from cofusion_tpu_torch.ops import fillin as fi
from cofusion_tpu_torch.ops import fusion as fu
from cofusion_tpu_torch.ops import lie
from cofusion_tpu_torch.ops import odometry as od
from cofusion_tpu_torch.ops import preprocess as pp
from cofusion_tpu_torch.ops import rasterize as rz
from cofusion_tpu_torch.utils.stopwatch import Stopwatch


class ModelState(NamedTuple):
    """Per-model state; every leaf has a leading (M,) model axis.  `store` is
    the ACTIVE tier (surfels inside the time window), `stable` the
    append-only ring of surfels that aged out of it."""

    store: SurfelStore           # ACTIVE tier, leaves (M, A)
    stable: SurfelStore          # STABLE tier, leaves (M, S)
    pose: torch.Tensor           # (M, 4, 4) model pose (camera-to-world)
    prev_pose: torch.Tensor      # (M, 4, 4) pose at the previous frame
    conf_threshold: torch.Tensor  # (M,)
    max_depth: torch.Tensor      # (M,) per-model fusion depth clamp
    active: torch.Tensor         # (M,) bool
    age: torch.Tensor            # (M,) int32
    model_id: torch.Tensor       # (M,) int32
    unseen: torch.Tensor         # (M,) int32
    spawn_cooldown: torch.Tensor  # () int32


class EngineState(NamedTuple):
    models: ModelState
    tick: int                    # frames seen (host-side)
    so3_ref: torch.Tensor        # coarsest-level intensity of the previous frame
    icp_error_maps: torch.Tensor  # (M, H, W) per-model ICP error (CRF input; zeros here)
    prev_rgb: torch.Tensor       # (H, W, 3) previous frame rgb (FillIn source)
    prev_filtered: torch.Tensor  # (H, W) previous filtered depth
    prev_mask: torch.Tensor      # (H, W) int32 previous frame's mask
    pose_history: torch.Tensor   # (LOG_CAP, M, 4, 4) on-device pose ring
    fern_db: torch.Tensor        # () placeholder (relocalisation not ported)
    lost: torch.Tensor           # () bool tracking-lost flag
    unstable_count: torch.Tensor  # () int32
    mask_history: torch.Tensor   # (R, H, W) uint8 mask ring
    pred: rz.SplatMap            # (M, H, W[, C]) prediction carried to the next frame


class FrameOutputs(NamedTuple):
    """Small per-frame outputs; materialised only on demand."""

    poses: torch.Tensor          # (M, 4, 4)
    icp_error: torch.Tensor      # (M,)
    icp_count: torch.Tensor      # (M,)
    rgb_error: torch.Tensor      # (M,)
    surfel_counts: torch.Tensor  # (M,)
    active: torch.Tensor         # (M,) bool
    spawned: torch.Tensor        # () bool
    loop_closed: torch.Tensor    # () bool


def _render_pred_init(store, poses, conf_threshold, tick, time_delta, depth_cutoff, *, cam, cfg):
    """One-off batched prediction render that seeds EngineState.pred."""
    return rz.splat_predict_b(
        store, poses, cam, cfg, tick, time_delta, depth_cutoff, conf_threshold
    )


def _fusion_weight(pose: torch.Tensor, prev_pose: torch.Tensor, multiplier) -> torch.Tensor:
    """Velocity-based fusion weight (Model::computeFusionWeight,
    Model.cpp:391-406): fast motion deposits less confidence, clamped to
    [0.5, 1] x multiplier."""
    diff = lie.compose(lie.invert_rt(prev_pose), pose)
    w = torch.maximum(
        torch.linalg.vector_norm(diff[:3, 3]),
        torch.linalg.vector_norm(lie.so3_log(diff[:3, :3])),
    )
    w = torch.clamp(w, max=0.01)
    return torch.clamp(1.0 - w / 0.01, min=0.5) * multiplier


def _batch(tup):
    """Add the leading (M=1,) model axis to every leaf of a NamedTuple."""
    return type(tup)(*(a[None] for a in tup))


def _unbatch(tup, m: int = 0):
    return type(tup)(*(a[m] for a in tup))


# ---------------------------------------------------------------------------
# the per-frame step


def _step(
    state: EngineState,
    rgb: torch.Tensor,
    depth: torch.Tensor,
    mask: torch.Tensor,
    fparams: dict,
    *,
    cam: CameraConfig,
    cfg: CoFusionConfig,
    tparams: TrackingParams,
):
    """One `-static` frame (CoFusion::processFrame with the global model only).

    `fparams` holds the run-time scalars as Python numbers (depth_cutoff,
    outlier_coeff, icp_weight, time_delta, weight_multiplier).

    The step consumes its input state: the stable tier and the pose and mask
    rings are updated in place (the JAX engine donates its state to the step
    the same way); everything else is rebuilt."""
    M = cfg.max_models
    tick = state.tick + 1
    models = state.models
    depth_cutoff = fparams["depth_cutoff"]

    # --- preprocess
    intensity = pp.rgb_to_intensity(rgb)
    filtered = pp.bilateral_filter(depth, depth_cutoff)

    # --- FillIn of the carried prediction (CoFusion.cpp:541): previous raw
    # frame into prediction holes; passthrough while lost,
    # Model::performFillIn (Model.cpp:901-910)
    filled = fi.fill_in(
        _unbatch(state.pred), state.prev_rgb, state.prev_filtered, cam, depth_cutoff,
        passthrough=state.lost,
    )

    # --- tracking pyramids and the batched GN solve
    frame_pyr = od.build_frame_pyramid(
        filtered, intensity, cam, cfg, depth_cutoff, tparams.max_depth_rgb
    )
    mpyr = od.build_model_pyramid(
        filled.vert, filled.normal, filled.valid, pp.rgb_to_intensity(filled.image),
        models.pose[0], cam, cfg, tparams.max_depth_rgb,
    )
    mpyr_b = od.ModelPyramid(*(tuple(a[None] for a in level) for level in mpyr))
    valid_b = tuple(v[None] for v in frame_pyr.valid)
    rgb_ok_b = tuple(v[None] for v in frame_pyr.rgb_ok)
    res = od.track_models(
        models.pose, frame_pyr, valid_b, rgb_ok_b, mpyr_b, state.so3_ref,
        cam, cfg, tparams, icp_weight=fparams["icp_weight"],
    )
    # inactive slots keep their pose and report identity/zero stats
    act = models.active
    act3 = act[:, None, None]
    eye6 = torch.eye(6, dtype=torch.float32, device=act.device)[None]
    res = od.OdometryResult(
        pose=torch.where(act3, res.pose, models.pose),
        A=torch.where(act3, res.A, eye6),
        b=torch.where(act[:, None], res.b, 0.0),
        icp_error=torch.where(act, res.icp_error, 0.0),
        icp_count=torch.where(act, res.icp_count, 0.0),
        rgb_error=torch.where(act, res.rgb_error, 0.0),
        rgb_count=torch.where(act, res.rgb_count, 0.0),
        so3_error=torch.where(act, res.so3_error, 0.0),
    )
    new_pose = res.pose

    # --- fuse + clean, then the next frame's prediction: one window splat
    # over the post-fuse render, confidence-gated (splat.vert:58)
    weight = _fusion_weight(new_pose[0], models.pose[0], fparams["weight_multiplier"])
    new_stores, new_stables, imap_b = _fuse_clean_all(
        models.store, models.stable, new_pose, weight, models.conf_threshold,
        depth, filtered, rgb, cam, cfg, tick, fparams,
    )
    pred_new = rz.splat_from_imap(imap_b, cam, cfg, conf_threshold=models.conf_threshold)

    so3_ref = intensity
    for _ in range(cfg.pyramid_levels - 1):
        so3_ref = pp.pyr_down_gauss(so3_ref)

    new_active = models.active
    new_models = ModelState(
        store=new_stores,
        stable=new_stables,
        pose=new_pose,
        prev_pose=models.pose,
        conf_threshold=models.conf_threshold,
        max_depth=torch.full((M,), depth_cutoff, dtype=torch.float32, device=act.device),
        active=new_active,
        age=models.age + new_active.to(torch.int32),
        model_id=models.model_id,
        unseen=models.unseen,
        spawn_cooldown=models.spawn_cooldown,
    )
    state.pose_history[(tick - 1) % cfg.max_log_frames] = new_pose
    state.mask_history[(tick - 1) % cfg.mask_ring_frames] = mask.to(torch.uint8)
    new_state = EngineState(
        models=new_models,
        tick=tick,
        so3_ref=so3_ref,
        icp_error_maps=state.icp_error_maps,
        prev_rgb=rgb,
        prev_filtered=filtered,
        prev_mask=mask,
        pose_history=state.pose_history,
        fern_db=state.fern_db,
        lost=state.lost,
        unstable_count=state.unstable_count,
        mask_history=state.mask_history,
        pred=pred_new,
    )
    outputs = FrameOutputs(
        poses=new_pose,
        icp_error=res.icp_error,
        icp_count=res.icp_count,
        rgb_error=res.rgb_error,
        surfel_counts=new_stores.count + torch.clamp(new_stables.count, max=new_stables.capacity),
        active=new_active.clone(),
        spawned=torch.zeros((), dtype=torch.bool, device=act.device),
        loop_closed=torch.zeros((), dtype=torch.bool, device=act.device),
    )
    return new_state, outputs


def _fuse_clean_all(
    stores, stables, new_pose, weight, conf_thresholds, depth, filtered, rgb,
    cam, cfg, tick: int, fparams,
):
    """Fuse + clean of the global model (CoFusion.cpp:463-489: predictIndices
    -> fuse -> overlay in place of the second predictIndices -> clean), plus
    the two-tier step: survivors that aged out of the time window move to
    the stable tier.  Returns (new active stores, new stable stores,
    post-fuse index renders), all with the (M=1,) axis.

    With one model the global slot is always active, so the fuse runs
    unconditionally (the JAX engine's `lax.cond` on `active_fuse` is always
    taken)."""
    max_d = fparams["depth_cutoff"]
    time_delta = fparams["time_delta"]
    store = _unbatch(stores)
    pose = new_pose[0]
    fs = fu.make_frame_surfels(depth, filtered, rgb, cam, weight, max_d)
    mask_ok = torch.ones(cam.shape, dtype=torch.bool, device=depth.device)
    imap = rz.predict_indices(store, pose, cam, tick, time_delta, max_d)
    fused, aux = fu.fuse(
        store, fs, depth, imap, mask_ok, pose, cam, cfg, tick, max_d, return_aux=True
    )
    imap2 = fu.overlay_imap(fused, imap, aux, fs, pose, cam, tick)
    cleaned, keep = fu.clean_eval(
        fused, imap2, filtered, pose, cam, tick, time_delta,
        conf_thresholds[0], fparams["outlier_coeff"],
    )
    # age-out migration: surfels past the window move to the stable tier
    out, blk = sm.expel_split(
        cleaned, keep,
        (cleaned.last_time > 0) & ((float(tick) - cleaned.last_time) > float(time_delta)),
        cfg.expel_block,
    )
    return _batch(out), _append_expel_blocks(stables, _batch(blk), cfg), _batch(imap2)


def _append_expel_blocks(stables: SurfelStore, blks: SurfelStore, cfg) -> SurfelStore:
    """Append each model's expel block into its stable ring with one
    contiguous write per attribute, IN PLACE.  `count` is the monotone
    total-appended cursor and the write offset is count mod S; when the tail
    is shorter than a block the cursor skips to the next S boundary, so on
    overflow the oldest rows are overwritten round-robin.  The offset is
    device index arithmetic (`off + arange(B)`), never read back; when
    nothing is expelled the window is written back unchanged."""
    M = int(stables.count.shape[0])
    S = int(stables.capacity)
    B = int(cfg.expel_block)
    counts = []
    for m in range(M):
        n_ex = blks.count[m].to(torch.int64)
        cursor = stables.count[m].to(torch.int64)
        off_raw = torch.remainder(cursor, S)
        base = torch.where(off_raw + B > S, cursor - off_raw + S, cursor)
        rows_at = torch.remainder(base, S) + torch.arange(B, device=cursor.device)
        write = n_ex > 0
        for f in sm.DATA_FIELDS:
            leaf = getattr(stables, f)[m]
            rows = torch.where(write, getattr(blks, f)[m], leaf.index_select(0, rows_at))
            leaf.index_copy_(0, rows_at, rows)
        counts.append(torch.where(write, base + n_ex, cursor).to(torch.int32))
    return stables._replace(count=torch.stack(counts))


# ---------------------------------------------------------------------------
# host-side engine


class CoFusion:
    """Host-side engine wrapper (the reference's CoFusion class, minus GL),
    static slice.  `device` is required: the engine never picks one."""

    def __init__(
        self,
        cfg: CoFusionConfig,
        tracking: TrackingParams | None = None,
        fusion_params: FusionParams | None = None,
        enable_multi_model: bool = False,
        enable_relocalization: bool = False,
        close_loops: bool = False,
        frame_to_frame_rgb: bool = False,
        keep_models: bool = False,
        *,
        device: str | torch.device,
    ):
        if enable_multi_model or cfg.max_models != 1:
            raise NotImplementedError(
                "multi-model tracking and segmentation are not yet ported "
                "(ROADMAP A9 multi-model with GT masks, A10 CRF segmentation); "
                "use max_models=1 (the -static slice)"
            )
        if keep_models:
            raise NotImplementedError("'-keep' model lifecycle is not yet ported (ROADMAP A9)")
        if enable_relocalization:
            raise NotImplementedError("relocalisation is not yet ported (ROADMAP A12)")
        if close_loops:
            raise NotImplementedError("loop closure is not yet ported (ROADMAP A13)")
        if frame_to_frame_rgb:
            raise NotImplementedError("'-ftf' frame-to-frame RGB is not yet ported (ROADMAP A14)")
        self.cfg = cfg
        self.cam = cfg.camera
        self.device = resolve_device(device)
        self.tracking = tracking or TrackingParams()
        self.fusion = fusion_params or FusionParams()
        self.sw = Stopwatch.get()
        self.state: EngineState | None = None
        self._timestamps: list[int] = []
        self._flushed_poses: list[np.ndarray] = []
        self._ever_active: set[int] = {0}
        self._last_outputs: FrameOutputs | None = None
        # run-time scalars stay Python numbers: the kernels take them by value
        # and no per-frame host->device scalar copy is queued
        self._fparams = dict(
            depth_cutoff=float(self.fusion.depth_cutoff),
            outlier_coeff=float(self.fusion.outlier_coefficient),
            icp_weight=float(self.tracking.icp_weight),
            time_delta=int(cfg.time_delta),
        )

    # ------------------------------------------------------------------
    def _init_state(self, rgb, depth, mask) -> EngineState:
        cfg, cam, fp, dev = self.cfg, self.cam, self.fusion, self.device
        M = cfg.max_models
        intensity = pp.rgb_to_intensity(rgb)
        filtered = pp.bilateral_filter(depth, fp.depth_cutoff)
        fs = fu.make_frame_surfels(depth, filtered, rgb, cam, 1.0, fp.depth_cutoff)
        eye4 = torch.eye(4, dtype=torch.float32, device=dev)
        # model 0 = static background/global model (CoFusion.cpp:70-71)
        store0 = fu.initialise(fs, eye4, cfg.active_capacity, time=1)
        models = ModelState(
            store=_batch(store0),
            stable=_batch(sm.empty_store(cfg.max_surfels, dev)),
            pose=eye4[None].clone(),
            prev_pose=eye4[None].clone(),
            conf_threshold=torch.full((M,), fp.confidence_global, dtype=torch.float32, device=dev),
            max_depth=torch.full((M,), fp.depth_cutoff, dtype=torch.float32, device=dev),
            active=torch.ones((M,), dtype=torch.bool, device=dev),
            age=torch.zeros((M,), dtype=torch.int32, device=dev),
            model_id=torch.arange(M, dtype=torch.int32, device=dev),
            unseen=torch.zeros((M,), dtype=torch.int32, device=dev),
            spawn_cooldown=torch.zeros((), dtype=torch.int32, device=dev),
        )
        so3_ref = intensity
        for _ in range(cfg.pyramid_levels - 1):
            so3_ref = pp.pyr_down_gauss(so3_ref)
        # seed the carried prediction with a one-off render of the new map
        pred = _render_pred_init(
            models.store, models.pose, models.conf_threshold, 1, cfg.time_delta,
            models.max_depth, cam=cam, cfg=cfg,
        )
        return EngineState(
            models=models,
            tick=1,
            so3_ref=so3_ref,
            icp_error_maps=torch.zeros((M,) + cam.shape, dtype=torch.float32, device=dev),
            prev_rgb=rgb,
            prev_filtered=filtered,
            prev_mask=mask,
            pose_history=eye4.expand(cfg.max_log_frames, M, 4, 4).clone(),
            fern_db=torch.zeros((), dtype=torch.int32, device=dev),
            lost=torch.zeros((), dtype=torch.bool, device=dev),
            unstable_count=torch.zeros((), dtype=torch.int32, device=dev),
            mask_history=torch.zeros(
                (cfg.mask_ring_frames,) + cam.shape, dtype=torch.uint8, device=dev
            ),
            pred=pred,
        )

    # ------------------------------------------------------------------
    def process_frame(
        self,
        frame: dict,
        weight_multiplier: float = 1.0,
        sync: bool = False,
        gt_pose: np.ndarray | None = None,
    ) -> dict:
        """One frame.  `frame`: rgb uint8 (H,W,3), depth float32 metres (H,W),
        optional mask (H,W), timestamp int.  Asynchronous: the step is queued
        and nothing waits on the device unless `sync=True`."""
        if gt_pose is not None:
            raise NotImplementedError("'-p' ground-truth poses are not yet ported (ROADMAP A14)")
        with self.sw.section("Run"):
            dev = self.device
            rgb = upload(frame["rgb"], dev, torch.float32)
            depth = upload(frame["depth"], dev, torch.float32)
            ts = frame.get("timestamp", 0)

            if self.state is None:
                with self.sw.section("Init"):
                    self.state = self._init_state(
                        rgb, depth, torch.zeros(self.cam.shape, dtype=torch.int32, device=dev)
                    )
                self._timestamps.append(ts)
                self._last_outputs = None
                return {"tick": 1}

            mask_np = frame.get("mask")
            if mask_np is not None:
                mask = upload(np.asarray(mask_np), dev, torch.int32)
            else:
                mask = torch.zeros(self.cam.shape, dtype=torch.int32, device=dev)
            with self.sw.section("odom+fuse"):
                fparams = dict(self._fparams, weight_multiplier=float(weight_multiplier))
                self.state, outputs = _step(
                    self.state, rgb, depth, mask, fparams,
                    cam=self.cam, cfg=self.cfg, tparams=self.tracking,
                )
            self._last_outputs = outputs
            self._timestamps.append(ts)

            # flush the on-device pose ring to the host before it wraps
            n_tracked = len(self._timestamps) - 1
            if n_tracked - len(self._flushed_poses) >= self.cfg.max_log_frames - 8:
                self._flush_pose_history()
            if sync:
                return self.stats()
        return {"tick": None}

    def _flush_pose_history(self) -> None:
        """Move device pose-history entries into the host-side chunk list."""
        n_tracked = len(self._timestamps) - 1
        cap = self.cfg.max_log_frames
        hist = self.state.pose_history.cpu().numpy()
        for i in range(len(self._flushed_poses) + 1, n_tracked + 1):
            self._flushed_poses.append(hist[i % cap].copy())

    def stats(self) -> dict:
        """Materialise the most recent frame's outputs (blocks on the device)."""
        with self.sw.section("download"):
            models = self.state.models
            st = {
                "tick": self.state.tick,
                "poses": models.pose.cpu().numpy(),
                "surfel_counts": (
                    models.store.count
                    + torch.clamp(models.stable.count, max=models.stable.capacity)
                ).cpu().numpy(),
                "active": models.active.cpu().numpy(),
            }
            out = self._last_outputs
            if out is not None:
                st["icp_error"] = out.icp_error.cpu().numpy()
                st["icp_count"] = out.icp_count.cpu().numpy()
                st["rgb_error"] = out.rgb_error.cpu().numpy()
        return st

    def materialized_pose_log(self) -> list[tuple[int, np.ndarray]]:
        """Pose log as numpy: host-flushed chunks + one bulk read of the
        on-device tail."""
        n = len(self._timestamps)
        cap = self.cfg.max_log_frames
        nf = len(self._flushed_poses)
        if (n - 1) - nf > cap:
            raise RuntimeError(
                f"pose history wrapped: {n - 1 - nf} unflushed frames exceed "
                f"max_log_frames={cap} (flush cadence broken)"
            )
        hist = self.state.pose_history.cpu().numpy()
        out = [(self._timestamps[0], np.broadcast_to(np.eye(4, dtype=np.float32), hist.shape[1:]).copy())]
        for i in range(1, n):
            # tracked frame i is written at history slot i
            if i <= nf:
                out.append((self._timestamps[i], self._flushed_poses[i - 1]))
            else:
                out.append((self._timestamps[i], hist[i % cap]))
        return out

    @property
    def pose_log(self) -> list[tuple[int, np.ndarray]]:
        return self.materialized_pose_log()

    def pose_log_for(self, m: int) -> list[tuple[int, np.ndarray]]:
        """Pose log in the reference's export convention (CoFusion.cpp:502-519):
        model 0 logs cam->world; objects log P_cam * P_obj^-1."""
        out = []
        for ts, poses in self.materialized_pose_log():
            if m == 0:
                out.append((ts, poses))
            else:
                composed = poses.copy()
                composed[m] = poses[0] @ np.linalg.inv(poses[m])
                out.append((ts, composed))
        return out

    def model_ever_active(self, m: int) -> bool:
        return m in self._ever_active

    def camera_pose(self) -> np.ndarray:
        """Current global-camera pose (model 0)."""
        return self.state.models.pose[0].cpu().numpy()

    def surfel_count(self, model: int = 0) -> int:
        models = self.state.models
        return int(models.store.count[model]) + min(
            int(models.stable.count[model]), models.stable.capacity
        )

    def download_model(self, model: int = 0) -> dict:
        """Whole two-tier map of one model (Model::downloadMap): stable (old)
        surfels first, then the active tier."""
        d_act = sm.download(_unbatch(self.state.models.store, model))
        d_stb = sm.download_masked(_unbatch(self.state.models.stable, model))
        return {k: np.concatenate([d_stb[k], d_act[k]], axis=0) for k in d_act}
