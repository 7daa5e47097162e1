"""The CoFusion engine — PyTorch counterpart of cofusion_tpu/engine.py for the
`-static` (ElasticFusion) mode and the multi-model mode with ground-truth
masks or motion-cue CRF segmentation (Core/CoFusion.cpp processFrame
:171-524, spawnObjectModel :588-597, inactivateModel :612-626), with fern
relocalisation ('-rl', CoFusion.cpp:301-338), local loop closure with
the deformation graph ('-cl', CoFusion.cpp:387-459), ground-truth poses
('-p', CoFusion.cpp:340-343: `_step_gt_pose`), hot tuning (`set_params`,
`set_confidence_threshold`) and the rendered views of the '-en'/'-ev'
exports (`render_views`).

One frame (`_step`): bilateral filter (CUDA kernel) -> intensity -> FillIn
of the carried prediction -> frame/model pyramids -> masked batched tracking
of all M model slots (SO(3) pre-align, 3-level ICP+RGB Gauss-Newton; on
the card one CUDA graph replay from the engine's own graph cache `graphs`,
keyed on the shapes and settings it bakes in, eager on the CPU: graphs.py) ->
segmentation and the model lifecycle (spawn, unseen deactivation, smart
delete, slot recycling) -> with '-rl', lost detection, fern keyframing and
recovery -> with '-cl', the global model's local loop (three window
splats: the active view and both tiers' inactive views) and the
deformation of its map and pose log -> per-slot fuse/clean (z-buffer
render, fuse, overlay, clean, expel into the stable tier; on the card one
CUDA graph replay a slot from the same cache, reading and writing the
stacked active tier in place) -> window splat (CUDA kernel)
of the next frame's prediction over all slots at once.  Frame 1 takes
`_init_state`.

The host loop is asynchronous: `process_frame` uploads the frame with a
non-blocking copy and queues the step; nothing in it reads a device value
(no `.item()`, no host branch on a device bool, no data-dependent shape).
Model spawns and deaths flip `active` flags on the device; where the JAX
engine skips an idle slot's fuse/clean, the fern eviction scan or the
deformation with `lax.cond`, the port computes the branch and selects its
result (or the untouched input) with `torch.where`: with '-cl' the whole
deformation runs on every frame.  The CRF path
reads the active flags back every 4 frames through a pinned double buffer,
one cadence late, so no frame waits on the device.  `stats()` and the
pose-log readers synchronise on demand.  The engine's Stopwatch (`sw`)
times each call as `Run` and each stage of the step as a `step.*` section;
with `sw.spans_on` they are also profiler ranges and span records
(utils/stopwatch.py).

A state sharded over a device mesh (`parallel.shard_engine_state`: both
tiers' surfel axes split, everything else whole on the mesh's first device)
takes the same step, its per-surfel passes shard by shard, bit for bit
the unsharded step, with '-rl', '-cl' and `render_views` too: the loop
block samples its graph nodes from both tiers' shards by global rank,
warps and re-stamps each shard on its own device and exchanges the tiers'
rows through the sharded expel and append.

The state keeps the JAX engine's layout — a leading (M,) model axis on every
per-model leaf, the same fields in the same order — so convert.py carries a
JAX state across field for field.  The tick is a host int: the host counts
frames anyway, and a device tick would need a read-back to drive the
stagger phase.  The fuse/clean pass reads a 0-d float32 device copy of
it, written each frame, so a captured pass reads the frame's tick.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from cofusion_tpu_torch.config import (
    CameraConfig, CoFusionConfig, FusionParams, SegmentationParams, TrackingParams,
)
from cofusion_tpu_torch.device import resolve_device, upload
from cofusion_tpu_torch.graphs import StepGraphs
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.models.surfel_model import SurfelStore
from cofusion_tpu_torch.ops import deformation as df
from cofusion_tpu_torch.ops import ferns as fern_ops
from cofusion_tpu_torch.ops import fillin as fi
from cofusion_tpu_torch.ops import fusion as fu
from cofusion_tpu_torch.ops import lie
from cofusion_tpu_torch.ops import local_loop as ll
from cofusion_tpu_torch.ops import odometry as od
from cofusion_tpu_torch.ops import preprocess as pp
from cofusion_tpu_torch.ops import rasterize as rz
from cofusion_tpu_torch.ops import segmentation as sg
from cofusion_tpu_torch.utils.stopwatch import NO_SECTIONS, Stopwatch

# smart delete keeps a deactivated model's map only when it is mature
# (CoFusion.h:384-385: modelKeepMinSurfels, modelKeepConfThreshold): the
# defaults of the step scalars keep_min_surfels and keep_conf_threshold
KEEP_MIN_SURFELS = 4000.0
KEEP_CONF_THRESHOLD = 0.3

class ModelState(NamedTuple):
    """Per-model state; every leaf has a leading (M,) model axis.  `store` is
    the ACTIVE tier (surfels inside the time window), `stable` the
    append-only ring of surfels that aged out of it."""

    store: SurfelStore           # ACTIVE tier, leaves (M, A)
    stable: SurfelStore          # STABLE tier, leaves (M, S)
    pose: torch.Tensor           # (M, 4, 4) model pose (camera-to-model-origin)
    prev_pose: torch.Tensor      # (M, 4, 4) pose at the previous frame
    conf_threshold: torch.Tensor  # (M,)
    max_depth: torch.Tensor      # (M,) per-model fusion depth clamp
    active: torch.Tensor         # (M,) bool
    age: torch.Tensor            # (M,) int32 ticks since spawn
    model_id: torch.Tensor       # (M,) int32 mask label of this model
    unseen: torch.Tensor         # (M,) int32 consecutive frames without segment
    spawn_cooldown: torch.Tensor  # () int32 frames since the last spawn


class EngineState(NamedTuple):
    models: ModelState
    tick: int                    # frames seen (host-side)
    so3_ref: torch.Tensor        # coarsest-level intensity of the previous frame
    icp_error_maps: torch.Tensor  # (M, H, W) per-model ICP error (the CRF's input)
    prev_rgb: torch.Tensor       # (H, W, 3) previous frame rgb (FillIn source)
    prev_filtered: torch.Tensor  # (H, W) previous filtered depth
    prev_mask: torch.Tensor      # (H, W) int32 previous frame's segmentation
    pose_history: torch.Tensor   # (LOG_CAP, M, 4, 4) on-device pose ring
    fern_db: object              # FernDB with '-rl', else a () int32 placeholder
    lost: torch.Tensor           # () bool tracking-lost flag
    unstable_count: torch.Tensor  # () int32
    mask_history: torch.Tensor   # (R, H, W) uint8 segmentation ring ('-es')
    pred: rz.SplatMap            # (M, H, W[, C]) prediction carried to the next frame


class FrameOutputs(NamedTuple):
    """Small per-frame outputs; materialised only on demand."""

    poses: torch.Tensor          # (M, 4, 4)
    icp_error: torch.Tensor      # (M,)
    icp_count: torch.Tensor      # (M,)
    rgb_error: torch.Tensor      # (M,)
    surfel_counts: torch.Tensor  # (M,)
    active: torch.Tensor         # (M,) bool, a buffer of its own (read back)
    spawned: torch.Tensor        # () bool — a new model was created this frame
    loop_closed: torch.Tensor    # () bool — a loop closure deformed the map


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


def _unbatch(tup, m: int = 0):
    return type(tup)(*(a[m] for a in tup))


def _stack1(xs):
    """torch.stack along a new leading axis; a view for one tensor (the
    one-model path launches nothing for it)."""
    return xs[0][None] if len(xs) == 1 else torch.stack(xs)


def _stack(tups):
    """Stack NamedTuples of tensors leaf by leaf along a new leading axis."""
    return type(tups[0])(*(_stack1(leaves) for leaves in zip(*tups)))


def _with_global(first: torch.Tensor, rest: torch.Tensor) -> torch.Tensor:
    """The global slot's map in front of the object slots' (M - 1, ...)."""
    return first[None] if rest.shape[0] == 0 else torch.cat([first[None], rest])


def _select(cond: torch.Tensor, a, b):
    """Leaf-wise torch.where(cond, a, b) of two NamedTuples (device select)."""
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _empty_stores(M: int, capacity: int, dev) -> SurfelStore:
    """(M, capacity) empty stores."""
    return SurfelStore(
        *(torch.zeros((M, capacity), dtype=torch.float32, device=dev) for _ in sm.DATA_FIELDS[:-1]),
        valid=torch.zeros((M, capacity), dtype=torch.bool, device=dev),
        count=torch.zeros((M,), dtype=torch.int32, device=dev),
    )


def _slot0(stores):
    """Slot 0's whole store as a store of its own (views): `_unbatch` of a
    plain store, every shard of a sharded one."""
    return _slot_store(stores, 0, stores.capacity, stores.count[0])


def _with_slot0(stacked, one):
    """`stacked` with slot 0 replaced by `one` (a `_slot0` layout), copied
    in place into the stacked leaves, shard by shard where sharded: the
    leaves keep their addresses, which the fuse/clean graphs read."""
    _write_slot(stacked, 0, one)
    stacked.count[0].copy_(one.count)
    return stacked


FERN_FACTOR = 8  # fern maps at 1/8 resolution


class FernCandidate(NamedTuple):
    """A healthy fern match: a constraint source for the deformation."""

    ok: torch.Tensor     # () bool
    est: torch.Tensor    # (4, 4) the pose it recovers
    src: torch.Tensor    # (K, 3) constraints (fern_ops.sample_constraints)
    tgt: torch.Tensor
    valid: torch.Tensor  # (K,)
    time: torch.Tensor   # () the keyframe's tick, where its constraints anchor


def _relocalise(state: EngineState, A0, pose0, rgb, filtered, cam, cfg, tparams, fparams, tick,
                graphs=None):
    """Lost detection, fern keyframing and recovery of the global model
    (CoFusion.cpp:301-338, Ferns).  `A0` is its final GN system, `pose0` its
    tracked pose.  Returns (pose0, lost, unstable_count, fern_db,
    FernCandidate)."""
    dev = rgb.device
    depth_cutoff = fparams["depth_cutoff"]
    # lost: a covariance axis (diag A^-1) above threshold for > 10 frames in
    # a row; A scales ~1/stride^2 with the level-0 GN stride, so does the bar
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    cov = torch.diagonal(torch.linalg.inv_ex(A0 + 1e-9 * eye6, check_errors=False).inverse)
    unstable = (cov > 1e-4 * float(cfg.gn_stride_l0) ** 2).any()
    unstable_count = torch.where(unstable, state.unstable_count + 1, 0).to(torch.int32)
    lost = state.lost | (unstable_count > 10)

    f = FERN_FACTOR
    cam_s = CameraConfig(width=cam.width // f, height=cam.height // f,
                         fx=cam.fx / f, fy=cam.fy / f, cx=cam.cx / f, cy=cam.cy / f)
    rgb_s, d_s = rgb, filtered
    for _ in range(3):
        rgb_s = (rgb_s[0::2, 0::2] + rgb_s[1::2, 0::2] + rgb_s[0::2, 1::2] + rgb_s[1::2, 1::2]) * 0.25
        d_s = d_s[0::2, 0::2]
    vm_s, va_s = pp.compute_vmap(d_s, cam_s, depth_cutoff)
    nm_s, _ = pp.compute_nmap(vm_s, va_s)

    # keyframes while healthy (the reference's processFerns is FIXME-disabled,
    # CoFusion.cpp:496; the machinery is meant to run)
    db, _ = fern_ops.add_frame(state.fern_db, rgb_s, vm_s, nm_s, pose0, tick,
                               threshold=fparams["fern_thresh"], allow=~lost)
    # retrieval, then 20 ICP iterations at fern resolution (its 3e-4 error
    # gate needs them converged)
    match = fern_ops.find_frame(db, rgb_s, vm_s, tick, min_age=fparams["fern_min_age"])
    fern_cfg = cfg.replace(use_so3=False, use_pyramid=False, gn_iters=(20, 0, 0), camera=cam_s,
                           gn_stride_l0=1)
    fern_tp = TrackingParams(icp_weight=100.0, min_correspondences=tparams.min_correspondences)
    intensity_s = pp.rgb_to_intensity(rgb_s)
    fern_frame = od.build_frame_pyramid(torch.where(va_s, d_s, 0.0), intensity_s, cam_s, fern_cfg,
                                        depth_cutoff)
    fern_model = od.build_model_pyramid(
        match.fern_verts, match.fern_norms, match.fern_verts[..., 2] > 0,
        pp.rgb_to_intensity(match.fern_rgb), match.fern_pose, cam_s, fern_cfg,
    )
    fern_res = od.get_incremental_transformation(
        match.fern_pose, fern_frame, fern_model, intensity_s, cam_s, fern_cfg, fern_tp,
        graphs=graphs,
    )
    est = fern_res.pose
    photo = fern_ops.photometric_check(db, vm_s, rgb_s, est, match.fern_pose, match.fern_rgb,
                                       cam_s, depth_cutoff)
    # the inlier bars 1400/2400 are for 80x60 = 4800 probes
    icp_thresh = torch.where(lost, 1400.0, 2400.0) * (cam_s.width * cam_s.height / 4800.0)
    good = (
        match.found
        & (fern_res.icp_error < fparams["fern_icp_thresh"])
        & (fern_res.icp_count > icp_thresh)
        & (photo < fparams["fern_photo_thresh"])
    )
    src, tgt, ok = fern_ops.sample_constraints(db, vm_s, pose0, est, depth_cutoff)
    # fern constraints anchor at the matched KEYFRAME's tick
    # (Deformation.cpp:75-180), so the time-nearest nodes are the old ones
    kf = torch.clamp(match.keyframe, 0, db.codes.shape[0] - 1).reshape(1).to(torch.int64)
    cand = FernCandidate(ok=good & ~lost, est=est, src=src, tgt=tgt, valid=ok,
                         time=db.src_time.index_select(0, kf)[0].to(torch.float32))

    recover = lost & good
    pose0 = torch.where(recover, est, pose0)
    return pose0, lost & ~recover, torch.where(recover, 0, unstable_count), db, cand


def _close_loop(state: EngineState, store0, stable0, pose0, conf0, lost, fern, cam, cfg, tparams,
                fparams, tick, graphs=None):
    """The global model's local loop and the deformation it feeds
    (CoFusion.cpp:387-459).  A healthy fern match (`fern`, None without
    '-rl') takes priority over the local loop as the constraint source of
    the same optimiser.  The deformation (graph solve, both tiers warped,
    timestamps refreshed, stable surfels brought back to the active tier,
    the pose log warped) is computed on every frame and applied where the
    loop is accepted and the solve is sound.  Updates `state.pose_history`
    in place.  Returns (store0, stable0, pose0, closed)."""
    dev = pose0.device
    td, dc = fparams["time_delta"], fparams["depth_cutoff"]
    tickf = float(tick)
    # the ACTIVE view at the post-tracking pose (predict() right before the
    # block, CoFusion.cpp:347) and the INACTIVE one: both tiers' surfels
    # outside the window, z-merged
    act = rz.splat_predict(store0, pose0, cam, cfg, state.tick, td, dc, conf0)
    old = rz.splat_merge(
        rz.splat_predict(store0, pose0, cam, cfg, state.tick, td, dc, conf0, active_window=False),
        rz.splat_predict(stable0, pose0, cam, cfg, state.tick, td, dc, conf0, active_window=False),
    )
    # the gates are tuned for 640x480: inlier counts scale with the pixel
    # count, the covariance with its inverse
    npx_scale = (cam.width * cam.height) / (640.0 * 480.0)
    res = ll.local_loop(
        old, pose0, act, cam, cfg, tparams, state.tick, td, dc, conf0,
        fparams["loop_cov_thresh"] / npx_scale, fparams["loop_err_thresh"],
        fparams["loop_count_thresh"] * npx_scale, graphs=graphs,
    )
    accepted = res.accepted & ~lost & (res.num_constraints >= 3)
    src, tgt, valid, est, times = res.src, res.tgt, res.cons_valid, res.est_pose, None
    C = src.shape[0]
    if fern is not None:
        C = max(C, fern.src.shape[0])

        def pick(a, b):
            pad = lambda x: torch.cat([x, x.new_zeros((C - x.shape[0],) + x.shape[1:])])
            return torch.where(fern.ok, pad(a), pad(b))

        src, tgt, valid = pick(fern.src, src), pick(fern.tgt, tgt), pick(fern.valid, valid)
        est = torch.where(fern.ok, fern.est, est)
        times = torch.where(fern.ok, fern.time, tickf).expand(C)
        accepted = fern.ok | accepted
    if times is None:
        times = torch.full((C,), tickf, device=dev)

    # graph nodes over the WHOLE map's time range (Deformation.cpp:207):
    # the stable tier first (old times), then the active tier
    graph = df.sample_graph_tiers(stable0, store0, cfg.deform_nodes)
    graph, err = df.optimize(graph, src, times, tgt, valid)
    ok = torch.isfinite(err)
    if fern is not None:
        # a fern match takes the reference's meanConsError gate
        # (Deformation.cpp:134); a local match applies as its !fernMatch branch
        mce = df.mean_constraint_error(graph, src, times, tgt, valid)
        ok = ok & (~fern.ok | (mce < 3e-4))
    warped_a = df.refresh_timestamps(df.apply_to_surfels(graph, store0), est, cam, tick, dc, conf0)
    warped_s = df.refresh_timestamps(df.apply_to_surfels(graph, stable0), est, cam, tick, dc, conf0)
    # stable surfels whose stamps were refreshed are back in the window:
    # they move to the active tier (one expel block; overflow drops)
    fresh = sm.per_shard(warped_s, lambda s: s.valid & (s.last_time >= tickf))
    stable_new, blk = sm.expel_split(warped_s, sm.per_shard(warped_s, lambda s: s.valid), fresh,
                                     cfg.expel_block)
    active_new = sm.append(warped_a, blk, blk.valid)

    closed = accepted & ok
    # the logged trajectory warps through the graph too (applyGraphToPoses,
    # DeformationGraph.cpp:89-116): ring slot j last held tick
    # (tick - 1) - ((tick - 2 - j) mod cap); unwritten slots warp to junk
    # that is never read
    cap = cfg.max_log_frames
    j = torch.arange(cap, device=dev)
    hist_t = ((tick - 1) - torch.remainder(tick - 2 - j, cap)).to(torch.float32)
    hist0 = state.pose_history[:, 0]
    hist0.copy_(torch.where(closed, df.apply_to_poses(graph, hist0, hist_t), hist0))
    return (sm.select(closed, active_new, store0), sm.select(closed, stable_new, stable0),
            torch.where(closed, est, pose0), closed)


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
    sparams: SegmentationParams | None = None,
    use_crf: bool = False,
    use_reloc: bool = False,
    close_loops: bool = False,
    use_gt_pose: bool = False,
    sw=NO_SECTIONS,
    graphs=None,
):
    """One frame (CoFusion::processFrame).

    `fparams` holds the run-time scalars as Python numbers: depth_cutoff,
    outlier_coeff, icp_weight, time_delta, weight_multiplier, ftf ('-ftf',
    default off); with max_models > 1 also the lifecycle's spawn_offset,
    conf_object, deactivate_count, keep_data, keep_min_surfels and
    keep_conf_threshold (default the reference's), and the host's GT-mask
    nominations new_slot, allow_new, gt_masks; with `use_reloc` ('-rl')
    fern_min_age, fern_icp_thresh, fern_photo_thresh, fern_thresh; with
    `close_loops` ('-cl') loop_cov_thresh, loop_err_thresh,
    loop_count_thresh.  `use_crf` selects the CRF segmentation over the
    slot-id `mask`.  `use_gt_pose` ('-p') takes `_step_gt_pose` with the
    (4, 4) device pose `fparams["gt_pose"]`.  `sw` (the engine's
    Stopwatch) times the step's stages as `step.*` sections; `graphs` (the
    engine's `graphs.StepGraphs`) replays every tracking solve of the step
    and each slot's fuse/clean pass as a CUDA graph on a CUDA device.

    The step consumes its input state: the stores, the stable tier and the
    pose and mask rings are updated in place (the JAX engine donates its
    state to the step the same way); everything else is rebuilt."""
    M = cfg.max_models
    multi = M > 1
    tick = state.tick + 1
    models = state.models
    dev = rgb.device
    depth_cutoff = fparams["depth_cutoff"]
    if isinstance(models.store, sm.ShardedStore) and models.store.count.device != dev:
        raise ValueError(f"the state is sharded from {models.store.count.device}, "
                         f"the frame is on {dev}")

    # --- preprocess
    with sw.section("step.preprocess"):
        intensity = pp.rgb_to_intensity(rgb)
        filtered = pp.bilateral_filter(depth, depth_cutoff)
        if not use_gt_pose:
            # --- FillIn of the global model's carried prediction
            # (CoFusion.cpp:541): previous raw frame into prediction holes;
            # geometry passes through raw while lost, the image also under
            # '-ftf' (Model::performFillIn, Model.cpp:901-910)
            splat = state.pred
            filled = fi.fill_in(
                _unbatch(splat), state.prev_rgb, state.prev_filtered, cam, depth_cutoff,
                passthrough_geom=state.lost,
                passthrough_rgb=(state.lost | True) if fparams.get("ftf") else state.lost,
            )
            pred_vert = _with_global(filled.vert, splat.vert_conf[1:, ..., :3])
            pred_norm = _with_global(filled.normal, splat.normal_rad[1:, ..., :3])
            pred_valid = _with_global(filled.valid, splat.valid[1:])
            pred_image = _with_global(filled.image, splat.image[1:])
    if use_gt_pose:
        return _step_gt_pose(state, rgb, depth, mask, filtered, intensity, fparams,
                             cam=cam, cfg=cfg, tick=tick, sw=sw, graphs=graphs)

    with sw.section("step.tracking"):
        # --- tracking pyramids: one shared frame pyramid, per-model mask gates
        frame_pyr = od.build_frame_pyramid(
            filtered, intensity, cam, cfg, depth_cutoff, tparams.max_depth_rgb
        )
        pyrs = [
            od.build_model_pyramid(
                pred_vert[m], pred_norm[m], pred_valid[m], pp.rgb_to_intensity(pred_image[m]),
                models.pose[m], cam, cfg, tparams.max_depth_rgb,
            )
            for m in range(M)
        ]
        mpyr_b = od.ModelPyramid(*(tuple(_stack1(lv) for lv in zip(*field))
                                   for field in zip(*pyrs)))
        if multi:
            # GT masks exist before tracking; the CRF mask lags one frame (the
            # reference's MASK texture still holds frame t-1's result)
            track_mask = mask if fparams["gt_masks"] else state.prev_mask
            mask_pyrs = [track_mask]
            for _ in range(cfg.pyramid_levels - 1):
                mask_pyrs.append(pp.pyr_down_nearest(mask_pyrs[-1]))
            valid_b, rgb_ok_b = od.masked_validity_b(
                frame_pyr, mask_pyrs, od.mask_window_bounds(mask_pyrs), models.model_id
            )
        else:
            valid_b = tuple(v[None] for v in frame_pyr.valid)
            rgb_ok_b = tuple(v[None] for v in frame_pyr.rgb_ok)
        res = od.track_models(
            models.pose, frame_pyr, valid_b, rgb_ok_b, mpyr_b, state.so3_ref,
            cam, cfg, tparams, icp_weight=fparams["icp_weight"], graphs=graphs,
        )
        # inactive slots keep their pose and report identity/zero stats
        act = models.active
        act3 = act[:, None, None]
        eye6 = torch.eye(6, dtype=torch.float32, device=dev)[None]
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
    with sw.section("step.segmentation"):
        if use_crf:
            seg_err_maps = od.icp_error_maps_b(
                new_pose, models.pose, frame_pyr.vmap[0], frame_pyr.nmap[0],
                frame_pyr.valid[0], mpyr_b, cam, tparams, stride=cfg.gn_stride_l0,
            )
            seg_err_maps = torch.where(act3, seg_err_maps, 0.0)
        else:
            seg_err_maps = state.icp_error_maps  # zeros, carried

        # --- segmentation + model lifecycle (CoFusion.cpp:243-298)
        new_conf_threshold = models.conf_threshold
        models_store, models_stable = models.store, models.stable
        if multi:
            slot_ids = torch.arange(M, dtype=torch.int32, device=dev)
            if use_crf:
                # the device picks the spawn slot: the first inactive slot > 0,
                # slots still holding a kept ('-keep') map last
                inactive = ~models.active & (slot_ids > 0)
                slot_empty = (models.store.count + models.stable.count) == 0
                pref = inactive & slot_empty
                new_slot = torch.where(
                    pref.any(), torch.argmax(pref.to(torch.int32)),
                    torch.argmax(inactive.to(torch.int32)),
                ).to(torch.int32)
                allow_new = inactive.any() & (models.spawn_cooldown >= fparams["spawn_offset"])
                seg = sg.perform_segmentation_crf(
                    rgb, depth, seg_err_maps, splat.vert_conf[..., 3], models.active,
                    torch.clamp(new_slot, 0, M - 1), allow_new, cam, cfg, sparams,
                )
                mask = seg.full_segmentation
                counts = seg.superpixel_count
                has_new = seg.has_new_label
                dmean, dstd = seg.depth_mean, seg.depth_std
                # rising object confidence thresholds (CoFusion.cpp:293-298)
                new_conf_threshold = torch.where(
                    slot_ids > 0,
                    torch.clamp(torch.maximum(models.conf_threshold, seg.avg_conf), max=9.0),
                    models.conf_threshold,
                )
                slot_free = ~sg.take_at(models.active, torch.clamp(new_slot, 0, M - 1))
                has_new = has_new & (new_slot >= 0) & slot_free
            else:
                new_slot = fparams["new_slot"]  # host nomination, -1 = none
                counts = sg.count_ids(mask, M)
                has_new = (
                    (models.spawn_cooldown >= fparams["spawn_offset"])
                    & (counts[min(max(new_slot, 0), M - 1)] > 0)
                    & ~models.active[min(max(new_slot, 0), M - 1)]
                )
                has_new = has_new & bool(fparams["allow_new"] and new_slot >= 0)
                dmean, dstd, _ = sg.gt_mask_stats(mask, depth, M)
            is_new_slot = (slot_ids == new_slot) & has_new
            active_fuse = models.active | is_new_slot
            # unseen-count deactivation (CoFusion.cpp:284-291)
            miss = models.active & (slot_ids > 0) & (counts == 0)
            new_unseen = torch.where(miss, models.unseen + 1, 0)
            deactivate = new_unseen >= fparams["deactivate_count"]
            # smart delete (inactivateModel, CoFusion.cpp:612-626): a deactivated
            # map is kept when mature, or always under '-keep'; wiped slots also
            # skip this frame's fuse
            if fparams["keep_data"]:
                kept = torch.ones((M,), dtype=torch.bool, device=dev)
            else:
                total_count = models.store.count + models.stable.count
                min_surfels = fparams.get("keep_min_surfels", KEEP_MIN_SURFELS)
                min_conf = fparams.get("keep_conf_threshold", KEEP_CONF_THRESHOLD)
                kept = ((total_count.to(torch.float32) >= min_surfels)
                        & (models.conf_threshold > min_conf))
            wipe = deactivate & ~kept & (slot_ids > 0)
            active_fuse = active_fuse & ~wipe
            new_active = active_fuse & ~deactivate
            new_cooldown = torch.where(has_new, 0,
                                       torch.clamp(models.spawn_cooldown + 1, max=10000))
            # per-model fusion depth clamp = depthMean + 1.2 * depthStd (CoFusion.cpp:228)
            model_max_depth = torch.where(
                (slot_ids > 0) & active_fuse & (dmean > 0), dmean + 1.2 * dstd, depth_cutoff
            )
            # the just-spawned model fuses with weight multiplier 100 (CoFusion.cpp:268)
            wmult = torch.where(is_new_slot, 100.0, fparams["weight_multiplier"])

            # slot recycling (spawnObjectModel, CoFusion.cpp:588-597): a spawned
            # or smart-deleted slot starts empty at IDENTITY pose (Model.cpp:108;
            # its map lives in the spawn-frame camera coordinates) with the
            # initial object threshold
            rs = is_new_slot | wipe
            models_store = _reset_slots(models_store, rs)
            models_stable = _reset_slots(models_stable, rs)
            eye4 = torch.eye(4, dtype=new_pose.dtype, device=dev)[None]
            new_pose = torch.where(rs[:, None, None], eye4, new_pose)
            new_conf_threshold = torch.where(rs, fparams["conf_object"], new_conf_threshold)
            new_age = torch.where(is_new_slot, 0, models.age) + new_active.to(torch.int32)
        else:
            # the global model alone: always active, fused at the run's depth cutoff
            active_fuse = new_active = models.active
            has_new = torch.zeros((), dtype=torch.bool, device=dev)
            model_max_depth = torch.full((M,), depth_cutoff, dtype=torch.float32, device=dev)
            new_unseen = models.unseen
            new_cooldown = models.spawn_cooldown
            new_age = models.age + new_active.to(torch.int32)

    # --- relocalisation ('-rl'): the global model's pose may be recovered;
    # every slot's fusion pauses while lost (CoFusion.cpp:463)
    fern_db, lost, unstable_count, fern = state.fern_db, state.lost, state.unstable_count, None
    if use_reloc:
        with sw.section("step.reloc"):
            pose0, lost, unstable_count, fern_db, fern = _relocalise(
                state, res.A[0], new_pose[0], rgb, filtered, cam, cfg, tparams, fparams, tick,
                graphs,
            )
        new_pose = _with_global(pose0, new_pose[1:])
        active_fuse = active_fuse & ~lost

    # --- local loop closure and deformation of the global model ('-cl')
    loop_closed = torch.zeros((), dtype=torch.bool, device=dev)
    if close_loops:
        with sw.section("step.loop"):
            store0, stable0, pose0, loop_closed = _close_loop(
                state, _slot0(models_store), _slot0(models_stable), new_pose[0],
                models.conf_threshold[0], lost, fern, cam, cfg, tparams, fparams, tick, graphs,
            )
        models_store = _with_slot0(models_store, store0)
        models_stable = _with_slot0(models_stable, stable0)
        new_pose = _with_global(pose0, new_pose[1:])

    # --- fuse + clean; a just-spawned slot counts as motionless (its
    # velocity weight is the wmult=100 bootstrap)
    if multi:
        prev_pose_eff = torch.where(is_new_slot[:, None, None], new_pose, models.pose)
        weight = [_fusion_weight(new_pose[m], prev_pose_eff[m], wmult[m]) for m in range(M)]
    else:
        prev_pose_eff = models.pose
        weight = [_fusion_weight(new_pose[0], models.pose[0], fparams["weight_multiplier"])]
    with sw.section("step.fuse_clean"):
        new_stores, new_stables, imap_b = _fuse_clean_all(
            models_store, models_stable, new_pose, weight, models.model_id, models.conf_threshold,
            active_fuse, model_max_depth, depth, filtered, rgb, mask if multi else None,
            cam, cfg, tick, fparams, global_may_idle=use_reloc, sw=sw, graphs=graphs,
        )
    # the next frame's prediction: one batched window splat over the
    # post-fuse renders, confidence-gated per model (splat.vert:58)
    with sw.section("step.predict"):
        pred_new = rz.splat_from_imap(imap_b, cam, cfg, conf_threshold=new_conf_threshold)

    new_models = ModelState(
        store=new_stores,
        stable=new_stables,
        pose=new_pose,
        prev_pose=prev_pose_eff,
        conf_threshold=new_conf_threshold,
        max_depth=model_max_depth,
        active=new_active,
        age=new_age,
        model_id=models.model_id,
        unseen=new_unseen,
        spawn_cooldown=new_cooldown,
    )
    state.pose_history[(tick - 1) % cfg.max_log_frames] = new_pose
    state.mask_history[(tick - 1) % cfg.mask_ring_frames] = mask.to(torch.uint8)
    with sw.section("step.preprocess"):
        so3_ref = _so3_ref(intensity, cfg)
    new_state = EngineState(
        models=new_models,
        tick=tick,
        so3_ref=so3_ref,
        icp_error_maps=seg_err_maps,
        prev_rgb=rgb,
        prev_filtered=filtered,
        prev_mask=mask,
        pose_history=state.pose_history,
        fern_db=fern_db,
        lost=lost,
        unstable_count=unstable_count,
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
        spawned=has_new,
        loop_closed=loop_closed,
    )
    return new_state, outputs


def _so3_ref(intensity: torch.Tensor, cfg: CoFusionConfig) -> torch.Tensor:
    """The coarsest pyramid level of the frame's intensity: the next frame's
    SO(3) pre-alignment reference."""
    for _ in range(cfg.pyramid_levels - 1):
        intensity = pp.pyr_down_gauss(intensity)
    return intensity


def _step_gt_pose(state: EngineState, rgb, depth, mask, filtered, intensity, fparams, *,
                  cam: CameraConfig, cfg: CoFusionConfig, tick: int, sw=NO_SECTIONS,
                  graphs=None):
    """'-p' ground-truth pose frame (CoFusion.cpp:340-343): tracking,
    segmentation, relocalisation and loop closure are skipped; the global
    pose is the given one and every active model fuses and cleans at its
    current pose.  Nothing reads the prediction on this path, so the window
    splat stays off it and `state.pred` is carried through unchanged."""
    M = cfg.max_models
    models = state.models
    dev = rgb.device
    new_pose = _with_global(fparams["gt_pose"], models.pose[1:])
    weight = [_fusion_weight(new_pose[m], models.pose[m], fparams["weight_multiplier"])
              for m in range(M)]
    model_max_depth = torch.full((M,), fparams["depth_cutoff"], dtype=torch.float32, device=dev)
    with sw.section("step.fuse_clean"):
        new_stores, new_stables, _ = _fuse_clean_all(
            models.store, models.stable, new_pose, weight, models.model_id, models.conf_threshold,
            models.active, model_max_depth, depth, filtered, rgb, mask if M > 1 else None,
            cam, cfg, tick, fparams, sw=sw, graphs=graphs,
        )
    new_models = models._replace(
        store=new_stores,
        stable=new_stables,
        pose=new_pose,
        prev_pose=models.pose,
        max_depth=model_max_depth,
        age=models.age + models.active.to(torch.int32),
        spawn_cooldown=torch.clamp(models.spawn_cooldown + 1, max=10000),
    )
    state.pose_history[(tick - 1) % cfg.max_log_frames] = new_pose
    state.mask_history[(tick - 1) % cfg.mask_ring_frames] = mask.to(torch.uint8)
    with sw.section("step.preprocess"):
        so3_ref = _so3_ref(intensity, cfg)
    new_state = state._replace(
        models=new_models,
        tick=tick,
        so3_ref=so3_ref,
        icp_error_maps=torch.zeros((M,) + cam.shape, dtype=torch.float32, device=dev),
        prev_rgb=rgb,
        prev_filtered=filtered,
        prev_mask=mask,
    )
    zm = torch.zeros((M,), dtype=torch.float32, device=dev)
    no = torch.zeros((), dtype=torch.bool, device=dev)
    outputs = FrameOutputs(
        poses=new_pose,
        icp_error=zm,
        icp_count=zm,
        rgb_error=zm,
        surfel_counts=new_stores.count + torch.clamp(new_stables.count, max=new_stables.capacity),
        active=models.active.clone(),
        spawned=no,
        loop_closed=no,
    )
    return new_state, outputs


def _reset_slots(stores, rs: torch.Tensor):
    """Empty the slots of the (M, N) stores where `rs` holds (valid false,
    count 0) in place, shard by shard where sharded; returns the stores."""
    for sh in sm.shards_of(stores)[0]:
        sh.valid.bitwise_and_(~sm.to_device(rs, sh.px.device)[:, None])
    stores.count.masked_fill_(rs, 0)
    return stores


def _slot_store(stores, m: int, cap: int, count):
    """Slot m's rows [:cap] of the (M, N) stores as a store of its own
    (views); of a sharded store, the shards that reach into the slice."""
    if not isinstance(stores, sm.ShardedStore):
        return SurfelStore(*(getattr(stores, f)[m, :cap] for f in sm.DATA_FIELDS), count=count)
    shards = tuple(
        SurfelStore(*(getattr(sh, f)[m, :min(sh.capacity, cap - off)] for f in sm.DATA_FIELDS),
                    count=None)
        for sh, off in zip(stores.shards, stores.offsets) if off < cap
    )
    return sm.ShardedStore(shards, count)


def _write_slot(stores, m: int, out) -> None:
    """Copy a slot's new rows (a `_slot_store` layout) into the (M, N)
    stores in place."""
    for dst, src in zip(sm.shards_of(stores)[0], sm.shards_of(out)[0]):
        for f in sm.DATA_FIELDS:
            getattr(dst, f)[m, :src.capacity].copy_(getattr(src, f))


def _empty_imap(H: int, W: int, dev) -> rz.IndexMap:
    """An empty index render, every field a tensor of its own."""
    def z(*tail):
        return torch.zeros((H, W) + tail, dtype=torch.float32, device=dev)

    return rz.IndexMap(
        index=torch.full((H, W), -1, dtype=torch.int32, device=dev),
        vert_conf=z(4), normal_rad=z(4), color_time=z(4), last_time=z(),
        valid=torch.zeros((H, W), dtype=torch.bool, device=dev),
    )


# what an idle slot's pass returns, leaf by leaf: an empty expel block and
# an empty index render
_NO_BLOCK = SurfelStore(*(0.0 for _ in sm.DATA_FIELDS[:-1]), valid=False, count=0)
_NO_IMAP = rz.IndexMap(index=-1, vert_conf=0.0, normal_rad=0.0, color_time=0.0, last_time=0.0,
                       valid=False)


class SlotInputs(NamedTuple):
    """What one slot's fuse/clean pass reads besides the stacked stores:
    tensors, or None where the pass does without (`model_id` without a
    mask, `on` where the slot always fuses); `max_depth` is the run's depth
    cutoff (a Python float) with one slot."""

    pose: torch.Tensor            # (4, 4)
    weight: torch.Tensor          # () fusion weight
    model_id: torch.Tensor | None  # () int32 mask label
    conf_threshold: torch.Tensor  # ()
    on: torch.Tensor | None       # () bool: the slot fuses this frame
    max_depth: object             # () tensor, or a Python float
    depth: torch.Tensor           # (H, W) raw depth
    filtered: torch.Tensor        # (H, W) bilateral-filtered depth
    rgb: torch.Tensor             # (H, W, 3)
    mask: torch.Tensor | None     # (H, W) int32 slot-id segmentation
    tick: torch.Tensor            # () float32


def _fuse_clean_slot(stores, m: int, x: SlotInputs, *, cam, cfg, phase: int, time_delta,
                     outlier_coeff):
    """Slot m's pass: z-buffer render, fuse, overlay, clean, age-out and
    expel, the idle select (where `x.on` is given), and the slot's new rows
    and count written back into the stacked `stores` in place.  Returns
    (expel block, post-fuse index render).  `phase` is the tick's parity
    (the stagger phase of `fuse`)."""
    A = stores.capacity
    cap = A if m == 0 else min(cfg.object_active_capacity, A)
    count = stores.count[m] if m == 0 else torch.clamp(stores.count[m], max=cap)
    store = _slot_store(stores, m, cap, count)
    tick, max_d = x.tick, x.max_depth
    fs = fu.make_frame_surfels(x.depth, x.filtered, x.rgb, cam, x.weight, max_d)
    mask_ok = (
        torch.ones(cam.shape, dtype=torch.bool, device=x.depth.device) if x.mask is None
        else x.mask == x.model_id
    )
    imap = rz.predict_indices(store, x.pose, cam, tick, time_delta, max_d)
    fused, aux = fu.fuse(
        store, fs, x.depth, imap, mask_ok, x.pose, cam, cfg, tick, max_d, return_aux=True,
        phase=phase,
    )
    imap2 = fu.overlay_imap(fused, imap, aux, fs, x.pose, cam, tick)
    cleaned, keep = fu.clean_eval(
        fused, imap2, x.filtered, x.pose, cam, tick, time_delta, x.conf_threshold, outlier_coeff,
        mask=x.mask, mask_id=x.model_id,
    )
    # age-out migration: surfels past the window move to the stable tier
    aged = sm.per_shard(
        cleaned,
        lambda s: (s.last_time > 0)
        & ((sm.to_device(tick, s.px.device) - s.last_time) > float(time_delta)),
    )
    out, blk = sm.expel_split(cleaned, keep, aged, cfg.expel_block)
    if x.on is not None:
        out = sm.select(x.on, out, store)
        blk = _select(x.on, blk, _NO_BLOCK)
        imap2 = _select(x.on, imap2, _NO_IMAP)
    _write_slot(stores, m, out)
    stores.count[m].copy_(out.count)
    return blk, imap2


def _fuse_clean_all(
    stores, stables, new_pose, weight, model_ids, conf_thresholds, active_fuse,
    model_max_depth, depth, filtered, rgb, mask, cam, cfg, tick: int, fparams,
    global_may_idle: bool = False, sw=NO_SECTIONS, graphs=None,
):
    """Per-model fuse + clean (CoFusion.cpp:463-489: predictIndices -> fuse
    -> overlay in place of the second predictIndices -> clean), plus the
    two-tier step: survivors that aged out of the time window move to the
    stable tier.  `mask` is the frame's slot-id segmentation (None: one
    unmasked model).  Returns (active stores, new stable stores, post-fuse
    index renders (M, H, W, ...)).

    The model axis is unrolled: one `_fuse_clean_slot` pass a slot, which
    writes the slot's new rows and count into the stacked `stores` in
    place (so the active stores returned are `stores`).  Object slots
    (m > 0) run on the [:object_active_capacity] slice of the stacked store
    (an object's surface is a small part of the background's; rows past the
    slice are never valid).  An object slot that does not fuse this frame
    (inactive, or smart-deleted) is computed all the same and selected back
    on the device: the untouched store, an empty expel block and an empty
    index map (the JAX engine skips it with `lax.cond`; a host branch here
    would read `active_fuse` back).  Slot 0, the global model, always fuses,
    unless `global_may_idle` (relocalisation: fusion pauses while lost).
    `weight` is a list of per-slot 0-d weights.  The pass reads the tick as
    a 0-d float32 tensor on `depth`'s device.  `sw` times each slot's pass
    as `step.fuse_clean.slot<m>`; `graphs` (the engine's graph cache)
    replays each slot's pass as a CUDA graph on a CUDA device, one family
    per slot and settings with the stagger phase as its variant, reading
    and writing `stores` in place; a sharded store's passes run eagerly.

    Sharded stores (cofusion_tpu_torch/parallel) take the same route: each
    op renders, fuses, cleans and compacts shard by shard and combines on
    `depth`'s device.  Under block ownership an object slot's
    [:object_active_capacity] rows live in the first shard(s), as under the
    JAX package's P(None, "d"), so those shards do the object slots' work
    and the others idle through it."""
    M = int(new_pose.shape[0])
    dev = depth.device
    tick_t = torch.full((), float(tick), dtype=torch.float32, device=dev)
    statics = dict(cam=cam, cfg=cfg, time_delta=fparams["time_delta"],
                   outlier_coeff=fparams["outlier_coeff"])
    sharded = isinstance(stores, sm.ShardedStore)
    blks, imaps = [], []
    for m in range(M):
        with sw.section(f"step.fuse_clean.slot{m}"):
            may_idle = m > 0 or global_may_idle
            x = SlotInputs(
                pose=new_pose[m], weight=weight[m],
                model_id=None if mask is None else model_ids[m],
                conf_threshold=conf_thresholds[m], on=active_fuse[m] if may_idle else None,
                max_depth=model_max_depth[m] if M > 1 else fparams["depth_cutoff"],
                depth=depth, filtered=filtered, rgb=rgb, mask=mask, tick=tick_t,
            )
            slot_pass = functools.partial(_fuse_clean_slot, stores, m, phase=tick % 2, **statics)
            if graphs is None:
                blk, imap2 = slot_pass(x)
            else:
                # the outputs are consumed within the frame: not cloned
                blk, imap2 = graphs.run("fuse_clean", slot_pass, x, (m, *statics.items()),
                                        in_place=stores, variant=tick % 2, capture=not sharded)
            blks.append(blk)
            imaps.append(imap2)
    return stores, _append_expel_blocks(stables, _stack(blks), cfg), _stack(imaps)


def _append_expel_blocks(stables, blks: SurfelStore, cfg):
    """Append each model's expel block into its stable ring with one
    contiguous write per attribute, IN PLACE.  `count` is the monotone
    total-appended cursor and the write offset is count mod S; when the tail
    is shorter than a block the cursor skips to the next S boundary, so on
    overflow the oldest rows are overwritten round-robin.  The offset is
    device index arithmetic (`off + arange(B)`), never read back; when
    nothing is expelled the window is written back unchanged.

    Into a sharded ring the B rows may straddle shards: each shard writes
    at its local rows clamped into its range, so the rows outside it land
    on its first or last row with that row's own new value (the run's row
    there, or the old one), and duplicate writes agree."""
    M = int(stables.count.shape[0])
    S = int(stables.capacity)
    B = int(cfg.expel_block)
    sharded = isinstance(stables, sm.ShardedStore)
    shards, offsets = sm.shards_of(stables)
    counts = []
    for m in range(M):
        n_ex = blks.count[m].to(torch.int64)
        cursor = stables.count[m].to(torch.int64)
        off_raw = torch.remainder(cursor, S)
        base = torch.where(off_raw + B > S, cursor - off_raw + S, cursor)
        r0 = torch.remainder(base, S)
        rows_at = r0 + torch.arange(B, device=cursor.device)
        write = n_ex > 0
        for sh, off in zip(shards, offsets):
            dk = sh.px.device
            at, wr = sm.to_device(rows_at, dk), sm.to_device(write, dk)
            if sharded:
                at = torch.clamp(at - off, 0, sh.capacity - 1)
                run = at + off - sm.to_device(r0, dk)  # each row's place in the block
                in_run = (run >= 0) & (run < B)
                src = torch.clamp(run, 0, B - 1)
            for f in sm.DATA_FIELDS:
                leaf = getattr(sh, f)[m]
                old = leaf.index_select(0, at)
                new = sm.to_device(getattr(blks, f)[m], dk)
                if sharded:
                    rows = torch.where(in_run, torch.where(wr, new.index_select(0, src), old), old)
                else:
                    rows = torch.where(wr, new, old)
                leaf.index_copy_(0, at, rows)
        counts.append(torch.where(write, base + n_ex, cursor).to(torch.int32))
    return stables._replace(count=torch.stack(counts))


# ---------------------------------------------------------------------------
# host-side engine


class _ActiveReadback:
    """Double-buffered read-back of the (M,) active flags: `start` begins a
    non-blocking device->host copy into one of two pinned buffers and
    returns its handle; `finish(handle)` returns the flags as numpy, waiting
    only if the copy has not landed yet (one cadence later it has)."""

    def __init__(self, M: int, device: torch.device):
        self.cuda = device.type == "cuda"
        pin = dict(pin_memory=True) if self.cuda else {}
        self.bufs = [torch.zeros((M,), dtype=torch.bool, **pin) for _ in range(2)]
        self.next = 0

    def start(self, active: torch.Tensor):
        buf = self.bufs[self.next]
        self.next ^= 1
        buf.copy_(active, non_blocking=self.cuda)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        return buf, event

    @staticmethod
    def finish(handle) -> np.ndarray:
        buf, event = handle
        if event is not None and not event.query():
            event.synchronize()
        return buf.numpy().copy()


class CoFusion:
    """Host-side engine wrapper (the reference's CoFusion class, minus GL).
    `device` is required: the engine never picks one."""

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
        self.cfg = cfg
        self.cam = cfg.camera
        self.device = resolve_device(device)
        self.tracking = tracking or TrackingParams()
        self.fusion = fusion_params or FusionParams()
        self.segmentation = SegmentationParams()
        self.enable_multi_model = enable_multi_model
        self.enable_relocalization = enable_relocalization
        self.close_loops = close_loops
        self.frame_to_frame_rgb = frame_to_frame_rgb
        # '-keep': keep deactivated models' maps unconditionally; otherwise
        # smart delete keeps only mature ones (CoFusion.cpp:612-626)
        self.keep_models = keep_models
        self.sw = Stopwatch()
        self.graphs = StepGraphs(cfg.max_models)
        self.state: EngineState | None = None
        self._timestamps: list[int] = []
        self._flushed_poses: list[np.ndarray] = []
        self._last_outputs: FrameOutputs | None = None
        self._gt_mapper = sg.GtMaskMapper()
        self._used_slots: set[int] = {0}
        self._ever_active: set[int] = {0}
        # host mirror of per-slot consecutive-unseen counts (GT-mask path)
        self._host_unseen: dict[int, int] = {}
        # lifecycle listeners (CoFusion.h:286-289), called with the slot id;
        # GT-mask events fire at once, CRF events at the active-flag read-back
        self._new_model_listeners: list = []
        self._inactive_model_listeners: list = []
        self._active_snapshot: set[int] = {0}
        self._last_segmentation: np.ndarray | None = None
        # host mirror of the device's spawn_cooldown: the GT-mask path
        # commits a mask-id -> slot mapping only on frames where the device
        # accepts the spawn (the reference records it only when allowNew,
        # Segmentation.cpp:86-90 + CoFusion.cpp:112)
        self._host_cooldown = 0
        self._seg_from_host = False
        self._masks_drained = 0
        self._sync_cadence = 4
        self._frames_since_sync = 0
        self._readback = _ActiveReadback(cfg.max_models, self.device)
        self._pending_active = None
        self._lifecycle_dirty = False
        # run-time scalars stay Python numbers: the kernels take them by value
        # and no per-frame host->device scalar copy is queued; set_params()
        # changes them between frames
        f = self.fusion
        self._fparams = dict(
            depth_cutoff=float(f.depth_cutoff),
            outlier_coeff=float(f.outlier_coefficient),
            icp_weight=float(self.tracking.icp_weight),
            time_delta=int(cfg.time_delta),
            ftf=bool(frame_to_frame_rgb),
            spawn_offset=int(f.model_spawn_offset),
            conf_object=float(f.confidence_object),
            deactivate_count=int(f.model_deactivate_count),
            keep_data=bool(keep_models),
            keep_min_surfels=KEEP_MIN_SURFELS,
            keep_conf_threshold=KEEP_CONF_THRESHOLD,
            fern_min_age=int(f.fern_min_age),
            fern_icp_thresh=float(f.fern_icp_error_thresh),
            fern_photo_thresh=float(f.fern_photo_thresh),
            fern_thresh=float(f.fern_thresh),
            loop_cov_thresh=float(f.local_loop_cov_thresh),
            loop_err_thresh=float(f.local_loop_err_thresh),
            loop_count_thresh=float(f.local_loop_count_thresh),
        )
        # hot overrides of the CRF scalars, applied over `self.segmentation`
        # (which the CLI sets after construction) on every frame
        self._hot_crf: dict[str, float] = {}

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
        empty = _empty_stores(M, cfg.active_capacity, dev)
        stores = SurfelStore(*(torch.cat([a[None], b[1:]]) for a, b in zip(store0, empty)))
        slot_ids = torch.arange(M, dtype=torch.int32, device=dev)
        models = ModelState(
            store=stores,
            stable=_empty_stores(M, cfg.max_surfels, dev),
            pose=eye4.expand(M, 4, 4).clone(),
            prev_pose=eye4.expand(M, 4, 4).clone(),
            conf_threshold=torch.where(
                slot_ids == 0, float(fp.confidence_global), float(fp.confidence_object)
            ).to(torch.float32),
            max_depth=torch.full((M,), fp.depth_cutoff, dtype=torch.float32, device=dev),
            active=slot_ids == 0,
            age=torch.zeros((M,), dtype=torch.int32, device=dev),
            model_id=slot_ids,
            unseen=torch.zeros((M,), dtype=torch.int32, device=dev),
            spawn_cooldown=torch.zeros((), dtype=torch.int32, device=dev),
        )
        # seed the carried prediction with a one-off render of the new map
        pred = _render_pred_init(
            models.store, models.pose, models.conf_threshold, 1, cfg.time_delta,
            models.max_depth, cam=cam, cfg=cfg,
        )
        return EngineState(
            models=models,
            tick=1,
            so3_ref=_so3_ref(intensity, cfg),
            icp_error_maps=torch.zeros((M,) + cam.shape, dtype=torch.float32, device=dev),
            prev_rgb=rgb,
            prev_filtered=filtered,
            prev_mask=mask,
            pose_history=eye4.expand(cfg.max_log_frames, M, 4, 4).clone(),
            fern_db=(
                fern_ops.new_db(cam, max_depth_mm=fp.depth_cutoff * 1000.0, device=dev)
                if self.enable_relocalization
                else torch.zeros((), dtype=torch.int32, device=dev)
            ),
            lost=torch.zeros((), dtype=torch.bool, device=dev),
            unstable_count=torch.zeros((), dtype=torch.int32, device=dev),
            mask_history=torch.zeros(
                (cfg.mask_ring_frames,) + cam.shape, dtype=torch.uint8, device=dev
            ),
            pred=pred,
        )

    # ------------------------------------------------------------------
    # hot tuning: the reference re-reads its GUI Vars every frame
    # (MainController.cpp:448-473); set_params name -> the _fparams key it sets
    _HOT_FPARAMS = {
        "depth_cutoff": "depth_cutoff", "outlier_coefficient": "outlier_coeff",
        "icp_weight": "icp_weight", "keep_min_surfels": "keep_min_surfels",
        "keep_conf_threshold": "keep_conf_threshold",
    }
    # set_params name -> the SegmentationParams field it overrides
    _HOT_CRF = {
        "crf_scale_rgb": "scale_rgb", "crf_scale_depth": "scale_depth",
        "crf_scale_pos": "scale_pos", "weight_appearance": "weight_appearance",
        "weight_smoothness": "weight_smoothness", "unary_threshold_new": "unary_threshold_new",
        "unary_k_error": "unary_k_error", "unary_weight_error": "unary_weight_error",
        "min_rel_size_new": "min_rel_size_new", "max_rel_size_new": "max_rel_size_new",
    }
    _HOT_PARAMS = frozenset(_HOT_FPARAMS) | frozenset(_HOT_CRF)

    def set_params(self, **kw) -> None:
        """Change run-time parameters between frames (depth cutoff, outlier
        coefficient, ICP weight, the CRF's weights and thresholds, the smart
        delete gates).  They are Python numbers the next frame's step reads:
        no rebuild, no host sync.  Unknown names raise ValueError."""
        bad = set(kw) - self._HOT_PARAMS
        if bad:
            raise ValueError(
                f"not hot-tunable: {sorted(bad)}; available: {sorted(self._HOT_PARAMS)}"
            )
        for k, v in kw.items():
            if k in self._HOT_CRF:
                self._hot_crf[self._HOT_CRF[k]] = float(v)
            else:
                self._fparams[self._HOT_FPARAMS[k]] = float(v)

    def set_confidence_threshold(self, slot: int, value: float) -> None:
        """Set one model's confidence threshold (the reference's per-model
        sliders, GUI/Tools/GUI.h:39,58): a device write between frames, with
        the value passed by value (no host sync); before the first frame it
        sets the global (slot 0) or object threshold the run starts with."""
        if self.state is None:
            if slot == 0:
                self.fusion = dataclasses.replace(self.fusion, confidence_global=value)
            else:
                self.fusion = dataclasses.replace(self.fusion, confidence_object=value)
                self._fparams["conf_object"] = float(value)
            return
        models = self.state.models
        ct = models.conf_threshold
        slot_ids = torch.arange(ct.shape[0], device=ct.device)
        self.state = self.state._replace(models=models._replace(
            conf_threshold=torch.where(slot_ids == slot, float(value), ct)
        ))

    # ------------------------------------------------------------------
    def process_frame(
        self,
        frame: dict,
        weight_multiplier: float = 1.0,
        sync: bool = False,
        gt_pose: np.ndarray | None = None,
    ) -> dict:
        """One frame.  `frame`: rgb uint8 (H,W,3), depth float32 metres (H,W),
        optional mask (H,W) of dataset object ids, timestamp int.
        `gt_pose`: the (4, 4) camera-to-world pose of the frame ('-p'):
        tracking and segmentation are skipped (CoFusion.cpp:342).
        Asynchronous: the step is queued and nothing waits on the device
        unless `sync=True`."""
        self.sw.tick = 1 if self.state is None else self.state.tick + 1
        with self.sw.section("Run"):
            dev = self.device
            rgb = upload(frame["rgb"], dev, torch.float32)
            depth = upload(frame["depth"], dev, torch.float32)
            ts = frame.get("timestamp", 0)

            if self.state is None:
                # the first frame initialises the global model only
                # (CoFusion.cpp:202-205); objects spawn from later frames
                with self.sw.section("Init"):
                    self.state = self._init_state(
                        rgb, depth, torch.zeros(self.cam.shape, dtype=torch.int32, device=dev)
                    )
                self._timestamps.append(ts)
                self._last_outputs = None
                self._last_segmentation = np.zeros(self.cam.shape, np.uint8)
                return {"tick": 1}

            # --- segmentation source
            new_slot, use_crf, gt_masks = -1, False, False
            mask_np = frame.get("mask")
            M = self.cfg.max_models
            if gt_pose is not None:
                # '-p' skips segmentation (CoFusion.cpp:340-343): committing a
                # mask id to a slot here would spawn no model and keep its
                # pixels out of the background for good
                mask = torch.zeros(self.cam.shape, dtype=torch.int32, device=dev)
            elif self.enable_multi_model and mask_np is not None:
                # ground-truth masks: remap dataset ids -> model slots
                # (Segmentation.cpp:59-122).  allow_new mirrors the device's
                # spawn_cooldown gate, so a mapping commits exactly when the
                # device spawns; unmapped ids stay background and retry
                gt_masks = True
                free = [s for s in range(1, M) if s not in self._used_slots]
                allow = bool(free) and self._host_cooldown >= self.fusion.model_spawn_offset
                slot_mask, assigned = self._gt_mapper.remap(np.asarray(mask_np), free, allow_new=allow)
                if assigned is not None:
                    new_slot = assigned
                    self._used_slots.add(assigned)
                    self._ever_active.add(assigned)
                    for fn in self._new_model_listeners:
                        fn(assigned)
                self._last_segmentation = slot_mask
                self._seg_from_host = True
                mask = upload(slot_mask, dev, torch.int32)
                # host mirror of the device's unseen deactivation
                # (CoFusion.cpp:284-291): a slot whose id vanished for
                # model_deactivate_count frames is freed and its ids purged
                present = {int(v) for v in np.unique(slot_mask)}
                for s in sorted(self._used_slots):
                    if s == 0 or s == assigned:
                        continue
                    if s in present:
                        self._host_unseen[s] = 0
                    else:
                        self._host_unseen[s] = self._host_unseen.get(s, 0) + 1
                        if self._host_unseen[s] >= self.fusion.model_deactivate_count:
                            self._used_slots.discard(s)
                            self._host_unseen.pop(s, None)
                            self._gt_mapper.purge_slot(s)
                            for fn in self._inactive_model_listeners:
                                fn(s)
            elif self.enable_multi_model:
                # motion-cue CRF: the device segments and picks spawn slots
                use_crf = True
                mask = torch.zeros(self.cam.shape, dtype=torch.int32, device=dev)
            elif mask_np is not None:
                mask = upload(np.asarray(mask_np), dev, torch.int32)
            else:
                mask = torch.zeros(self.cam.shape, dtype=torch.int32, device=dev)

            fparams = dict(
                self._fparams, weight_multiplier=float(weight_multiplier),
                new_slot=new_slot, allow_new=new_slot >= 0, gt_masks=gt_masks,
            )
            if gt_pose is not None:
                fparams["gt_pose"] = upload(gt_pose, dev, torch.float32)
            sparams = self.segmentation
            if self._hot_crf:
                sparams = dataclasses.replace(sparams, **self._hot_crf)
            self.state, outputs = _step(
                self.state, rgb, depth, mask, fparams,
                cam=self.cam, cfg=self.cfg, tparams=self.tracking,
                sparams=sparams, use_crf=use_crf,
                use_reloc=self.enable_relocalization, close_loops=self.close_loops,
                use_gt_pose=gt_pose is not None, sw=self.sw, graphs=self.graphs,
            )
            self._last_outputs = outputs
            self._timestamps.append(ts)

            # spawn-cooldown mirror (the device's: 0 on a spawn, else +1)
            if new_slot >= 0 and gt_masks:
                self._host_cooldown = 0
            else:
                self._host_cooldown = min(self._host_cooldown + 1, 10000)

            # CRF: refresh the host's slot view every `_sync_cadence` frames;
            # each sync point consumes the copy started at the previous one
            # and starts a new one from this frame's flags
            if use_crf:
                self._lifecycle_dirty = True
                self._frames_since_sync += 1
                if self._frames_since_sync >= self._sync_cadence:
                    self._frames_since_sync = 0
                    prev = self._pending_active
                    self._pending_active = self._readback.start(outputs.active)
                    if prev is not None:
                        # the hot path's one wait on the device
                        with self.sw.section("frame.active_readback"):
                            active = _ActiveReadback.finish(prev)
                        self._apply_active_snapshot(active)

            # flush the on-device pose ring to the host before it wraps
            n_tracked = len(self._timestamps) - 1
            if n_tracked - len(self._flushed_poses) >= self.cfg.max_log_frames - 8:
                self._flush_pose_history()
            if sync:
                return self.stats()
        return {"tick": None}

    def _apply_active_snapshot(self, active: np.ndarray) -> None:
        """Fold an active-flag snapshot into the host's slot view: fire the
        listeners on edges and free dead slots for reuse (the device resets a
        recycled slot on spawn)."""
        now = {0} | {s for s in range(1, self.cfg.max_models) if active[s]}
        for s in sorted(now - self._active_snapshot):
            self._ever_active.add(s)
            for fn in self._new_model_listeners:
                fn(s)
        for s in sorted(self._active_snapshot - now):
            for fn in self._inactive_model_listeners:
                fn(s)
        self._active_snapshot = now
        self._used_slots = set(now)

    def flush_lifecycle(self) -> None:
        """Read the freshest active flags and fire pending lifecycle events
        (blocking; for the end of a run).  No-op outside the CRF path."""
        if self.state is None or not self._lifecycle_dirty:
            return
        self._lifecycle_dirty = False
        self._pending_active = None
        self._frames_since_sync = 0
        self._apply_active_snapshot(self.state.models.active.cpu().numpy())

    def _flush_pose_history(self) -> None:
        """Move device pose-history entries into the host-side chunk list."""
        n_tracked = len(self._timestamps) - 1
        cap = self.cfg.max_log_frames
        hist = self.state.pose_history.cpu().numpy()
        for i in range(len(self._flushed_poses) + 1, n_tracked + 1):
            self._flushed_poses.append(hist[i % cap].copy())

    def drain_segmentation(self, flush: bool = False) -> list[tuple[int, np.ndarray]]:
        """Newly available masks from the on-device ring as [(tick, mask
        uint8 (H,W)), ...], read in one bulk copy every ~R frames (call every
        frame: it usually returns []; `flush=True` at the end of a run)."""
        out: list[tuple[int, np.ndarray]] = []
        n_tracked = len(self._timestamps) - 1
        pending = n_tracked - self._masks_drained
        R = self.cfg.mask_ring_frames
        if pending <= 0 or (not flush and pending < R - 4):
            return out
        hist = self.state.mask_history.cpu().numpy()
        for i in range(max(self._masks_drained + 1, n_tracked - R + 1), n_tracked + 1):
            # frame i was processed at tick i+1, written at slot ((i+1)-1) % R
            out.append((i + 1, hist[i % R].copy()))
        self._masks_drained = n_tracked
        return out

    def current_segmentation(self) -> np.ndarray | None:
        """The latest segmentation (model slot per pixel): the host's remap on
        the GT-mask path; on the CRF path one blocking read-back (bulk
        exports use `drain_segmentation`)."""
        if self._seg_from_host or self.state is None:
            return self._last_segmentation
        return self.state.prev_mask.cpu().numpy().astype(np.uint8)

    def add_new_model_listener(self, fn) -> None:
        """fn(slot) on model spawn (newModelListeners, CoFusion.cpp:607).
        CRF events arrive at most two sync cadences (<= 8 frames) late;
        `flush_lifecycle` forces them out."""
        self._new_model_listeners.append(fn)

    def add_inactive_model_listener(self, fn) -> None:
        """fn(slot) on model deactivation (inactiveModelListeners,
        CoFusion.cpp:624)."""
        self._inactive_model_listeners.append(fn)

    def stats(self) -> dict:
        """Materialise the most recent frame's outputs (blocks on the device).
        `tracking_graph` and `fuse_graph`: this engine's graph cache's
        counters of `track_models` and the fuse/clean passes (host ints:
        captures, replays, eager calls, evictions)."""
        with self.sw.section("download"):
            models = self.state.models
            st = {
                "tick": self.state.tick,
                "tracking_graph": self.graphs.counts("tracking"),
                "fuse_graph": self.graphs.counts("fuse_clean"),
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
        self.flush_lifecycle()  # CRF events may be in flight
        return m in self._ever_active

    def camera_pose(self) -> np.ndarray:
        """Current global-camera pose (model 0)."""
        return self.state.models.pose[0].cpu().numpy()

    def surfel_count(self, model: int = 0) -> int:
        models = self.state.models
        return int(models.store.count[model]) + min(
            int(models.stable.count[model]), models.stable.capacity
        )

    def render_views(self) -> dict:
        """The global model's view at the current pose, for the '-en'
        (normals) and '-ev' (viewport) exports (GUI/MainController.cpp:394-407,
        headless): the active tier within the time window and the stable tier
        with none, each splatted (two splat kernel launches), z-merged.
        Returns numpy `image` (H, W, 3), `normal` (H, W, 3) and `valid`
        (H, W): a blocking read-back."""
        st, cam, cfg = self.state, self.cam, self.cfg
        models = st.models
        pose0, conf0 = models.pose[0], models.conf_threshold[0]
        dc = float(self.fusion.depth_cutoff)
        view = rz.splat_merge(
            rz.splat_predict(_slot0(models.store), pose0, cam, cfg, st.tick, cfg.time_delta,
                             dc, conf0),
            rz.splat_predict(_slot0(models.stable), pose0, cam, cfg, st.tick, 1 << 30, dc,
                             conf0),
        )
        return {
            "image": view.image.cpu().numpy(),
            "normal": view.normal_rad[..., :3].cpu().numpy(),
            "valid": view.valid.cpu().numpy(),
        }

    def download_model(self, model: int = 0) -> dict:
        """Whole two-tier map of one model (Model::downloadMap): stable (old)
        surfels first, then the active tier."""
        models = self.state.models
        d_act = sm.download(_unbatch(sm.gathered(models.store), model))
        d_stb = sm.download_masked(_unbatch(sm.gathered(models.stable), model))
        return {k: np.concatenate([d_stb[k], d_act[k]], axis=0) for k in d_act}
