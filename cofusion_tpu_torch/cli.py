"""Command-line entry point of the port — cofusion_tpu/cli.py (the reference's
MainController, headless), every flag of it.

Usage:
    python -m cofusion_tpu_torch -l log.klg -static -run -q -ep -em -exportdir out/
    python -m cofusion_tpu_torch -dir dataset/ -maskdir dataset/ -es -ep -em -exportdir out/
    python -m cofusion_tpu_torch -l log.klg -d 4.5 -es -exportdir out/     # CRF segmentation
    python -m cofusion_tpu_torch -l log.klg -static -rl -cl -ep -exportdir out/
    python -m cofusion_tpu_torch -l log.klg -static -p gt.txt -en -ev -exportdir out/

Without `-static` the engine runs the multi-model mode with 4 model slots:
ground-truth masks where the reader has them (`-maskdir`, or Mask####.png
beside the frames of `-dir`), motion-cue CRF segmentation otherwise.
Flags are the JAX CLI's, parsed the same way.  Supported: -l, -dir (with
the reader options -basedir, -cal, -maskdir, -depthdir, -colorprefix,
-depthprefix, -maskprefix, -indexW, -pngScale, -nm), -static, -d, -t, -ns,
-i, -confG, -confO, -offset, -keep, -a (accepted, no effect: every slot is
allocated up front), -crfRGB, -crfDepth, -crfPos, -crfAppearance,
-crfSmooth, -thNew, -k, -segMinNew, -segMaxNew, -run, -q, -s, -e, -ep, -em,
-es, -el, -exportdir; relocalisation `-rl` with its photometric gate `-pt`
and keyframe threshold `-ft`; loop closure `-cl` with its gates `-ie`
(residual), `-ic` (inlier count) and `-cv` (covariance); `-o`, open loop:
no time window (time delta 2^30) and loop closure off whatever `-cl` says
(MainController.cpp:328-329); `-p <file>` ground-truth poses (TUM file,
one pose a frame: tracking and segmentation skipped); `-en` / `-ev` the
rendered normals and viewport of every frame (Normals<tick-1>.png,
Viewport<tick-1>.png); `-checkpoint <file>` saves the engine at the end
and `-resume <file>` starts from one; `-or` the outlier coefficient; `-fo`
fast odometry and `-nso` no SO(3) pre-alignment; `-ftf` frame-to-frame
RGB tracking; `-icl` (ICL-NUIM: the model export at the end); `-f` flips
the colour channels; `-r` ping-pong playback (forward, then backward, to
`-e` processed frames, by default 2N - 2); `-fs` skips frames while the
`Run` section runs behind 30 Hz.  The port adds `-device cuda|cpu`: the
default is cuda, and the run fails when CUDA is absent; `-device cpu`
runs the kernels' plain PyTorch versions on the CPU.  Frames are read by
the port's numpy readers (`cofusion_tpu_torch/io/readers.py`).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from cofusion_tpu_torch.config import (
    CameraConfig, CoFusionConfig, FusionParams, SegmentationParams, TrackingParams,
)
from cofusion_tpu_torch.io import readers
from cofusion_tpu_torch.io.ground_truth import GroundTruthOdometry
from cofusion_tpu_torch.utils import checkpoint as ckpt
from cofusion_tpu_torch.utils import export


class Parse:
    """argv scanner in the style of the reference's Parse singleton
    (Core/Utils/Parse.h:31-52): `-flag value` and boolean `-flag`."""

    def __init__(self, argv: list[str]):
        self.argv = argv

    def arg(self, flag: str, default=None):
        if flag in self.argv:
            i = self.argv.index(flag)
            if i + 1 < len(self.argv):
                nxt = self.argv[i + 1]
                # a token starting with '-' is the next flag UNLESS it parses
                # as a number (e.g. `-or -3`)
                if not nxt.startswith("-") or _is_number(nxt):
                    return nxt
        return default

    def float_arg(self, flag: str, default: float) -> float:
        v = self.arg(flag)
        return float(v) if v is not None else default

    def int_arg(self, flag: str, default: int) -> int:
        v = self.arg(flag)
        return int(v) if v is not None else default

    def flag(self, flag: str) -> bool:
        return flag in self.argv


def _is_number(token: str) -> bool:
    try:
        float(token)
        return True
    except ValueError:
        return False


def _has_masks(directory) -> bool:
    if not directory or not os.path.isdir(directory):
        return False
    import glob

    return bool(glob.glob(os.path.join(directory, "Mask*")))


def build_from_args(argv: list[str]):
    """Construct (reader, engine, options) from reference-style argv."""
    from cofusion_tpu_torch.engine import CoFusion

    p = Parse(argv)
    base = p.arg("-basedir", "")

    def rel(path):
        return os.path.join(base, path) if path and base else path

    width, height = 640, 480
    fx, fy, cx, cy = 528.0, 528.0, 320.0, 240.0  # MainController.cpp:108-110
    cal_explicit = rel(p.arg("-cal"))
    if cal_explicit:
        fx, fy, cx, cy, w2, h2 = readers.load_calibration(cal_explicit)
        if w2 and h2:
            width, height = w2, h2

    log = rel(p.arg("-l"))
    directory = rel(p.arg("-dir"))
    mask_dir = rel(p.arg("-maskdir")) or directory
    max_masks = p.int_arg("-nm", 0) if p.flag("-nm") else None
    if log:
        reader = readers.KlgLogReader(log, width, height)
    elif directory:
        reader = readers.ImageLogReader(
            directory,
            mask_directory=mask_dir if (p.arg("-maskdir") or _has_masks(mask_dir)) else None,
            depth_directory=rel(p.arg("-depthdir")),
            color_prefix=p.arg("-colorprefix"),
            depth_prefix=p.arg("-depthprefix"),
            mask_prefix=p.arg("-maskprefix"),
            max_masks=max_masks,
            index_width=p.int_arg("-indexW", 0) or None,
            png_depth_scale=p.float_arg("-pngScale", 0.0006),
        )
    else:
        raise SystemExit("need -l <log.klg> or -dir <dataset dir>")

    if not cal_explicit and directory:
        cal = reader.calibration_file()
        if cal:
            fx, fy, cx, cy, w2, h2 = readers.load_calibration(cal)
            if w2 and h2:
                width, height = w2, h2

    cam = CameraConfig(width=width, height=height, fx=fx, fy=fy, cx=cx, cy=cy)
    static = p.flag("-static")
    open_loop = p.flag("-o")
    cfg = CoFusionConfig(
        camera=cam,
        max_models=1 if static else 4,
        fast_odom=p.flag("-fo"),
        use_so3=not p.flag("-nso"),
        time_delta=(1 << 30) if open_loop else p.int_arg("-t", 200),
        max_surfels=p.int_arg("-ns", CoFusionConfig.max_surfels),
    )
    tracking = TrackingParams(icp_weight=p.float_arg("-i", 10.0), rgb_only=False)
    fusion = FusionParams(
        depth_cutoff=p.float_arg("-d", 5.0),
        confidence_global=p.float_arg("-confG", 10.0),
        confidence_object=p.float_arg("-confO", 0.01),
        model_spawn_offset=p.int_arg("-offset", 22),
        # the free-space decay 1/(1 + coeff * violation) and the mask
        # mismatch penalty 0.5 + 0.5 * (1 - coeff / 10), unscaled as the
        # reference's value reaches copy_unstable.vert:140-149
        outlier_coefficient=p.float_arg("-or", 3.0),
        local_loop_err_thresh=p.float_arg("-ie", 5e-5),
        local_loop_count_thresh=p.float_arg("-ic", 40000.0),
        local_loop_cov_thresh=p.float_arg("-cv", 1e-5),
        fern_photo_thresh=p.float_arg("-pt", 115.0),
        fern_thresh=p.float_arg("-ft", 0.3095),
    )
    engine = CoFusion(
        cfg, tracking=tracking, fusion_params=fusion, enable_multi_model=not static,
        enable_relocalization=p.flag("-rl"), close_loops=p.flag("-cl") and not open_loop,
        frame_to_frame_rgb=p.flag("-ftf"), keep_models=p.flag("-keep"),
        device=p.arg("-device", "cuda"),
    )
    # CRF tuning flags (MainController.cpp:222-231); the -crf* values are
    # standard deviations, the kernel features scale by their inverse
    sp = SegmentationParams()
    engine.segmentation = SegmentationParams(
        scale_rgb=1.0 / p.float_arg("-crfRGB", 1.0 / sp.scale_rgb),
        scale_depth=1.0 / p.float_arg("-crfDepth", 1.0 / sp.scale_depth),
        scale_pos=1.0 / p.float_arg("-crfPos", 1.0 / sp.scale_pos),
        weight_appearance=p.float_arg("-crfAppearance", sp.weight_appearance),
        weight_smoothness=p.float_arg("-crfSmooth", sp.weight_smoothness),
        unary_threshold_new=p.float_arg("-thNew", sp.unary_threshold_new),
        unary_k_error=p.float_arg("-k", sp.unary_k_error),
        min_rel_size_new=p.float_arg("-segMinNew", sp.min_rel_size_new),
        max_rel_size_new=p.float_arg("-segMaxNew", sp.max_rel_size_new),
    )
    pose_file = rel(p.arg("-p"))
    reader.flip_colors = p.flag("-f")
    options = {
        "start": p.int_arg("-s", 0),
        "end": p.int_arg("-e", -1),
        "frame_skip": p.flag("-fs"),
        "rewind": p.flag("-r"),
        "export_dir": rel(p.arg("-exportdir")),
        "export_poses": p.flag("-ep"),
        # '-icl' (ICL-NUIM mode, MainController.cpp:98): its engine-side
        # effect is savePly() at shutdown (CoFusion.cpp:80-82); the GUI's
        # up-vector flip has no headless counterpart
        "export_models": p.flag("-em") or p.flag("-icl"),
        "icl": p.flag("-icl"),
        "export_segmentation": p.flag("-es"),
        "export_labels": p.flag("-el"),
        "export_normals": p.flag("-en"),
        "export_viewport": p.flag("-ev"),
        "checkpoint": p.arg("-checkpoint"),
        "resume": p.arg("-resume"),
        "ground_truth": GroundTruthOdometry(pose_file) if pose_file else None,
    }
    return reader, engine, options


def _write_drained_masks(drained: list, opt: dict) -> None:
    """Write masks pulled from the engine's mask ring ('-es' / '-el'), named
    as the reference names them (CoFusion.cpp:235-240)."""
    for tick, mask in drained:
        if opt["export_segmentation"]:
            export.export_mask_png(os.path.join(opt["export_dir"], f"Segmentation{tick}.png"), mask)
        if opt["export_labels"]:
            export.export_label_png(os.path.join(opt["export_dir"], f"Labels{tick - 1}.png"), mask)


def run(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    reader, engine, opt = build_from_args(argv)
    sw = engine.sw

    if opt["resume"]:
        ckpt.load_engine(engine, opt["resume"])
        print(f"Resumed from {opt['resume']} at tick {engine.state.tick}.")
    if opt["start"]:
        reader.fast_forward(opt["start"])
    end = opt["end"] if opt["end"] >= 0 else reader.num_frames()
    if opt["rewind"] and opt["end"] < 0:
        # '-r' ping-pong playback (MainController.cpp:352-363) has no log
        # end: by default one sweep forward and one back; '-e N' counts
        # processed frames
        end = max(2 * reader.num_frames() - 2, 1)
    masks_out = opt["export_dir"] and (opt["export_segmentation"] or opt["export_labels"])
    views_out = opt["export_dir"] and (opt["export_normals"] or opt["export_viewport"])
    if masks_out or views_out:
        os.makedirs(opt["export_dir"], exist_ok=True)
    processed, direction = 0, 1
    # headless: '-run' and '-q' (start immediately, quit at the log's end)
    # are how this loop always behaves
    while True:
        if opt["rewind"]:
            if processed >= end:
                break
            if direction > 0 and not reader.has_more():
                direction = -1
            if direction < 0 and reader.current_frame <= 1:
                # bounced off the log's start: forward again
                reader.rewind()
                direction = 1
            frame = reader.get_next() if direction > 0 else reader.get_previous()
        else:
            if not (reader.has_more() and reader.current_frame < end):
                break
            frame = reader.get_next()
        gt_pose = None
        if opt["ground_truth"] is not None:
            gt_pose = opt["ground_truth"].pose_for(frame.get("timestamp", 0))
        engine.process_frame(frame, gt_pose=gt_pose)
        processed += 1
        # real-time frame skip (GUI/MainController.cpp:413-415): frames the
        # sensor delivered while the step ran behind 30 Hz are dropped
        run_ms = sw.timings().get("Run", 0.0)
        if opt["frame_skip"] and run_ms > 1000.0 / 30.0:
            for _ in range(int(run_ms / (1000.0 / 30.0))):
                if reader.has_more() and reader.current_frame < end:
                    reader.get_next()
        if masks_out:
            # masks come from the device ring in bulk (one copy per ~R frames)
            _write_drained_masks(engine.drain_segmentation(), opt)
        if views_out:
            # named after the reference's tick during this frame, minus one
            tick = engine.state.tick
            views = engine.render_views()
            if opt["export_normals"]:
                export.export_normal_png(
                    os.path.join(opt["export_dir"], f"Normals{tick - 1}.png"),
                    views["normal"], views["valid"],
                )
            if opt["export_viewport"]:
                export.export_viewport_png(
                    os.path.join(opt["export_dir"], f"Viewport{tick - 1}.png"),
                    views["image"], views["valid"],
                )

    if opt["export_dir"] and processed:
        os.makedirs(opt["export_dir"], exist_ok=True)
        if masks_out:
            _write_drained_masks(engine.drain_segmentation(flush=True), opt)
        models = [m for m in range(engine.cfg.max_models) if m == 0 or engine.model_ever_active(m)]
        if opt["export_poses"]:
            # model 0 = camera (cam->world); objects P_cam * P_obj^-1
            for m in models:
                export.export_poses("", engine.pose_log_for(m), m, opt["export_dir"])
        if opt["export_models"]:
            poses = engine.state.models.pose.cpu().numpy()
            thresholds = engine.state.models.conf_threshold.cpu().numpy()
            for m in models:
                # object clouds in the world frame: P_cam * P_obj^-1
                # (CoFusion.cpp:695-698); model 0 is world-frame already
                export.export_ply(
                    os.path.join(opt["export_dir"], f"cloud-{m}.ply"),
                    engine.download_model(m),
                    conf_threshold=float(thresholds[m]),
                    transform=None if m == 0 else poses[0] @ np.linalg.inv(poses[m]),
                )
    if opt["checkpoint"]:
        ckpt.save_engine(engine, opt["checkpoint"])
        print(f"Checkpoint saved to {opt['checkpoint']}.")
    print(f"Processed {processed} frames.")
    print(sw.report({"tracking_graph": engine.graphs.counts("tracking"),
                     "fuse_graph": engine.graphs.counts("fuse_clean")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(run())

