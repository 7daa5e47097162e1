"""Command-line entry point of the port — cofusion_tpu/cli.py (the reference's
MainController, headless) for the static and multi-model modes, with
relocalisation and loop closure.

Usage:
    python -m cofusion_tpu_torch -l log.klg -static -run -q -ep -em -exportdir out/
    python -m cofusion_tpu_torch -dir dataset/ -maskdir dataset/ -es -ep -em -exportdir out/
    python -m cofusion_tpu_torch -l log.klg -d 4.5 -es -exportdir out/     # CRF segmentation
    python -m cofusion_tpu_torch -l log.klg -static -rl -cl -ep -exportdir out/

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
(MainController.cpp:328-329).  The port adds `-device cuda|cpu`: the default is
cuda, and the run fails when CUDA is absent; `-device cpu` runs the
kernels' plain PyTorch versions on the CPU.  The JAX CLI's other flags
raise "not yet ported" with their ROADMAP item.  Frames are read by the
port's numpy readers (`cofusion_tpu_torch/io/readers.py`).
"""

from __future__ import annotations

import os
import sys

import numpy as np

from cofusion_tpu_torch.config import (
    CameraConfig, CoFusionConfig, FusionParams, SegmentationParams, TrackingParams,
)
from cofusion_tpu_torch.io import readers
from cofusion_tpu_torch.utils import export
from cofusion_tpu_torch.utils.stopwatch import Stopwatch

# flag -> ROADMAP item of the feature it needs
NOT_PORTED = {
    "-p": "A14", "-en": "A14", "-ev": "A14", "-checkpoint": "A14", "-resume": "A14",
    "-or": "A14", "-fo": "A14", "-nso": "A14", "-ftf": "A14",
    "-icl": "A14", "-f": "A14", "-r": "A14", "-fs": "A14",
}


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
    for flag, item in NOT_PORTED.items():
        if p.flag(flag):
            raise SystemExit(f"{flag} is not yet ported (ROADMAP {item})")

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
        time_delta=(1 << 30) if open_loop else p.int_arg("-t", 200),
        max_surfels=p.int_arg("-ns", CoFusionConfig.max_surfels),
    )
    tracking = TrackingParams(icp_weight=p.float_arg("-i", 10.0), rgb_only=False)
    fusion = FusionParams(
        depth_cutoff=p.float_arg("-d", 5.0),
        confidence_global=p.float_arg("-confG", 10.0),
        confidence_object=p.float_arg("-confO", 0.01),
        model_spawn_offset=p.int_arg("-offset", 22),
        local_loop_err_thresh=p.float_arg("-ie", 5e-5),
        local_loop_count_thresh=p.float_arg("-ic", 40000.0),
        local_loop_cov_thresh=p.float_arg("-cv", 1e-5),
        fern_photo_thresh=p.float_arg("-pt", 115.0),
        fern_thresh=p.float_arg("-ft", 0.3095),
    )
    engine = CoFusion(
        cfg, tracking=tracking, fusion_params=fusion, enable_multi_model=not static,
        enable_relocalization=p.flag("-rl"), close_loops=p.flag("-cl") and not open_loop,
        keep_models=p.flag("-keep"), device=p.arg("-device", "cuda"),
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
    options = {
        "start": p.int_arg("-s", 0),
        "end": p.int_arg("-e", -1),
        "export_dir": rel(p.arg("-exportdir")),
        "export_poses": p.flag("-ep"),
        "export_models": p.flag("-em"),
        "export_segmentation": p.flag("-es"),
        "export_labels": p.flag("-el"),
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
    sw = Stopwatch.get()

    if opt["start"]:
        reader.fast_forward(opt["start"])
    end = opt["end"] if opt["end"] >= 0 else reader.num_frames()
    masks_out = opt["export_dir"] and (opt["export_segmentation"] or opt["export_labels"])
    if masks_out:
        os.makedirs(opt["export_dir"], exist_ok=True)
    processed = 0
    # headless: '-run' and '-q' (start immediately, quit at the log's end)
    # are how this loop always behaves
    while reader.has_more() and reader.current_frame < end:
        engine.process_frame(reader.get_next())
        processed += 1
        if masks_out:
            # masks come from the device ring in bulk (one copy per ~R frames)
            _write_drained_masks(engine.drain_segmentation(), opt)

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
    print(f"Processed {processed} frames.")
    print(sw.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(run())

