"""Command-line entry point of the port — the `-static` path of
cofusion_tpu/cli.py (the reference's MainController, headless).

Usage:
    python -m cofusion_tpu_torch -l log.klg -static -run -q -ep -em -exportdir out/
    python -m cofusion_tpu_torch -dir dataset/ -static -d 4.5 -ep -exportdir out/

Flags are the JAX CLI's, parsed the same way.  Supported: -l, -dir (with
the reader options -basedir, -cal, -maskdir, -depthdir, -colorprefix,
-depthprefix, -maskprefix, -indexW, -pngScale, -nm), -static, -d, -t, -ns,
-i, -confG, -run, -q, -s, -e, -ep, -em, -exportdir.  The port adds
`-device cuda|cpu`: the default is cuda, and the run fails when CUDA is
absent; `-device cpu` runs the kernels' plain PyTorch versions on the CPU.
The JAX CLI's other flags raise "not yet ported" with their ROADMAP item.
Frames are read by the port's numpy readers (`cofusion_tpu_torch/io/readers.py`).
"""

from __future__ import annotations

import os
import sys

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig, FusionParams, TrackingParams
from cofusion_tpu_torch.io import readers
from cofusion_tpu_torch.utils import export
from cofusion_tpu_torch.utils.stopwatch import Stopwatch

# flag -> ROADMAP item of the feature it needs
NOT_PORTED = {
    "-confO": "A9", "-offset": "A9", "-keep": "A9", "-a": "A9",
    "-crfRGB": "A10", "-crfDepth": "A10", "-crfPos": "A10",
    "-crfAppearance": "A10", "-crfSmooth": "A10", "-thNew": "A10", "-k": "A10",
    "-segMinNew": "A10", "-segMaxNew": "A10", "-es": "A10", "-el": "A10",
    "-rl": "A12", "-pt": "A12", "-ft": "A12",
    "-cl": "A13", "-ie": "A13", "-ic": "A13", "-cv": "A13",
    "-p": "A14", "-en": "A14", "-ev": "A14", "-checkpoint": "A14", "-resume": "A14",
    "-or": "A14", "-o": "A14", "-fo": "A14", "-nso": "A14", "-ftf": "A14",
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
    if not p.flag("-static"):
        raise SystemExit(
            "multi-model mode (no -static) is not yet ported (ROADMAP A9-A10); "
            "run with -static"
        )
    for flag, item in NOT_PORTED.items():
        if p.flag(flag):
            raise SystemExit(f"{flag} is not yet ported (ROADMAP {item}; queue A9-A14)")

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
    cfg = CoFusionConfig(
        camera=cam,
        max_models=1,
        time_delta=p.int_arg("-t", 200),
        max_surfels=p.int_arg("-ns", CoFusionConfig.max_surfels),
    )
    tracking = TrackingParams(icp_weight=p.float_arg("-i", 10.0), rgb_only=False)
    fusion = FusionParams(
        depth_cutoff=p.float_arg("-d", 5.0),
        confidence_global=p.float_arg("-confG", 10.0),
    )
    engine = CoFusion(cfg, tracking=tracking, fusion_params=fusion, device=p.arg("-device", "cuda"))
    options = {
        "start": p.int_arg("-s", 0),
        "end": p.int_arg("-e", -1),
        "export_dir": rel(p.arg("-exportdir")),
        "export_poses": p.flag("-ep"),
        "export_models": p.flag("-em"),
    }
    return reader, engine, options


def run(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    reader, engine, opt = build_from_args(argv)
    sw = Stopwatch.get()

    if opt["start"]:
        reader.fast_forward(opt["start"])
    end = opt["end"] if opt["end"] >= 0 else reader.num_frames()
    processed = 0
    # headless: '-run' and '-q' (start immediately, quit at the log's end)
    # are how this loop always behaves
    while reader.has_more() and reader.current_frame < end:
        engine.process_frame(reader.get_next())
        processed += 1

    if opt["export_dir"] and processed:
        os.makedirs(opt["export_dir"], exist_ok=True)
        if opt["export_poses"]:
            export.export_poses("", engine.pose_log_for(0), 0, opt["export_dir"])
        if opt["export_models"]:
            export.export_ply(
                os.path.join(opt["export_dir"], "cloud-0.ply"),
                engine.download_model(0),
                conf_threshold=float(engine.state.models.conf_threshold[0]),
            )
    print(f"Processed {processed} frames.")
    print(sw.report())
    return 0


if __name__ == "__main__":
    raise SystemExit(run())

