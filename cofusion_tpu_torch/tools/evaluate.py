"""Evaluation harness: turn an export directory of the port's CLI (or the
JAX package's) into the two accuracy numbers — trajectory ATE-RMSE and
segmentation mean-IoU.  The port's copy of tools/evaluate.py: the same
flags, the same matching rule and the same JSON line, on the port's
exporter (`cofusion_tpu_torch.utils.export`) and PNG decoder
(`cofusion_tpu_torch.io.png`); no JAX, no OpenCV.

The reference ecosystem evaluates with the external `dataset-tools` suite
(Co-Fusion's README: "evaluate the segmentation as well as the tracking
quality", convert formats, compute IoU).  This is the in-repo analogue
over the artifacts the CLI writes:

  * `-ep`  -> poses-<m>.txt         TUM `ts x y z qx qy qz qw` per model
  * `-es`  -> Segmentation<t>.png   8-bit label ids per frame (t = engine tick)

Usage:
  python -m cofusion_tpu_torch.tools.evaluate --export out \
      --gt-poses gt.txt|gt.npy [--model 0] [--no-align] \
      [--gt-masks masks/] [--mask-prefix Mask] [--min-px 300] [--mask-offset 0]

Prints one human table + ONE machine-readable JSON line:
  {"ate_rmse_m": ..., "mean_iou": ..., "per_object_iou": {...}, ...}

Label matching: exported ids are engine model-slot ids, GT ids are dataset
ids — neither is comparable directly, so each GT object id is matched to the
exported label with the largest total intersection over the sequence
(the greedy overlap assignment dataset-tools' segmentation scoring uses),
then IoU is averaged over frames where the GT object is present.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

import numpy as np

from cofusion_tpu_torch.io import png
from cofusion_tpu_torch.utils.export import ate_rmse, load_tum_trajectory


def load_gt_poses(path: str) -> np.ndarray:
    """GT camera trajectory: TUM text file or a (T,4,4) .npy stack."""
    if path.endswith(".npy"):
        arr = np.load(path)
        if arr.ndim != 3 or arr.shape[1:] != (4, 4):
            raise SystemExit(f"--gt-poses npy must be (T,4,4), got {arr.shape}")
        return arr
    _, poses = load_tum_trajectory(path)
    return poses


def evaluate_trajectory(export_dir: str, gt: np.ndarray, model: int, align: bool):
    path = os.path.join(export_dir, f"poses-{model}.txt")
    if not os.path.isfile(path):
        return None
    _, est = load_tum_trajectory(path)
    n = min(len(est), len(gt))
    if n < 2:
        return None
    return {
        "model": model,
        "frames": n,
        "ate_rmse_m": ate_rmse(list(est[:n]), list(gt[:n]), align=align),
    }


def _index_of(path: str) -> int:
    m = re.search(r"(\d+)\.[A-Za-z]+$", os.path.basename(path))
    return int(m.group(1)) if m else -1


def _load_gray(path: str) -> np.ndarray:
    """The first channel of the mask as cv2.imread(IMREAD_UNCHANGED) gives
    it: the blue of a colour image (cv2's order is BGR), the gray of gray +
    alpha.  PNG only."""
    try:
        img = png.imread(path)
    except IOError as e:
        raise SystemExit(f"unreadable mask: {path} ({e})") from None
    if img.ndim == 3:
        img = img[..., 2] if img.shape[2] >= 3 else img[..., 0]
    return img.astype(np.int32)


def evaluate_segmentation(
    export_dir: str,
    gt_mask_dir: str,
    mask_prefix: str = "Mask",
    min_px: int = 300,
    offset: int = 0,
):
    """Sequence mean-IoU of exported Segmentation<t>.png vs GT masks.

    `offset` aligns numbering: exported tick t corresponds to GT frame index
    t - 1 + offset (the engine's tick is 1-based over processed frames)."""
    est_files = {
        _index_of(p): p
        for p in glob.glob(os.path.join(export_dir, "Segmentation*.png"))
    }
    gt_files = sorted(
        glob.glob(os.path.join(gt_mask_dir, f"{mask_prefix}*")), key=_index_of
    )
    if not est_files or not gt_files:
        return None

    pairs = []
    for gp in gt_files:
        gi = _index_of(gp)
        tick = gi + 1 - offset
        if tick in est_files:
            pairs.append((gi, _load_gray(est_files[tick]), _load_gray(gp)))
    if not pairs:
        return None

    gt_ids = sorted(
        {int(v) for _, _, g in pairs for v in np.unique(g) if v not in (0, 255)}
    )
    # greedy overlap assignment: each GT object -> exported label with the
    # largest summed intersection over the sequence (labels 0/255 excluded)
    result_per_object = {}
    ious_all = []
    taken = set()
    for gid in gt_ids:
        inter_by_label: dict[int, int] = {}
        present_frames = []
        for fi, est, gt in pairs:
            gmask = gt == gid
            if gmask.sum() < min_px:
                continue
            present_frames.append((fi, est, gmask))
            ids, counts = np.unique(est[gmask], return_counts=True)
            for i, c in zip(ids.tolist(), counts.tolist()):
                if i not in (0, 255) and i not in taken:
                    inter_by_label[i] = inter_by_label.get(i, 0) + c
        if not present_frames:
            continue
        best = max(inter_by_label, key=inter_by_label.get) if inter_by_label else None
        frame_ious = []
        for fi, est, gmask in present_frames:
            if best is None:
                frame_ious.append(0.0)
                continue
            emask = est == best
            union = (emask | gmask).sum()
            frame_ious.append(float((emask & gmask).sum() / union) if union else 0.0)
        if best is not None:
            taken.add(best)
        result_per_object[str(gid)] = {
            "matched_label": best,
            "frames": len(frame_ious),
            "iou": float(np.mean(frame_ious)),
        }
        ious_all.extend(frame_ious)

    if not ious_all:
        return None
    return {
        "frames_compared": len(pairs),
        "objects": len(result_per_object),
        "mean_iou": float(np.mean(ious_all)),
        "per_object_iou": result_per_object,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--export", required=True, help="CLI -exportdir directory")
    ap.add_argument("--gt-poses", help="GT camera trajectory (.txt TUM or .npy (T,4,4))")
    ap.add_argument("--model", type=int, default=0, help="pose track to score (default camera)")
    ap.add_argument("--no-align", action="store_true", help="skip SE(3) alignment before ATE")
    ap.add_argument("--gt-masks", help="directory of GT instance masks")
    ap.add_argument("--mask-prefix", default="Mask")
    ap.add_argument("--min-px", type=int, default=300,
                    help="ignore frames where the GT object is smaller than this")
    ap.add_argument("--mask-offset", type=int, default=0,
                    help="GT frame index of the first processed frame (CLI -s value)")
    args = ap.parse_args(argv)

    out = {}
    if args.gt_poses:
        traj = evaluate_trajectory(
            args.export, load_gt_poses(args.gt_poses), args.model, not args.no_align
        )
        if traj is None:
            print(f"[evaluate] no usable poses-{args.model}.txt in {args.export}", file=sys.stderr)
        else:
            out["ate_rmse_m"] = round(traj["ate_rmse_m"], 6)
            out["traj_frames"] = traj["frames"]
            print(f"trajectory  model {args.model}: ATE-RMSE {traj['ate_rmse_m']*100:.3f} cm "
                  f"over {traj['frames']} frames", file=sys.stderr)

    if args.gt_masks:
        seg = evaluate_segmentation(
            args.export, args.gt_masks, args.mask_prefix, args.min_px, args.mask_offset
        )
        if seg is None:
            print(f"[evaluate] no comparable Segmentation*.png / GT mask pairs", file=sys.stderr)
        else:
            out["mean_iou"] = round(seg["mean_iou"], 4)
            out["seg_frames"] = seg["frames_compared"]
            out["per_object_iou"] = seg["per_object_iou"]
            print(f"segmentation: mean IoU {seg['mean_iou']:.3f} over "
                  f"{seg['objects']} object(s), {seg['frames_compared']} frames", file=sys.stderr)
            for gid, r in seg["per_object_iou"].items():
                print(f"  gt id {gid} -> label {r['matched_label']}: IoU {r['iou']:.3f} "
                      f"({r['frames']} frames)", file=sys.stderr)

    if not out:
        print("nothing evaluated: pass --gt-poses and/or --gt-masks", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
