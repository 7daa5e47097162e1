"""Build the program's engine (`cofusion_tpu_torch`) from a configuration
file, feed it a stream and read what it produced."""

from __future__ import annotations

import importlib

import numpy as np

PROGRAM = "cofusion_tpu_torch"


def build(config: dict, device, overrides: dict | None = None):
    """The program's CoFusion as `config` states it (`overrides` replace
    keys of its "engine" and "camera" groups: the CPU dry run's small
    sizes).  Returns (engine, lifecycle event list the listeners fill)."""
    conf = importlib.import_module(f"{PROGRAM}.config")
    eng_mod = importlib.import_module(f"{PROGRAM}.engine")
    overrides = overrides or {}
    camera = dict(config["camera"], **overrides.get("camera", {}))
    fields = dict(config["engine"], **overrides.get("engine", {}))
    fields = {k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()}
    cfg = conf.CoFusionConfig(camera=conf.CameraConfig(**camera), **fields)
    eng = eng_mod.CoFusion(
        cfg, fusion_params=conf.FusionParams(**config["fusion"]),
        enable_multi_model=bool(config["multi_model"]), device=device,
    )
    events = []
    eng.add_new_model_listener(lambda s: events.append((len(eng._timestamps), "new", s)))
    eng.add_inactive_model_listener(lambda s: events.append((len(eng._timestamps), "inactive", s)))
    return eng, events


def feed(eng, stream, k: int) -> None:
    eng.process_frame(stream.frame(k), gt_pose=stream.gt_pose(k) if stream.feeds_gt_pose else None)


def collect(eng, events: list) -> dict:
    """What a run produced, read back once its frames are done (blocking):
    every frame's pose of every slot, each slot's map (positions, normals
    and confidences) and surfel count, the final active flags, the lifecycle
    events and the segmentations still in the engine's mask ring."""
    M = eng.cfg.max_models
    eng.flush_lifecycle()
    poses = np.stack([p for _, p in eng.materialized_pose_log()]).astype(np.float64)
    st = eng.stats()
    maps = []
    for m in range(M):
        d = eng.download_model(m)
        maps.append({k: d[k].astype(np.float64) for k in ("pos", "normal", "conf")})
    masks = dict(eng.drain_segmentation(flush=True)) if M > 1 else {}
    return {
        "poses": poses,
        "counts": np.asarray(st["surfel_counts"], np.int64),
        "active": np.asarray(st["active"], bool),
        "maps": maps,
        "masks": masks,
        "events": list(events),
    }
