"""Checkpoint and resume of the port's engine — the counterpart of
cofusion_tpu/utils/checkpoint.py (the reference has none, SURVEY.md §5.4).

A checkpoint is `torch.save` of a plain dict: the EngineState flattened by
field name ("models.store.px", "models.pose", "tick", ...), the host's frame
timestamps, its bookkeeping (slot use, the ground-truth mask mapping and
its spawn-cooldown and unseen mirrors, the pose log flushed off the device)
and a format version.  It loads with
`torch.load(..., weights_only=True, map_location=engine.device)`, so a
checkpoint written on the card resumes on the CPU and the other way round.
A JAX checkpoint pickles the JAX package's classes and is not read here:
`convert.py` carries a JAX state across.

Loading clamps each object slot's active-tier count to
`cfg.object_active_capacity` and clears the rows past it (ROADMAP C2: the
JAX engine clamps only where it slices, cofusion_tpu/engine.py:1455-1462,
so a state from a larger slice keeps orphan rows there).
"""

from __future__ import annotations

import numpy as np
import torch

from cofusion_tpu_torch.engine import EngineState, ModelState
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.models.surfel_model import SurfelStore
from cofusion_tpu_torch.ops.ferns import FernDB
from cofusion_tpu_torch.ops.rasterize import SplatMap
from cofusion_tpu_torch.parallel.mesh import unshard_engine_state

VERSION = 1

# the nested records of the state; `fern_db` is a () placeholder tensor
# without relocalisation, and then stored as a leaf
_NESTED = {
    (EngineState, "models"): ModelState,
    (ModelState, "store"): SurfelStore,
    (ModelState, "stable"): SurfelStore,
    (EngineState, "fern_db"): FernDB,
    (EngineState, "pred"): SplatMap,
}


def _leaf(t):
    """A tensor that owns its storage as it is (a view is copied, so the
    file holds no more than the view)."""
    if not isinstance(t, torch.Tensor):
        return t
    t = t.detach()
    whole = t.is_contiguous() and t.storage_offset() == 0 and (
        t.untyped_storage().nbytes() == t.numel() * t.element_size()
    )
    return t if whole else t.clone(memory_format=torch.contiguous_format)


def flatten_state(tree, prefix: str = "") -> dict:
    """{dotted field path: tensor (or the int tick)} of a state record."""
    out = {}
    for name, value in zip(tree._fields, tree):
        if isinstance(value, tuple):
            out.update(flatten_state(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = _leaf(value)
    return out


def unflatten_state(flat: dict, cls=EngineState, prefix: str = ""):
    """The record `cls` back from `flatten_state`'s dict."""
    values = []
    for name in cls._fields:
        key = prefix + name
        if key in flat:
            values.append(flat[key])
        else:
            values.append(unflatten_state(flat, _NESTED[(cls, name)], key + "."))
    return cls(*values)


def clamp_object_slices(state: EngineState, cap: int) -> EngineState:
    """Object slots (m > 0) hold at most `cap` active-tier rows: their count
    is clamped to it and the rows past it cleared (valid false, data zero)."""
    store = state.models.store
    M, A = store.px.shape
    if M == 1 or cap >= A:
        return state
    dev = store.count.device
    obj = torch.arange(M, device=dev) > 0
    orphan = obj[:, None] & (torch.arange(A, device=dev) >= cap)[None, :]
    fields = {f: torch.where(orphan, 0.0, getattr(store, f)) for f in sm.DATA_FIELDS[:-1]}
    store = SurfelStore(
        **fields,
        valid=store.valid & ~orphan,
        count=torch.where(obj, torch.clamp(store.count, max=cap), store.count),
    )
    return state._replace(models=state.models._replace(store=store))


def _host(engine) -> dict:
    """The engine's host-side bookkeeping as plain values and tensors."""
    return {
        "used_slots": sorted(engine._used_slots),
        "ever_active": sorted(engine._ever_active),
        "active_snapshot": sorted(engine._active_snapshot),
        "gt_mapping": sorted(engine._gt_mapper.mapping.items()),
        "host_unseen": sorted(engine._host_unseen.items()),
        "host_cooldown": engine._host_cooldown,
        "masks_drained": engine._masks_drained,
        "flushed_poses": (torch.from_numpy(np.stack(engine._flushed_poses))
                          if engine._flushed_poses else None),
    }


def save_engine(engine, path: str) -> None:
    """Save the engine; a sharded state is gathered whole first (resume
    loads it whole, and `parallel.shard_engine_state` shards it again)."""
    torch.save(
        {"state": flatten_state(unshard_engine_state(engine.state)),
         "timestamps": list(engine._timestamps),
         "host": _host(engine), "version": VERSION},
        path,
    )


def load_engine(engine, path: str) -> None:
    """Restore a checkpoint into an engine built with the SAME configuration,
    on the engine's device, with the host's bookkeeping; slots active in the
    state count as used and ever active (as the JAX package rebuilds them)."""
    blob = torch.load(path, weights_only=True, map_location=engine.device)
    if blob.get("version") != VERSION:
        raise ValueError(f"{path}: checkpoint version {blob.get('version')}, expected {VERSION}")
    state = unflatten_state(blob["state"])
    engine.state = clamp_object_slices(state, engine.cfg.object_active_capacity)
    engine._timestamps = [int(t) for t in blob["timestamps"]]
    host = blob["host"]
    engine._used_slots = set(host["used_slots"])
    engine._ever_active = set(host["ever_active"])
    engine._active_snapshot = set(host["active_snapshot"])
    engine._gt_mapper.mapping = {int(k): int(v) for k, v in host["gt_mapping"]}
    engine._host_unseen = {int(k): int(v) for k, v in host["host_unseen"]}
    engine._host_cooldown = int(host["host_cooldown"])
    engine._masks_drained = int(host["masks_drained"])
    flushed = host["flushed_poses"]
    engine._flushed_poses = [] if flushed is None else list(flushed.cpu().numpy())
    active = state.models.active.cpu().numpy()
    for s in range(1, len(active)):
        if active[s]:
            engine._used_slots.add(s)
            engine._ever_active.add(s)
