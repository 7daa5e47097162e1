"""Carry engine state between the JAX reference and the port.

The map and pose are the system's "weights": converting the JAX engine's
state lets a test start both packages from the identical mid-sequence map
and compare ONE step, so a per-step divergence shows before frames compound
it.  The port never imports JAX; the caller hands over plain numpy trees,
e.g. `jax.tree.map(np.asarray, engine.state)` (NamedTuples are tuples, so
positional access works on both sides).

Both engines keep the same state fields in the same order
(engine.EngineState / ModelState, models.surfel_model.SurfelStore,
ops.rasterize.SplatMap, ops.ferns.FernDB); the only difference is the
tick, a host int here.  `fern_db` is a FernDB under relocalisation and a
scalar placeholder otherwise, in both engines; a JAX database brings its
own random probes across (ROADMAP C9).
"""

from __future__ import annotations

import numpy as np
import torch

from cofusion_tpu_torch.engine import EngineState, ModelState
from cofusion_tpu_torch.models.surfel_model import SurfelStore
from cofusion_tpu_torch.ops.ferns import FernDB
from cofusion_tpu_torch.ops.rasterize import SplatMap
from cofusion_tpu_torch.parallel.mesh import unshard_engine_state


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def store_from_numpy(tree, device: str | torch.device = "cpu") -> SurfelStore:
    """SurfelStore from a tuple of numpy arrays in SurfelStore field order."""
    return SurfelStore(*(_tensor(a, device) for a in tree))


def store_to_numpy(store: SurfelStore) -> SurfelStore:
    """The same store with numpy leaves."""
    return SurfelStore(*(_numpy(a) for a in store))


def state_from_numpy(tree, device: str | torch.device = "cpu") -> EngineState:
    """EngineState from the JAX engine's state as a nested tuple of numpy
    arrays (EngineState field order)."""
    models = tree[0]
    m = ModelState(
        store_from_numpy(models[0], device),
        store_from_numpy(models[1], device),
        *(_tensor(a, device) for a in models[2:]),
    )
    rest = [fern_db_from_numpy(a, device) if i == _FERN else _tensor(a, device)
            for i, a in enumerate(tree[2:-1], start=2)]
    pred = SplatMap(*(_tensor(a, device) for a in tree[-1]))
    return EngineState(m, int(np.asarray(tree[1])), *rest, pred)


def state_to_numpy(state: EngineState) -> EngineState:
    """The same nested structure with numpy leaves (the tick as int32); a
    sharded state's tiers gathered whole."""
    models = unshard_engine_state(state).models
    m = ModelState(
        store_to_numpy(models.store),
        store_to_numpy(models.stable),
        *(_numpy(a) for a in models[2:]),
    )
    rest = [fern_db_to_numpy(a) if i == _FERN else _numpy(a)
            for i, a in enumerate(state[2:-1], start=2)]
    return EngineState(m, np.int32(state.tick), *rest, SplatMap(*(_numpy(a) for a in state.pred)))


_FERN = EngineState._fields.index("fern_db")


def fern_db_from_numpy(tree, device: str | torch.device = "cpu"):
    """FernDB from a tuple of numpy arrays in FernDB field order, or the
    scalar placeholder of an engine without relocalisation."""
    if isinstance(tree, tuple):
        return FernDB(*(_tensor(a, device) for a in tree))
    return _tensor(tree, device)


def fern_db_to_numpy(db):
    if isinstance(db, FernDB):
        return FernDB(*(_numpy(a) for a in db))
    return _numpy(db)
