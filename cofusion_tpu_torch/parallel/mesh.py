"""Device meshes and the sharded layout of the engine state — the
counterpart of cofusion_tpu/parallel/mesh.py, with one controller and an
explicit design where the JAX package has GSPMD.

Layout:
  * the surfel axis is sharded: every per-surfel leaf of the active tier
    `models.store` (M, A) and of the stable tier `models.stable` (M, S) is
    split into n equal contiguous blocks, shard k owning the global rows
    [k·A/n, (k+1)·A/n) on `mesh.devices[k]` (models.surfel_model.ShardedStore);
  * everything else stays whole on `mesh.devices[0]`: the per-model counts,
    poses and flags, the fern database, the carried prediction `pred` and
    every image leaf.  The step does its image-side work (preprocessing,
    tracking, segmentation, association, the window splat) there once, the
    per-surfel work (render keys, merge, append, clean, compaction, the
    stable ring write) shard by shard on the shards' devices, and each
    combine moves one buffer of (H·W) size (or one expel block) between
    devices.
  * Image rows are not split, unlike the JAX package's P("d") layout: an
    image channel is at most 1.2 MB at 640×480, and the row split turns
    every Gauss-Newton normal-equation sum into per-device partials plus a
    psum, which costs the JAX package its pose tolerance of
    1e-5 + 2e-6·step.  Nothing in the step reduces floats over the surfel
    axis (the z-buffer is an int32 minimum, the merge is per-surfel
    arithmetic, the counts are integer sums), so the sharded step equals
    the port's unsharded step bit for bit.  The port matches values, not
    layouts.

Relocalisation ('-rl') works on the frame and the fern database alone.
Loop closure ('-cl') renders through the same shard-aware z-buffer, samples
its graph nodes from both tiers' shards by global rank (no concatenation
of the tiers on one device), warps and re-stamps each shard on its own
device with the graph (a few KB) copied there, and moves refreshed stable
surfels to the active tier by the sharded expel and append;
`CoFusion.render_views` renders both sharded tiers.  All of them equal the
unsharded port bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from cofusion_tpu_torch.device import resolve_device, upload
from cofusion_tpu_torch.models import surfel_model as sm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An explicit tuple of devices along one axis; shard k lives on
    devices[k].  A virtual mesh repeats devices."""

    devices: tuple

    @property
    def distinct_devices(self) -> tuple:
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int, device: str = "cuda", *, virtual: bool = False) -> Mesh:
    """A mesh of `n_devices` shards.  On "cuda" it takes cuda:0..n-1 and
    raises where fewer cards are present, unless `virtual`, which places
    the shards round-robin on the cards there are (the counterpart of the
    JAX tests' virtual CPU devices); on "cpu", n CPU shards.  It never
    falls back to another device type."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one device, got {n_devices}")
    kind = resolve_device(device).type
    if kind == "cpu":
        return Mesh(tuple(torch.device("cpu") for _ in range(n_devices)))
    present = torch.cuda.device_count()
    if present < n_devices and not virtual:
        raise RuntimeError(
            f"make_mesh({n_devices}): only {present} CUDA device(s) present; "
            "pass virtual=True to place the shards round-robin on them"
        )
    return Mesh(tuple(torch.device("cuda", k % present) for k in range(n_devices)))


def _whole(x, dev: torch.device):
    """A copy of every tensor of a leaf or record on `dev` (the int tick as
    it is); the sharded step updates rings in place, so nothing is shared
    with the input state."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    if isinstance(x, tuple):
        return type(x)(*(_whole(a, dev) for a in x))
    return x


def shard_frame(mesh: Mesh, *arrays):
    """Place frame arrays (numpy or tensors) where the sharded step reads
    them: whole, on mesh.devices[0]."""
    dev = mesh.devices[0]
    out = tuple(a.to(dev, non_blocking=True) if isinstance(a, torch.Tensor) else upload(a, dev)
                for a in arrays)
    return out if len(out) > 1 else out[0]


def shard_engine_state(state, mesh: Mesh):
    """The EngineState with both tiers' surfel axes sharded over `mesh` and
    every other leaf copied whole to mesh.devices[0] (see the module
    docstring).  An already sharded state is gathered first.  A tier
    capacity that the mesh size does not divide raises ValueError."""
    dev = mesh.devices[0]
    models = state.models
    store = sm.shard_store(sm.gathered(models.store), mesh.devices)
    stable = sm.shard_store(sm.gathered(models.stable), mesh.devices)
    rest = _whole(models._replace(store=None, stable=None), dev)
    return _whole(state._replace(models=None), dev)._replace(
        models=rest._replace(store=store, stable=stable)
    )


def unshard_engine_state(state):
    """The EngineState with both tiers gathered whole on the counts' device
    (for stats, downloads, checkpoints and tests); an unsharded state as it
    is."""
    models = state.models
    if not isinstance(models.store, sm.ShardedStore):
        return state
    return state._replace(models=models._replace(
        store=sm.gathered(models.store), stable=sm.gathered(models.stable)
    ))
