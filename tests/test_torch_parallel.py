"""cofusion_tpu_torch/parallel — the surfel-axis sharding of the port's
engine state over a device mesh — on the CPU, at n = 1, 2 and 8 shards
(CPU shards, the counterpart of the JAX tests' 8 virtual CPU devices).

  (a) the mesh helpers (tests/test_parallel.py::test_mesh_helpers'
      counterpart), the refusals: too few cards without `virtual`, a
      tier capacity the mesh does not divide ('-rl', '-cl' and
      `render_views` on a sharded state are held to the unsharded port in
      tests/test_torch_parallel_loop.py);
  (b) each sharded primitive against the unsharded port, bit for bit, on
      cases built to cross shard boundaries: the z-buffer render (packed
      keys and the two-pass form above 2^19 surfels, depth ties across
      shards), a fuse whose append straddles shards and one that
      overflows, then its overlay, clean and expel; compact, expel_split
      and append moving rows between shards; a stable-ring write that
      straddles; slot recycling and an object slice that ends inside a
      shard;
  (c) `__graft_entry__.dryrun_multichip`'s two graphs — one static step
      (`:73-89`) and the 7-step teleport CRF run at 160x128, 2^13 surfels,
      3 slots, superpixel 8, the last step at time_delta = 0 (`:91-204`) —
      through `_step` and through `CoFusion.process_frame` on a state
      sharded by `shard_engine_state`: poses, counts, active flags, every
      gathered store leaf, the step outputs, the listener events and the
      read-outs equal the unsharded port's bit for bit (the JAX package
      holds its sharded run to 1e-5 + 2e-6 per step: it splits image rows);
  (d) the port's unsharded run of that scenario against the JAX package's
      unsharded `_step`, jitted as the dryrun jits it, from the port's
      first-frame state: ROADMAP C8's bars (each step of the JAX package
      from the port's state within 1e-5 x max(1, condition / 1e2) per
      slot, counts and active flags exact; the whole runs within
      (1e-5 + 2e-6 step) x max(1, condition / 1e2) plus the reference's
      own response).  So JAX sharded ~ JAX unsharded ~ port = port
      sharded.  JAX's sharded step is not run here: it aborts in XLA on a
      warm compilation cache (ROADMAP C7).

The unsharded reference run is computed once per test session, by
whichever test asks first on any worker, and shared with the others
through the session's temporary directory (tests/torch_shared.py): no test
depends on another's having run.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu import engine as jeng_mod
from cofusion_tpu.config import CameraConfig as JCameraConfig
from cofusion_tpu.config import CoFusionConfig as JCoFusionConfig
from cofusion_tpu.config import FusionParams as JFusionParams
from cofusion_tpu.models.surfel_model import SurfelStore as JSurfelStore
from cofusion_tpu.ops.rasterize import SplatMap as JSplatMap
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch import engine as te
from cofusion_tpu_torch.io.synthetic import SyntheticScene, camera_trajectory, object_trajectory
from cofusion_tpu_torch.models import surfel_model as sm
from cofusion_tpu_torch.ops import fusion as fu
from cofusion_tpu_torch.ops import odometry as tod
from cofusion_tpu_torch.ops import rasterize as rz
from cofusion_tpu_torch.parallel import (
    Mesh, make_mesh, shard_engine_state, shard_frame, unshard_engine_state,
)
from cofusion_tpu_torch.utils import checkpoint

from torch_shared import shared  # noqa: F401  (a fixture)

torch.set_num_threads(1)
SHARDS = [1, 2, 8]
CAM = tcfg.CameraConfig(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)
N_STEPS = 7
CRF_FUSION = dict(depth_cutoff=4.5, confidence_global=1.5, confidence_object=0.01,
                  model_spawn_offset=2, model_deactivate_count=3)


def _np(x):
    return np.array(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, copy=True)


def _assert_same(a, b, path="state"):
    """Exact equality of two records (NamedTuples of tensors or arrays)."""
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), path
        names = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(names, a, b):
            _assert_same(x, y, f"{path}.{name}")
        return
    x, y = _np(a), _np(b)
    assert x.dtype == y.dtype and x.shape == y.shape, (path, x.dtype, y.dtype, x.shape, y.shape)
    np.testing.assert_array_equal(x, y, err_msg=path)


def _snapshot(state):
    """A numpy copy of a (possibly sharded) port state, tiers gathered."""
    return jax.tree.map(lambda a: np.array(a, copy=True), convert.state_to_numpy(state))


def _cpu_mesh(n):
    return make_mesh(n, "cpu")


def _is_sharded(state):
    return isinstance(state.models.store, sm.ShardedStore)


# ---------------------------------------------------------------------------
# (a) the mesh helpers


@pytest.mark.parametrize("n", SHARDS)
def test_mesh_helpers(n, monkeypatch):
    mesh = _cpu_mesh(n)
    assert isinstance(mesh, Mesh) and len(mesh.devices) == n
    assert mesh.distinct_devices == (torch.device("cpu"),)
    frame = np.arange(128 * 160, dtype=np.float32).reshape(128, 160)
    rgb, depth = shard_frame(mesh, frame[..., None].repeat(3, -1), torch.from_numpy(frame))
    assert depth.device == mesh.devices[0] and torch.equal(depth, torch.from_numpy(frame))
    assert rgb.shape == (128, 160, 3)

    store = sm.empty_store(8 * n, torch.device("cpu"))
    sharded = sm.shard_store(store, mesh.devices)
    assert [s.capacity for s in sharded.shards] == [8] * n
    assert sharded.offsets == tuple(range(0, 8 * n, 8))
    _assert_same(sm.gathered(sharded), store)
    if n > 1:
        with pytest.raises(ValueError, match="not divisible"):
            sm.shard_store(sm.empty_store(8 * n + 1, torch.device("cpu")), mesh.devices)

    # cards: never a quiet fall back to the CPU; too few cards raise unless
    # the mesh is virtual
    with pytest.raises(RuntimeError):
        make_mesh(n, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: max(1, n - 1))
    if n > 1:
        with pytest.raises(RuntimeError, match="virtual=True"):
            make_mesh(n, "cuda")
    virt = make_mesh(n, "cuda", virtual=True)
    assert virt.devices == tuple(torch.device("cuda", k % max(1, n - 1)) for k in range(n))
    assert len(virt.distinct_devices) == min(n, max(1, n - 1))


def _static_engine():
    """`__graft_entry__._make_engine_and_frame(max_surfels=1 << 13)` in the
    port: the first frame processed, the second frame's arrays."""
    cfg = tcfg.CoFusionConfig(camera=CAM, max_models=1, max_surfels=1 << 13)
    eng = te.CoFusion(cfg, fusion_params=tcfg.FusionParams(depth_cutoff=4.5), device="cpu")
    scene = SyntheticScene()
    rgb, depth, mask = scene.render(CAM, np.eye(4))
    eng.process_frame({"rgb": rgb, "depth": depth, "mask": mask, "timestamp": 0})
    rgb2, depth2, _ = scene.render(CAM, np.eye(4))
    return eng, rgb2, depth2


def _fparams(eng, **kw):
    return dict(eng._fparams, weight_multiplier=1.0, new_slot=-1, allow_new=False, gt_masks=False,
                **kw)


@pytest.mark.parametrize("n", SHARDS)
def test_sharded_state_refuses_what_is_not_ported(n):
    """The one layout the port does not shard: a tier capacity the mesh
    size does not divide (uneven blocks).  '-rl', '-cl' and `render_views`
    take a sharded state: tests/test_torch_parallel_loop.py."""
    eng, _, _ = _static_engine()
    eng.state = shard_engine_state(eng.state, _cpu_mesh(n))
    assert _is_sharded(eng.state)
    if n > 1:
        bad = eng.state._replace(models=eng.state.models._replace(
            store=sm.gathered(eng.state.models.store)._replace(
                **{f: getattr(sm.gathered(eng.state.models.store), f)[..., :-1]
                   for f in sm.DATA_FIELDS})))
        with pytest.raises(ValueError, match="not divisible"):
            shard_engine_state(bad, _cpu_mesh(n))


# ---------------------------------------------------------------------------
# (b) the sharded primitives against the unsharded port


def _random_store(rng, n, count, cam, z_levels=None, spread=False):
    """A store of `n` rows, the first `count` valid (with `spread`, `count`
    rows anywhere), scattered in front of `cam` so that many surfels share
    a pixel; `z_levels` quantises depth so that equal keys meet across
    shards."""
    z = rng.uniform(0.6, 3.0, n)
    if z_levels is not None:
        z = np.round(z * z_levels) / z_levels
    u = rng.uniform(-2, cam.width + 2, n)
    v = rng.uniform(-2, cam.height + 2, n)
    fields = {
        "px": (u - cam.cx) * z / cam.fx, "py": (v - cam.cy) * z / cam.fy, "pz": z,
        "nx": rng.normal(size=n) * 0.2, "ny": rng.normal(size=n) * 0.2, "nz": -np.ones(n),
        "cr": rng.uniform(0, 255, n), "cg": rng.uniform(0, 255, n), "cb": rng.uniform(0, 255, n),
        "radius": rng.uniform(0.002, 0.02, n), "conf": rng.uniform(0, 12, n),
        "init_time": rng.integers(1, 5, n).astype(np.float64),
        "last_time": rng.integers(1, 9, n).astype(np.float64),
    }
    valid = np.arange(n) < count
    if spread:
        valid = rng.permutation(valid)
    out = {f: torch.from_numpy(np.where(valid, v, 0.0).astype(np.float32)) for f, v in fields.items()}
    return sm.SurfelStore(**out, valid=torch.from_numpy(valid),
                          count=torch.tensor(count, dtype=torch.int32))


@pytest.mark.parametrize("n", SHARDS)
def test_predict_indices_sharded(n):
    rng = np.random.default_rng(10 + n)
    cam = tcfg.CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0, cy=8.0)
    pose = torch.eye(4)
    pose[:3, 3] = torch.tensor([0.01, -0.02, 0.03])
    mesh = _cpu_mesh(n)
    # packed keys (2^11 rows, ties by quantised depth) and the exact
    # two-pass form above 2^19 rows
    for cap, count, levels in ((1 << 11, 1900, 20), ((1 << 20) + (1 << 13), 6000, 40)):
        store = _random_store(rng, cap, count, cam, levels, spread=True)
        for kw in ({}, {"conf_threshold": torch.tensor(4.0)}, {"active_window": False}):
            ref = rz.predict_indices(store, pose, cam, 8, 4, torch.tensor(2.5), **kw)
            got = rz.predict_indices(sm.shard_store(store, mesh.devices), pose, cam, 8, 4,
                                     torch.tensor(2.5), **kw)
            _assert_same(got, ref, f"imap cap={cap} {kw}")
        # winners from every shard
        assert len(torch.unique(ref.index[ref.valid] // (cap // n))) == n


def _fuse_inputs(cap):
    """A map initialised from one frame at 32x24 and the next frame, moved."""
    cam = tcfg.CameraConfig(width=32, height=24, fx=26.0, fy=26.0, cx=16.0, cy=12.0)
    cfg = tcfg.CoFusionConfig(camera=cam, max_models=1, max_surfels=cap)
    scene = SyntheticScene()
    poses = camera_trajectory(6, kind="orbit", scale=1.0)
    f0 = scene.render(cam, poses[0])
    f1 = scene.render(cam, poses[3])
    d0 = torch.from_numpy(f0[1])
    fs0 = fu.make_frame_surfels(d0, d0, torch.from_numpy(f0[0]).float(), cam, 1.0, 4.5)
    store = fu.initialise(fs0, torch.eye(4), cap, time=1)
    d1 = torch.from_numpy(f1[1])
    fs1 = fu.make_frame_surfels(d1, d1, torch.from_numpy(f1[0]).float(), cam, 1.0, 4.5)
    return cam, cfg, store, fs1, d1, torch.from_numpy(poses[3]).float()


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("cap,kept", [(1024, 500), (784, 784)])
def test_fuse_clean_expel_sharded(n, cap, kept):
    """predict -> fuse -> overlay -> clean -> expel, sharded against
    unsharded.  500 of 1024 rows kept puts the append cursor just below
    the middle (a shard boundary at n = 2 and 8), so the ~30 appended rows
    straddle shards; the whole first frame (768 surfels) in 784 rows
    makes the append overflow and drop rows."""
    cam, cfg, store, fs, depth, pose = _fuse_inputs(cap)
    rng = np.random.default_rng(3)
    keep = rng.random(cap) < 0.7
    keep = torch.from_numpy(keep & (np.cumsum(keep) <= kept)) if kept < cap else store.valid
    store = sm.compact(store, keep)
    mesh = _cpu_mesh(n)
    tick, td = 4, 2
    mask = torch.from_numpy(rng.integers(0, 2, cam.shape).astype(np.int32))

    def run(st):
        imap = rz.predict_indices(st, pose, cam, tick, 200, 4.5)
        fused, aux = fu.fuse(st, fs, depth, imap, torch.ones(cam.shape, dtype=torch.bool), pose,
                             cam, cfg, tick, 4.5, return_aux=True)
        imap2 = fu.overlay_imap(fused, imap, aux, fs, pose, cam, tick)
        cleaned, keep = fu.clean_eval(fused, imap2, depth, pose, cam, tick, td, torch.tensor(2.0),
                                      0.7, mask=mask, mask_id=torch.tensor(1, dtype=torch.int32))
        aged = sm.per_shard(cleaned, lambda s: (s.last_time > 0) & ((tick - s.last_time) > td))
        out, blk = sm.expel_split(cleaned, keep, aged, 96)
        keep = torch.cat(keep) if isinstance(keep, tuple) else keep
        return imap, fused, aux, imap2, sm.gathered(cleaned), keep, sm.gathered(out), blk

    ref = run(store)
    got = run(sm.shard_store(store, mesh.devices))
    names = ("imap", "fused", "aux", "overlay", "cleaned", "keep", "active", "block")
    for name, g, r in zip(names, got, ref):
        _assert_same(sm.gathered(g) if name == "fused" else g, r, name)
    before, after = int(store.count), int(ref[1].count)
    assert after > before
    if kept < cap:
        assert before < cap // 2 < after, (before, after)  # the append crosses shards
    else:
        assert after == cap and int(ref[2].new_s.sum()) > cap - before  # rows dropped
    assert int(ref[7].count) > 0


@pytest.mark.parametrize("n", SHARDS)
def test_compact_sharded(n):
    rng = np.random.default_rng(20 + n)
    cam = tcfg.CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0, cy=8.0)
    store = _random_store(rng, 1024, 900, cam)
    mesh = _cpu_mesh(n)
    for frac in (0.0, 0.3, 1.0):
        keep = torch.from_numpy(rng.random(1024) < frac)
        sh = sm.shard_store(store, mesh.devices)
        ref = sm.compact(store, keep)
        got = sm.compact(sh, sm.per_shard(sh, lambda s, k=keep: k[_rows(sh, s)]))
        _assert_same(sm.gathered(got), ref, f"compact {frac}")


def _rows(sharded, shard):
    """The global row slice of one shard."""
    k = [id(s) for s in sharded.shards].index(id(shard))
    off = sharded.offsets[k]
    return slice(off, off + shard.capacity)


@pytest.mark.parametrize("n", SHARDS)
def test_expel_split_sharded(n):
    rng = np.random.default_rng(30 + n)
    cam = tcfg.CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0, cy=8.0)
    store = _random_store(rng, 1024, 1000, cam)
    mesh = _cpu_mesh(n)
    for block, frac in ((64, 0.5), (512, 0.2), (1024, 0.0)):
        keep = torch.from_numpy(rng.random(1024) < 0.8)
        expel = torch.from_numpy(rng.random(1024) < frac)
        sh = sm.shard_store(store, mesh.devices)
        ref_a, ref_b = sm.expel_split(store, keep, expel, block)
        got_a, got_b = sm.expel_split(sh, sm.per_shard(sh, lambda s: keep[_rows(sh, s)]),
                                      sm.per_shard(sh, lambda s: expel[_rows(sh, s)]), block)
        _assert_same(sm.gathered(got_a), ref_a, f"stay {block}")
        _assert_same(got_b, ref_b, f"block {block}")


@pytest.mark.parametrize("n", SHARDS)
def test_append_sharded(n):
    rng = np.random.default_rng(40 + n)
    cam = tcfg.CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0, cy=8.0)
    mesh = _cpu_mesh(n)
    new = _random_store(rng, 300, 300, cam)
    for count in (100, 450, 900):  # inside a shard, across shards, overflowing
        store = _random_store(rng, 1024, count, cam)
        new_mask = torch.from_numpy(rng.random(300) < 0.7)
        ref = sm.append(store, new, new_mask)
        got = sm.append(sm.shard_store(store, mesh.devices), new, new_mask)
        _assert_same(sm.gathered(got), ref, f"append at {count}")


@pytest.mark.parametrize("n", SHARDS)
def test_stable_ring_write_sharded(n):
    """`_append_expel_blocks`: slot 0 writes 64 rows at ring row 100 (they
    straddle the shards of 128 and 32 rows), slot 1's cursor skips to the
    ring's start (its tail is shorter than a block), slot 2 expels nothing
    (its window is written back unchanged)."""
    rng = np.random.default_rng(50 + n)
    cfg = tcfg.CoFusionConfig(camera=CAM, max_models=3, max_surfels=256, expel_block_log2=6)
    assert cfg.expel_block == 64
    cam = tcfg.CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0, cy=8.0)
    rings = [_random_store(rng, 256, 256, cam) for _ in range(3)]
    stables = te._stack(rings)._replace(count=torch.tensor([100, 250 + 256, 37], dtype=torch.int32))
    blocks = [_random_store(rng, 64, c, cam) for c in (40, 64, 0)]
    blks = te._stack(blocks)._replace(count=torch.tensor([40, 64, 0], dtype=torch.int32))
    sharded = sm.shard_store(stables, _cpu_mesh(n).devices)
    ref = te._append_expel_blocks(te._stack(rings)._replace(count=stables.count), blks, cfg)
    got = te._append_expel_blocks(sharded, blks, cfg)
    _assert_same(sm.gathered(got), ref, "ring")
    assert not torch.equal(ref.px[0, 100:164], stables.px[0, 100:164])
    assert torch.equal(ref.px[2], stables.px[2])


@pytest.mark.parametrize("n", SHARDS)
def test_slot_recycle_and_object_slice_sharded(n):
    rng = np.random.default_rng(60 + n)
    cam = tcfg.CameraConfig(width=24, height=16, fx=20.0, fy=20.0, cx=12.0, cy=8.0)
    stores = te._stack([_random_store(rng, 256, c, cam) for c in (250, 90, 40)])
    sharded = sm.shard_store(stores, _cpu_mesh(n).devices)
    rs = torch.tensor([False, True, False])
    _assert_same(sm.gathered(te._reset_slots(sharded, rs)), te._reset_slots(stores, rs), "recycle")

    # an object slice of 100 rows ends inside a shard for n = 2 and 8
    ref_view = te._slot_store(stores, 1, 100, stores.count[1])
    view = te._slot_store(sharded, 1, 100, stores.count[1])
    assert view.capacity == 100 and len(view.shards) == -(-100 // (256 // n))
    _assert_same(sm.gathered(view), ref_view, "slice")
    new = _random_store(rng, 100, 60, cam)
    te._write_slot(stores, 1, new)
    parts = [new._replace(**{f: getattr(new, f)[o:o + s.capacity] for f in sm.DATA_FIELDS},
                          count=None) for s, o in zip(view.shards, view.offsets)]
    te._write_slot(sharded, 1, sm.ShardedStore(tuple(parts), new.count))
    _assert_same(sm.gathered(sharded)._replace(count=stores.count), stores, "write-back")


# ---------------------------------------------------------------------------
# (c) the dryrun's two graphs, sharded against unsharded


@pytest.mark.parametrize("n", SHARDS)
def test_static_step_sharded(n):
    """Graph 1: one static step, through `_step` and `process_frame`."""
    eng, rgb, depth = _static_engine()
    init = _snapshot(eng.state)
    args = (torch.from_numpy(rgb.astype(np.float32)), torch.from_numpy(depth),
            torch.zeros(CAM.shape, dtype=torch.int32), _fparams(eng))
    kw = dict(cam=CAM, cfg=eng.cfg, tparams=eng.tracking)
    ref_state, ref_out = te._step(convert.state_from_numpy(init), *args, **kw)
    mesh = _cpu_mesh(n)
    state = shard_engine_state(convert.state_from_numpy(init), mesh)
    got_state, got_out = te._step(state, *shard_frame(mesh, *args[:3]), args[3], **kw)
    assert _is_sharded(got_state)
    _assert_same(got_out, ref_out, "outputs")
    _assert_same(_snapshot(got_state), _snapshot(ref_state))

    eng.state = shard_engine_state(eng.state, mesh)
    eng.process_frame({"rgb": rgb, "depth": depth, "mask": None, "timestamp": 1})
    _assert_same(_snapshot(eng.state), _snapshot(ref_state))
    assert int(ref_state.models.store.count[0]) > 0


def _teleport():
    """The dryrun's second graph: a tilted box that teleports at step 4."""
    scene = SyntheticScene(seed=3)
    h = 0.28
    scene.add_moving_box(model_id=1, lo=[-h, -h, -h], hi=[h, h, h])
    base = object_trajectory(1, translation=(0, 0, 0), center=(0.14, -0.32, 1.82),
                             tilt=(0.35, 0.5, 0.0))[0]
    jump = np.eye(4)
    jump[:3, 3] = (0.40, 0.18, 0.0)
    cam_poses = camera_trajectory(N_STEPS + 1, kind="orbit", scale=0.4)
    obj = [base.copy() if i < 4 else jump @ base for i in range(N_STEPS + 1)]
    return [scene.render(CAM, cam_poses[i], object_poses={1: obj[i]})[:2] for i in range(N_STEPS + 1)]


def _crf_engine():
    cfg = tcfg.CoFusionConfig(camera=CAM, max_models=3, max_surfels=1 << 13, superpixel_size=8)
    return te.CoFusion(cfg, fusion_params=tcfg.FusionParams(**CRF_FUSION), enable_multi_model=True,
                       device="cpu")


def _play(eng, frames, on_first=None):
    """process_frame over the teleport frames (the last at time_delta = 0)
    with listeners; per frame the stats and the step's outputs."""
    events = []
    eng.add_new_model_listener(lambda s: events.append((len(log), "new", s)))
    eng.add_inactive_model_listener(lambda s: events.append((len(log), "inactive", s)))
    log, outs, snaps = [], [], []
    for i, (rgb, depth) in enumerate(frames):
        if i == N_STEPS:
            eng._fparams["time_delta"] = 0
        eng.process_frame({"rgb": rgb, "depth": depth, "mask": None, "timestamp": i})
        if i == 0:
            if on_first is not None:
                on_first(eng)
            snaps.append(_snapshot(eng.state))
            continue
        st = eng.stats()
        log.append(tuple(np.array(st[k]) for k in ("poses", "active", "surfel_counts")))
        outs.append(jax.tree.map(_np, eng._last_outputs))
        snaps.append(_snapshot(eng.state))
    eng.flush_lifecycle()
    return log, outs, snaps, events


def _reference(shared):
    return shared.get("parallel_crf_reference", _compute_reference)


def _compute_reference():
    """The unsharded port's teleport run through process_frame, with the
    condition number of every slot's final 6x6 system in each step."""
    frames = _teleport()
    systems = []
    track = tod.track_models

    def tracked(*a, **kw):
        res = track(*a, **kw)
        systems.append(res.A)
        return res

    tod.track_models = tracked
    try:
        eng = _crf_engine()
        fparams = _fparams(eng)  # before the last frame sets time_delta = 0
        log, outs, snaps, events = _play(eng, frames)
    finally:
        tod.track_models = track
    kappa = [np.nan_to_num(np.linalg.cond(A.double().numpy()), nan=1.0, posinf=1.0)
             for A in systems]
    reads = {m: eng.download_model(m) for m in range(3)}
    counts = [eng.surfel_count(m) for m in range(3)]
    return dict(frames=frames, log=log, outs=outs, snaps=snaps, events=events, kappa=kappa,
                reads=reads, counts=counts, fparams=fparams, seg=eng.segmentation,
                tracking=eng.tracking, cfg=eng.cfg)


def test_reference_run_spawns_and_expels(shared):
    ref = _reference(shared)
    assert any(o.spawned for o in ref["outs"]) and ref["log"][-1][1][1:].any()
    assert ("new", 1) in [e[1:] for e in ref["events"]]
    assert (ref["snaps"][-1].models.stable.count > 0).any()  # the time_delta = 0 step expelled


@pytest.mark.parametrize("n", SHARDS)
def test_crf_run_sharded_step(n, shared):
    """Graph 2 through `_step`: every step's outputs and whole state."""
    ref = _reference(shared)
    mesh = _cpu_mesh(n)
    state = shard_engine_state(convert.state_from_numpy(ref["snaps"][0]), mesh)
    for k in range(1, N_STEPS + 1):
        rgb, depth = ref["frames"][k]
        fp = dict(ref["fparams"], time_delta=0) if k == N_STEPS else ref["fparams"]
        state, out = te._step(
            state, *shard_frame(mesh, rgb.astype(np.float32), depth, np.zeros(CAM.shape, np.int32)),
            fp, cam=CAM, cfg=ref["cfg"], tparams=ref["tracking"], sparams=ref["seg"], use_crf=True,
        )
        assert _is_sharded(state) and len(state.models.stable.shards) == n
        _assert_same(jax.tree.map(_np, out), ref["outs"][k - 1], f"outputs, step {k}")
        _assert_same(_snapshot(state), ref["snaps"][k], f"step {k}")


@pytest.mark.parametrize("n", SHARDS)
def test_crf_run_sharded_process_frame(n, tmp_path, shared):
    """Graph 2 through `process_frame` after `eng.state =
    shard_engine_state(eng.state, mesh)`: stats, outputs, listener events,
    whole states and the read-outs; a checkpoint of the sharded engine
    resumes whole."""
    ref = _reference(shared)
    mesh = _cpu_mesh(n)

    def shard(eng):
        eng.state = shard_engine_state(eng.state, mesh)

    eng = _crf_engine()
    log, outs, snaps, events = _play(eng, ref["frames"], on_first=shard)
    assert _is_sharded(eng.state)
    assert events == ref["events"]
    for k, (got, want) in enumerate(zip(log, ref["log"]), start=1):
        _assert_same(got, want, f"stats, frame {k}")
    _assert_same(outs, ref["outs"], "outputs")
    _assert_same(snaps, ref["snaps"])
    assert [eng.surfel_count(m) for m in range(3)] == ref["counts"]
    for m in range(3):
        got = eng.download_model(m)
        assert got.keys() == ref["reads"][m].keys()
        for key in got:
            np.testing.assert_array_equal(got[key], ref["reads"][m][key], err_msg=f"{m} {key}")
    assert len(eng.materialized_pose_log()) == N_STEPS + 1

    path = str(tmp_path / "sharded.ckpt")
    checkpoint.save_engine(eng, path)
    whole = _crf_engine()
    checkpoint.load_engine(whole, path)
    assert not _is_sharded(whole.state)
    _assert_same(_snapshot(whole.state), ref["snaps"][-1])
    _assert_same(_snapshot(unshard_engine_state(eng.state)), ref["snaps"][-1])


# ---------------------------------------------------------------------------
# (d) the unsharded port against the JAX package's unsharded step


def _jax_state(snap):
    """The JAX EngineState of a port state snapshot (numpy leaves)."""
    m = snap.models
    models = jeng_mod.ModelState(
        JSurfelStore(*map(jnp.asarray, m.store)), JSurfelStore(*map(jnp.asarray, m.stable)),
        *map(jnp.asarray, m[2:]),
    )
    return jeng_mod.EngineState(models, jnp.asarray(snap.tick), *map(jnp.asarray, snap[2:-1]),
                                JSplatMap(*map(jnp.asarray, snap.pred)))


def test_unsharded_port_matches_jax_step(shared):
    ref = _reference(shared)
    jcam = JCameraConfig(**dataclasses.asdict(CAM))
    jcfg = JCoFusionConfig(camera=jcam, max_models=3, max_surfels=1 << 13, superpixel_size=8)
    jeng = jeng_mod.CoFusion(jcfg, fusion_params=JFusionParams(**CRF_FUSION), enable_multi_model=True)
    step = jax.jit(functools.partial(jeng_mod._step, cam=jcam, cfg=jcfg, tparams=jeng.tracking,
                                     sparams=jeng.segmentation, use_crf=True))
    fp = jeng._make_fparams(1.0, -1, True, None, None)
    mask = jnp.zeros(jcam.shape, jnp.int32)

    def counts(models):
        return np.asarray(models.store.count) + np.minimum(np.asarray(models.stable.count),
                                                           models.stable.valid.shape[1])

    state = _jax_state(ref["snaps"][0])
    worst = []
    for k in range(1, N_STEPS + 1):
        rgb, depth = ref["frames"][k]
        fpk = dict(fp, time_delta=jnp.int32(0)) if k == N_STEPS else fp
        args = (jnp.asarray(rgb, jnp.float32), jnp.asarray(depth), mask, fpk)
        state, _ = step(state, *args)
        # the reference's step from the port's own state before frame k
        cross, _ = step(_jax_state(ref["snaps"][k - 1]), *args)
        tpose, tactive, tcounts = ref["log"][k - 1]
        scale = np.maximum(1.0, ref["kappa"][k - 1] / 1e2)
        cpose = np.asarray(cross.models.pose)
        step_gap = np.abs(cpose - tpose).max(axis=(1, 2))
        assert (step_gap <= 1e-5 * scale).all(), (k, step_gap, scale)
        np.testing.assert_array_equal(np.asarray(cross.models.active), tactive, err_msg=f"active {k}")
        np.testing.assert_array_equal(counts(cross.models), tcounts, err_msg=f"counts {k}")
        # the whole runs
        jpose, jcounts = np.asarray(state.models.pose), counts(state.models)
        response = np.abs(cpose - jpose).max(axis=(1, 2))
        run_gap = np.abs(tpose - jpose).max(axis=(1, 2))
        assert (run_gap <= (1e-5 + 2e-6 * k) * scale + response).all(), (k, run_gap, response, scale)
        np.testing.assert_array_equal(np.asarray(state.models.active), tactive, err_msg=f"run {k}")
        assert (tcounts == jcounts).all() or (counts(cross.models) != jcounts).any(), (k, tcounts, jcounts)
        worst.append((k, float(step_gap.max()), float(run_gap.max()), float(scale.max())))
    print("per step (step, JAX step from the port's state |d|, whole runs |d|, max(1, kappa/1e2)):",
          worst)
    assert np.asarray(state.models.active)[1:].any() and (np.asarray(state.models.stable.count) > 0).any()
