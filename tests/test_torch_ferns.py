"""cofusion_tpu_torch/ops/ferns.py against cofusion_tpu/ops/ferns.py on the
CPU, from an identical database: the JAX conservatory (its `jax.random`
probes) is carried across, and both packages see the same 1/8-resolution
maps of tests/test_ferns.py's scenes (small_cam: 20x16 fern maps).

Bars: codes, the good mask, `added`, the slot an eviction takes, `found`,
the keyframe and every stored integer exact; the stored maps and poses
exact (copies); dissimilarities and block-HD similarities exact (the same
int counts through the same float32 division); the photometric error and
the constraint points to float32 rounding (rtol 1e-6 / atol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.io.synthetic import SyntheticScene, camera_trajectory
from cofusion_tpu.ops import ferns as jfn
from cofusion_tpu.ops import preprocess as jpp
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.ops import ferns as tfn

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(small_cam):
    cam_small = small_cam.at_level(3)
    db = jfn.new_db(small_cam, num_ferns=200, capacity=32, factor=8, seed=1)
    scene = SyntheticScene()

    def small_maps(T):
        rgb, depth, _ = scene.render(small_cam, T)
        rgb8, d = jnp.asarray(rgb, jnp.float32), jnp.asarray(depth)
        for _ in range(3):
            rgb8 = (rgb8[0::2, 0::2] + rgb8[1::2, 0::2] + rgb8[0::2, 1::2] + rgb8[1::2, 1::2]) / 4.0
            d = d[0::2, 0::2]
        vm, va = jpp.compute_vmap(d, cam_small, 10.0)
        nm, _ = jpp.compute_nmap(vm, va)
        return tuple(np.array(a) for a in (rgb8, vm, nm))

    return db, small_maps, cam_small


def _tdb(db):
    return convert.fern_db_from_numpy(tuple(np.array(a) for a in db))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _assert_db(t, j):
    for f, a, b in zip(tfn.FernDB._fields, t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)


def test_layout_matches_jax(small_cam):
    """Field order, shapes and dtypes as the JAX database's; the port's
    probes come from its own generator (ROADMAP C9), in range and seeded."""
    j = jfn.new_db(small_cam, num_ferns=64, capacity=8, seed=3)
    tcam = tcfg.CameraConfig(width=small_cam.width, height=small_cam.height)
    t = tfn.new_db(tcam, num_ferns=64, capacity=8, seed=3)
    assert tfn.FernDB._fields == jfn.FernDB._fields
    for f, a, b in zip(tfn.FernDB._fields, t, j):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[-1] == str(b.dtype), f
    for f in tfn.FernDB._fields[2:]:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    xy, rgbd = t.probe_xy.numpy(), t.probe_rgbd.numpy()
    assert (xy >= 0).all() and (xy[:, 0] < 20).all() and (xy[:, 1] < 16).all()
    assert (rgbd[:, :3] >= 0).all() and (rgbd[:, :3] <= 255).all()
    assert (rgbd[:, 3] >= 400).all() and (rgbd[:, 3] <= 5000).all()
    again = tfn.new_db(tcam, num_ferns=64, capacity=8, seed=3)
    assert torch.equal(again.probe_xy, t.probe_xy) and torch.equal(again.probe_rgbd, t.probe_rgbd)


@pytest.mark.parametrize("scale", [0.0, 6.0, 14.0])
def test_encode_matches(setup, scale):
    db, small_maps, _ = setup
    T = camera_trajectory(2, kind="orbit", scale=scale)[1].astype(np.float32) if scale else np.eye(4)
    rgb, vm, _ = small_maps(T)
    cj, gj = jfn.encode(db, jnp.asarray(rgb), jnp.asarray(vm))
    ct, gt = tfn.encode(_tdb(db), *_t(rgb, vm))
    assert ct.dtype == torch.uint8
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert int(gt.sum()) > 0 and len(np.unique(ct.numpy())) > 3


def test_encode_depth_bit_truncates(setup):
    """The depth bit compares millimetres truncated toward zero, as both
    packages' int casts do: a probe exactly at its threshold + 0.9 mm does
    not clear it."""
    db, small_maps, _ = setup
    rgb, vm, _ = small_maps(np.eye(4))
    x, y = np.asarray(db.probe_xy[0])
    thr = float(np.asarray(db.probe_rgbd)[0, 3])
    vm = vm.copy()
    vm[y, x, 2] = (np.floor(thr) + 0.9) / 1000.0
    cj, _ = jfn.encode(db, jnp.asarray(rgb), jnp.asarray(vm))
    ct, _ = tfn.encode(_tdb(db), *_t(rgb, vm))
    assert int(ct[0]) & 1 == int(cj[0]) & 1 == 0
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def _sequence(db, small_maps, poses, capacity=None):
    """add_frame over `poses` through both packages; returns the databases
    and added flags after every step, asserting them equal."""
    if capacity is not None:
        db = db._replace(**{f: getattr(db, f)[:capacity] for f in jfn.FernDB._fields[2:-1]})
    tdb = _tdb(db)
    added = []
    for i, T in enumerate(poses):
        rgb, vm, nm = small_maps(T)
        db, aj = jfn.add_frame(db, jnp.asarray(rgb), jnp.asarray(vm), jnp.asarray(nm),
                               jnp.asarray(T, jnp.float32), i)
        tdb, at = tfn.add_frame(tdb, *_t(rgb, vm, nm), torch.from_numpy(np.asarray(T, np.float32)), i)
        assert bool(at) == bool(aj), i
        _assert_db(tdb, db)
        added.append(bool(at))
    return db, tdb, added


def test_add_frame_sequence_matches(setup):
    """Novel orbit views are added, a repeated view is rejected."""
    db, small_maps, _ = setup
    poses = [T.astype(np.float32) for T in camera_trajectory(4, kind="orbit", scale=14.0)]
    _, tdb, added = _sequence(db, small_maps, poses + [poses[-1]])
    assert added[0] and not added[-1] and int(tdb.count) >= 2


def test_eviction_when_full_matches(setup):
    """A capacity-3 database evicts its least unique keyframe for each novel
    frame: the slot taken and the stored times equal JAX's at every step."""
    db, small_maps, _ = setup
    poses = camera_trajectory(6, kind="orbit", scale=40.0)
    _, tdb, added = _sequence(db, small_maps, poses, capacity=3)
    assert int(tdb.count) == 3 and sum(added) > 3
    assert max(i for i, a in enumerate(added) if a) in tdb.src_time.tolist()


def test_add_frame_allow_vetoes(setup):
    """`allow` (the engine's ~lost) keeps the database as it is."""
    db, small_maps, _ = setup
    rgb, vm, nm = small_maps(np.eye(4))
    tdb = _tdb(db)
    out, added = tfn.add_frame(tdb, *_t(rgb, vm, nm), torch.eye(4), 0, allow=torch.tensor(False))
    assert not bool(added)
    for a, b in zip(out, tdb):
        assert torch.equal(a, b)


@pytest.mark.parametrize("time,min_age", [(1000, 300), (100, 300), (1000, 5)])
def test_find_frame_matches(setup, time, min_age):
    db, small_maps, _ = setup
    pA = np.eye(4, dtype=np.float32)
    pB = camera_trajectory(2, kind="orbit", scale=16.0)[1].astype(np.float32)
    db, tdb, _ = _sequence(db, small_maps, [pA, pB])
    rgb, vm, _ = small_maps(pA)
    mj = jfn.find_frame(db, jnp.asarray(rgb), jnp.asarray(vm), time=time, min_age=min_age)
    mt = tfn.find_frame(tdb, *_t(rgb, vm), time=time, min_age=min_age)
    assert bool(mt.found) == bool(mj.found) == (time - 0 > min_age)
    assert int(mt.keyframe) == int(mj.keyframe)
    for f in tfn.FernMatch._fields[2:]:
        np.testing.assert_array_equal(getattr(mt, f).numpy(), np.asarray(getattr(mj, f)), err_msg=f)
    # the pieces it decides on
    codes, good = tfn.encode(tdb, *_t(rgb, vm))
    cj, gj = jfn.encode(db, jnp.asarray(rgb), jnp.asarray(vm))
    np.testing.assert_array_equal(
        tfn._dissimilarity(tdb, codes, good.sum(dtype=torch.int32)).numpy(),
        np.asarray(jfn._dissimilarity(db, cj, jnp.sum(gj.astype(jnp.int32)))),
    )
    np.testing.assert_array_equal(tfn.block_hd(tdb, codes, good).numpy(),
                                  np.asarray(jfn.block_hd(db, cj, gj)))


@pytest.mark.parametrize("shift", [0.0, 0.05, 0.4])
def test_photometric_check_matches(setup, shift):
    db, small_maps, cam_small = setup
    T = np.eye(4, dtype=np.float32)
    rgb, vm, nm = small_maps(T)
    db, tdb, _ = _sequence(db, small_maps, [T])
    est = T.copy()
    est[0, 3] = shift
    ej = float(jfn.photometric_check(db, jnp.asarray(vm), jnp.asarray(rgb), jnp.asarray(est),
                                     jnp.asarray(T), jnp.asarray(rgb), cam_small, 5.0))
    tcam = tcfg.CameraConfig(width=cam_small.width, height=cam_small.height, fx=cam_small.fx,
                             fy=cam_small.fy, cx=cam_small.cx, cy=cam_small.cy)
    et = float(tfn.photometric_check(tdb, *_t(vm, rgb, est, T, rgb), tcam, 5.0))
    np.testing.assert_allclose(et, ej, rtol=1e-6)


def test_sample_constraints_matches(setup):
    db, small_maps, _ = setup
    T = np.eye(4, dtype=np.float32)
    rgb, vm, _ = small_maps(T)
    T2 = np.eye(4, dtype=np.float32)
    T2[1, 3] = 0.25
    sj, tj, oj = jfn.sample_constraints(db, jnp.asarray(vm), jnp.asarray(T), jnp.asarray(T2), 5.0)
    st, tt, ot = tfn.sample_constraints(_tdb(db), *_t(vm, T, T2), 5.0)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert int(ot.sum()) > 3
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
