"""cofusion_tpu_torch/ops/deformation.py against cofusion_tpu/ops/deformation.py
on the CPU, on tests/test_deformation.py's line of surfels (64 surfels,
init times 0..63) and on a real one-frame map.

Bars:
  * node sampling, the k nearest nodes (clipped windows included) and every
    index, count and flag: exact;
  * node weights, warped points and normals: atol 1e-6 (a few float32 ops;
    XLA CPU contracts multiply-adds into FMAs, the port sums in one written
    order);
  * the Gauss-Newton solve: the dense normal equations are float32 sums
    over ~10^3 rows reduced in another order and solved by another LU.  Their
    condition is ~1e7 (directions held only by the 1e-6 damping), so C8's
    1e-5 x condition / 1e2 would be ~1 and hold nothing; instead the warped
    constraint sources, what the solve is for, are held to 1e-5, the node
    parameters to PARAM_BAR = 1e-4 (~7x the largest gap seen, 1.47e-5 on
    the 5 cm shift) and the final error to rtol 1e-4;
  * `refresh_timestamps`: `last_time` exact;
  * `apply_to_poses`: the port's Newton polar factor against JAX's SVD
    U V^T, atol 1e-6, and orthonormal to 1e-6 (ROADMAP C10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.models import surfel_model as jsm
from cofusion_tpu.ops import deformation as jdf
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.ops import deformation as tdf

torch.set_num_threads(1)
ATOL = 1e-6
PARAM_BAR = 1e-4


def _line_store(n=64, capacity=128):
    """tests/test_deformation.py's store: surfels along a line, init times
    increasing (a scanned trajectory)."""
    ts = np.arange(n, dtype=np.float32)
    pos = np.stack([ts * 0.05, np.zeros(n), 2.0 + 0.1 * np.sin(ts * 0.2)], axis=1).astype(np.float32)
    flat = jsm.pack_store(
        pos=jnp.asarray(pos), normal=jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1)),
        color=jnp.full((n, 3), 128.0), radius=jnp.full((n,), 0.05), conf=jnp.full((n,), 10.0),
        init_time=jnp.asarray(ts), last_time=jnp.asarray(ts), valid=jnp.ones((n,), bool),
        count=jnp.int32(n),
    )
    flat = jax.tree.map(
        lambda a: jnp.concatenate([a, jnp.zeros((capacity - n,) + a.shape[1:], a.dtype)])
        if a.ndim >= 1 and a.shape[0] == n else a, flat,
    )
    return jsm.append(jsm.empty_store(capacity), flat, jnp.arange(capacity) < n)


def _tstore(store_j):
    return convert.store_from_numpy(tuple(np.array(a) for a in store_j))


def _tgraph(graph_j):
    return tdf.DeformationGraph(*(torch.from_numpy(np.array(a)) for a in graph_j))


def _perturbed(graph_j, seed=0, rot=0.05, trans=0.02):
    """The graph with seeded near-identity, not quite orthonormal rotations
    and small translations (as an optimised graph has)."""
    rng = np.random.default_rng(seed)
    G = graph_j.R.shape[0]
    R = np.eye(3, dtype=np.float32)[None] + rot * rng.normal(size=(G, 3, 3)).astype(np.float32)
    t = trans * rng.normal(size=(G, 3)).astype(np.float32)
    return graph_j._replace(R=jnp.asarray(R), t=jnp.asarray(t))


@pytest.mark.parametrize("nodes", [16, 64, 100])
def test_sample_graph_exact(nodes):
    store = _line_store()
    gj = jdf.sample_graph(store, nodes)
    gt = tdf.sample_graph(_tstore(store), nodes)
    for f, a, b in zip(tdf.DeformationGraph._fields, gt, gj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    assert int(gt.count) == min(64, nodes)


@pytest.mark.parametrize("times", ["start", "end", "middle", "beyond"])
def test_knn_weights_match(times):
    """The 2k-candidate window is clipped at both ends of the node list,
    where it holds duplicate nodes at equal distances: the k + 1 smallest
    keep index order there, as lax.top_k does."""
    store = _line_store()
    gj = jdf.sample_graph(store, 16)
    rng = np.random.default_rng(1)
    t = {"start": np.zeros(12), "end": np.full(12, 63.0), "middle": rng.uniform(10, 50, 12),
         "beyond": np.full(12, 500.0)}[times].astype(np.float32)
    pts = (np.asarray(store.pos)[(t.astype(int) % 64)] + 0.01 * rng.normal(size=(12, 3))).astype(np.float32)
    nj, wj = jdf._knn_time_weights(gj, jnp.asarray(pts), jnp.asarray(t))
    nt, wt = tdf._knn_time_weights(_tgraph(gj), torch.from_numpy(pts), torch.from_numpy(t))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=ATOL)
    np.testing.assert_allclose(wt.numpy().sum(1), 1.0, atol=1e-6)


def test_warp_points_and_normals_match():
    store = _line_store()
    gj = _perturbed(jdf.sample_graph(store, 16))
    gt = _tgraph(gj)
    pos, nrm, ts = store.pos, store.normal, store.init_time
    tpos, tnrm, tts = (torch.from_numpy(np.array(a)) for a in (pos, nrm, ts))
    np.testing.assert_allclose(tdf.warp_points(gt, tpos, tts).numpy(),
                               np.asarray(jdf.warp_points(gj, pos, ts)), atol=ATOL)
    np.testing.assert_allclose(tdf.warp_normals(gt, tnrm, tts, tpos).numpy(),
                               np.asarray(jdf.warp_normals(gj, nrm, ts, pos)), atol=ATOL)


def _constraints(store, n_c, shift):
    src = store.pos[:n_c]
    return src, store.init_time[:n_c], src + jnp.asarray(shift, jnp.float32), jnp.ones(n_c, bool)


@pytest.mark.parametrize("case", ["identity", "shift_y", "half_valid"])
def test_optimize_matches(case):
    """tests/test_deformation.py's constraint sets: already satisfied, the
    map asked to move 5 cm in y, and half the constraints invalid."""
    store = _line_store()
    gj = jdf.sample_graph(store, 16)
    shift = [0.0, 0.0, 0.0] if case == "identity" else [0.0, 0.05, 0.0]
    src, st, tgt, ok = _constraints(store, 16, shift)
    if case == "half_valid":
        ok = jnp.arange(16) % 2 == 0
    g2j, errj = jdf.optimize(gj, src, st, tgt, ok)
    args = [torch.from_numpy(np.array(a)) for a in (src, st, tgt, ok)]
    g2t, errt = tdf.optimize(_tgraph(gj), *args)
    # what the solve is for: the warped constraint sources
    np.testing.assert_allclose(tdf.warp_points(g2t, args[0], args[1]).numpy(),
                               np.asarray(jdf.warp_points(g2j, src, st)), atol=1e-5)
    np.testing.assert_allclose(g2t.R.numpy(), np.asarray(g2j.R), atol=PARAM_BAR)
    np.testing.assert_allclose(g2t.t.numpy(), np.asarray(g2j.t), atol=PARAM_BAR)
    np.testing.assert_allclose(float(errt), float(errj), rtol=1e-4, atol=1e-9)
    if case == "shift_y":
        moved = tdf.apply_to_surfels(g2t, _tstore(store)).pos.numpy()[:16] - np.asarray(store.pos)[:16]
        np.testing.assert_allclose(moved.mean(0), shift, atol=0.02)


def test_mean_constraint_error_matches():
    store = _line_store()
    gj = _perturbed(jdf.sample_graph(store, 16))
    src, st, tgt, ok = _constraints(store, 24, [0.0, 0.05, 0.0])
    ok = ok.at[::3].set(False)
    ej = float(jdf.mean_constraint_error(gj, src, st, tgt, ok))
    et = float(tdf.mean_constraint_error(_tgraph(gj), *(torch.from_numpy(np.array(a))
                                                        for a in (src, st, tgt, ok))))
    np.testing.assert_allclose(et, ej, rtol=1e-6)


def test_apply_to_surfels_matches():
    store = _line_store()
    gj = _perturbed(jdf.sample_graph(store, 16), seed=2)
    out_j = jdf.apply_to_surfels(gj, store)
    out_t = tdf.apply_to_surfels(_tgraph(gj), _tstore(store))
    for f, a, b in zip(out_t._fields, out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, err_msg=f)
    # rows past the valid prefix are left alone
    np.testing.assert_array_equal(out_t.px.numpy()[64:], 0.0)


@pytest.fixture(scope="module")
def frame_map(small_cam):
    """A one-frame map of the synthetic orbit (JAX-initialised), half of it
    stale, and a pose a few frames on."""
    from cofusion_tpu.io.synthetic import make_sequence
    from cofusion_tpu.ops import fusion as jfu
    from cofusion_tpu.ops import preprocess as jpp

    frames, gt, _ = make_sequence(small_cam, 4, kind="orbit")
    rgb = jnp.asarray(frames[0]["rgb"], jnp.float32)
    depth = jnp.asarray(frames[0]["depth"])
    fs = jfu.make_frame_surfels(depth, jax.jit(jpp.bilateral_filter)(depth, 4.5), rgb, small_cam,
                                1.0, 4.5)
    store = jfu.initialise(fs, jnp.eye(4), 1 << 16, time=1)
    rng = np.random.default_rng(5)
    conf = np.where(rng.random(1 << 16) < 0.3, 0.5, 3.0).astype(np.float32)
    lt = np.where(rng.random(1 << 16) < 0.5, -400.0, 1.0).astype(np.float32)
    store = store._replace(conf=jnp.asarray(conf), last_time=jnp.where(store.valid, lt, 0.0))
    return store, np.asarray(gt[2], np.float32)


def test_refresh_timestamps_exact(frame_map, small_cam):
    """Confident surfels that project onto the synthesized depth (no time
    window) get last_time = time, exactly as in JAX."""
    from cofusion_tpu_torch import config as tcfg

    store, pose = frame_map
    tcam = tcfg.CameraConfig(width=small_cam.width, height=small_cam.height, fx=small_cam.fx,
                             fy=small_cam.fy, cx=small_cam.cx, cy=small_cam.cy)
    out_j = jdf.refresh_timestamps(store, jnp.asarray(pose), small_cam, 7, jnp.float32(4.5),
                                   jnp.float32(1.0))
    out_t = tdf.refresh_timestamps(_tstore(store), torch.from_numpy(pose), tcam, 7, 4.5, 1.0)
    np.testing.assert_array_equal(out_t.last_time.numpy(), np.asarray(out_j.last_time))
    bumped = (out_t.last_time.numpy() == 7.0).sum()
    assert 0 < bumped < int(store.count)


def test_time_window_of_2_30_exact(frame_map):
    """The synthesized depth's window, 2^30, is a power of two: `time -
    last_time <= 2^30` is decided exactly in float32 in both packages, at
    the bound itself and one float32 step (128) past it."""
    from cofusion_tpu.ops import rasterize as jrz
    from cofusion_tpu_torch.ops import rasterize as trz

    store, _ = frame_map
    lt = np.array(store.last_time)
    time = 1000
    lt[:6] = [time - 2.0**30, time - 2.0**30 - 128, time - 2.0**30 + 128, -1e6, time, time + 1]
    store = store._replace(last_time=jnp.asarray(lt))
    gj = jrz._window_gate(store, jnp.int32(time), jnp.int32(1 << 30), True)
    gt = trz._window_gate(_tstore(store), time, 1 << 30, True)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    assert gt[:6].tolist() == [True, False, True, True, True, True]


@pytest.mark.parametrize("rot", [0.02, 0.3])
def test_apply_to_poses_polar_matches_svd(rot):
    """The log's rotations, blended from non-orthonormal node rotations, made
    orthonormal by the port's Newton polar iteration and by JAX's SVD."""
    store = _line_store()
    gj = _perturbed(jdf.sample_graph(store, 16), seed=3, rot=rot)
    rng = np.random.default_rng(4)
    P = 40
    poses = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    for i in range(P):
        w = rng.normal(size=3) * 0.5
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        th = np.linalg.norm(w)
        poses[i, :3, :3] = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K
        poses[i, :3, 3] = np.asarray(store.pos)[i] + 0.01 * rng.normal(size=3)
    times = rng.uniform(-5, 70, P).astype(np.float32)
    out_j = np.asarray(jdf.apply_to_poses(gj, jnp.asarray(poses), jnp.asarray(times)))
    out_t = tdf.apply_to_poses(_tgraph(gj), torch.from_numpy(poses), torch.from_numpy(times)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=ATOL)
    R = out_t[:, :3, :3].astype(np.float64)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape), atol=1e-6)
    one = tdf.apply_to_pose(_tgraph(gj), torch.from_numpy(poses[5]), float(times[5])).numpy()
    np.testing.assert_allclose(one, np.asarray(jdf.apply_to_pose(gj, jnp.asarray(poses[5]), times[5])),
                               atol=ATOL)
