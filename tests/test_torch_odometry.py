"""cofusion_tpu_torch/ops/odometry.py against cofusion_tpu/ops/odometry.py on
the CPU, on a synthetic frame pair: the map of frame 0 (rendered by the JAX
package and carried across, so both trackers see the identical prediction)
against frame 1.

Bars:
  * pyramids: rtol=1e-5, atol=1e-6 elementwise (XLA CPU contracts
    multiply-adds into FMAs), validity masks exact;
  * tracked pose: every entry within 1e-5 — the GN normal equations are
    float32 sums over ~10^4 correspondences reduced in another order (a
    different matmul), the bound `__graft_entry__.py:162-176` derives for one
    step of fp32 reduction-order noise;
  * correspondence counts: within 0.1% (a gate such as dist <= 0.10 m can
    flip on a last-ulp difference of the pose being refined).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.config import CoFusionConfig, TrackingParams
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu.ops import fusion as jfu
from cofusion_tpu.ops import odometry as jod
from cofusion_tpu.ops import preprocess as jpp
from cofusion_tpu.ops import rasterize as jrz
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.ops import odometry as tod
from cofusion_tpu_torch.ops import preprocess as tpp

from torch_shared import shared  # noqa: F401  (a fixture)

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def tcam(small_cam):
    """The port's CameraConfig equal to small_cam."""
    return tcfg.CameraConfig(**dataclasses.asdict(small_cam))


@pytest.fixture(scope="module")
def tconf(tcam):
    return tcfg.CoFusionConfig(camera=tcam, max_models=1, max_surfels=1 << 17)


@pytest.fixture(scope="module")
def pair(shared, small_cam):
    """Frame 0's map (JAX-rendered) and frame 2 (once per test session)."""
    return shared.get("torch_odometry_pair", lambda: _pair(small_cam))


def _pair(small_cam):
    cfg = CoFusionConfig(camera=small_cam, max_models=1, max_surfels=1 << 17)
    frames, gt, _ = make_sequence(small_cam, 6, kind="orbit")
    f0, f1 = frames[0], frames[2]
    bil = jax.jit(jpp.bilateral_filter)
    rgb0 = jnp.asarray(f0["rgb"], jnp.float32)
    d0 = jnp.asarray(f0["depth"])
    fs = jfu.make_frame_surfels(d0, bil(d0, 4.5), rgb0, small_cam, 1.0, 4.5)
    store = jfu.initialise(fs, jnp.eye(4), 1 << 17, time=1)
    poses = jnp.eye(4)[None]
    pred = jax.jit(jrz.splat_predict_b, static_argnums=(2, 3))(
        jax.tree.map(lambda a: a[None], store), poses, small_cam, cfg, 1, 200,
        jnp.full((1,), 4.5), jnp.full((1,), 0.0),
    )
    intensity0 = jpp.rgb_to_intensity(rgb0)
    so3_ref = jpp.pyr_down_gauss(jpp.pyr_down_gauss(intensity0))
    filtered1 = np.array(bil(jnp.asarray(f1["depth"]), 4.5))
    intensity1 = np.array(jpp.rgb_to_intensity(jnp.asarray(f1["rgb"], jnp.float32)))
    pred_np = tuple(np.array(a) for a in pred)
    return cfg, filtered1, intensity1, pred_np, np.array(so3_ref), np.asarray(gt[2], np.float32)


@pytest.fixture(scope="module")
def built(shared, pair, small_cam, tcam, tconf):
    """(JAX frame pyramid, port frame pyramid, JAX model pyramid, port model
    pyramid) from the same inputs (once per test session)."""
    return shared.get("torch_odometry_built", lambda: _built(pair, small_cam, tcam, tconf))


def _built(pair, small_cam, tcam, tconf):
    cam = small_cam
    cfg, filtered1, intensity1, pred_np, so3_ref, _ = pair
    image, vert_conf, normal_rad, _, valid = pred_np
    # eager, op by op: under jit XLA contracts the vertex/normal multiply-adds
    # into FMAs, and finite-difference normals amplify that ulp ~100x
    jf = jod.build_frame_pyramid(
        jnp.asarray(filtered1), jnp.asarray(intensity1), None, 0, cam, cfg, 4.5
    )
    tf = tod.build_frame_pyramid(_t(filtered1), _t(intensity1), tcam, tconf, 4.5)
    # the intensity as the jitted engine computes it (a floor of FMA-contracted
    # sums; see test_torch_preprocess.py)
    jm = jax.vmap(
        lambda v, n, ok, inten, p: jod.build_model_pyramid(v, n, ok, inten, p, cam, cfg)
    )(jnp.asarray(vert_conf[..., :3]), jnp.asarray(normal_rad[..., :3]), jnp.asarray(valid),
      jax.jit(jpp.rgb_to_intensity)(jnp.asarray(image)), jnp.eye(4)[None])
    tm = tod.build_model_pyramid(
        _t(vert_conf[0, ..., :3]), _t(normal_rad[0, ..., :3]), _t(valid[0]),
        tpp.rgb_to_intensity(_t(image[0])), torch.eye(4), tcam, tconf,
    )
    tm = tod.ModelPyramid(*(tuple(a[None] for a in level) for level in tm))
    return jf, tf, jm, tm


def test_frame_pyramid_matches(built):
    jf, tf, _, _ = built
    for field in tod.FramePyramid._fields:
        for lvl, (t, j) in enumerate(zip(getattr(tf, field), getattr(jf, field))):
            msg = f"{field}[{lvl}]"
            if t.dtype == torch.bool:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL, err_msg=msg)


def test_model_pyramid_matches(built):
    _, _, jm, tm = built
    for field in tod.ModelPyramid._fields:
        for lvl, (t, j) in enumerate(zip(getattr(tm, field), getattr(jm, field))):
            msg = f"{field}[{lvl}]"
            if t.dtype == torch.bool:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL, err_msg=msg)


def test_so3_prealign_matches(pair, small_cam, tcam):
    _, _, intensity1, _, so3_ref, _ = pair
    cur = np.array(jpp.pyr_down_gauss(jpp.pyr_down_gauss(jnp.asarray(intensity1))))
    cam2 = small_cam.at_level(2)
    Rj, ej = jax.jit(jod._so3_prealign, static_argnums=(2, 3))(jnp.asarray(so3_ref), jnp.asarray(cur), cam2, 10)
    intrinsics = tod._intrinsics(tcam.at_level(2), torch.device("cpu"))
    Rt, et = tod._so3_prealign(_t(so3_ref), _t(cur), intrinsics, 10)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4)


@pytest.mark.parametrize("icp_weight", [10.0, 100.0])
def test_track_models_matches(pair, built, small_cam, tcam, tconf, icp_weight):
    """Full 3-level GN solve (SO(3) pre-align + {10,5,4} iterations); at
    icp_weight 100 the RGB term and the pre-align are off (ICP only)."""
    cfg, _, _, _, so3_ref, gt_pose = pair
    jf, tf, jm, tm = built
    params = TrackingParams(icp_weight=icp_weight)
    poses = np.eye(4, dtype=np.float32)[None]
    res_j = jax.jit(jod.track_models, static_argnames=("cam", "cfg", "params"))(
        jnp.asarray(poses), jf, tuple(v[None] for v in jf.valid),
        tuple(v[None] for v in jf.rgb_ok), jm, jnp.asarray(so3_ref),
        cam=small_cam, cfg=cfg, params=params,
    )
    res_t = tod.track_models(
        _t(poses), tf, tuple(v[None] for v in tf.valid), tuple(v[None] for v in tf.rgb_ok),
        tm, _t(so3_ref), tcam, tconf, tcfg.TrackingParams(icp_weight=icp_weight),
    )
    pose_j, pose_t = np.asarray(res_j.pose), res_t.pose.numpy()
    # the tracker actually moved toward the ground truth
    assert np.abs(pose_j[0, :3, 3] - gt_pose[:3, 3]).max() < 5e-3
    np.testing.assert_allclose(pose_t, pose_j, atol=1e-5)
    for f in ("icp_count", "rgb_count"):
        np.testing.assert_allclose(
            getattr(res_t, f).numpy(), np.asarray(getattr(res_j, f)), rtol=1e-3, err_msg=f
        )
    np.testing.assert_allclose(res_t.icp_error.numpy(), np.asarray(res_j.icp_error), rtol=1e-3)


# --- masked multi-model tracking (M = 3: background, the sliding box, and
# an empty slot whose id no pixel carries)


@pytest.fixture(scope="module")
def moving_pair(shared, small_cam):
    """Frame 0's map (JAX-rendered, one prediction for all three slots) and
    frame 2 with its object mask (ids 0 and 1), once per test session."""
    return shared.get("torch_odometry_moving_pair", lambda: _moving_pair(small_cam))


def _moving_pair(small_cam):
    cfg = CoFusionConfig(camera=small_cam, max_models=3, max_surfels=1 << 17)
    frames, _, _ = make_sequence(small_cam, 6, kind="orbit", moving_object=True)
    f0, f1 = frames[0], frames[2]
    bil = jax.jit(jpp.bilateral_filter)
    rgb0 = jnp.asarray(f0["rgb"], jnp.float32)
    d0 = jnp.asarray(f0["depth"])
    fs = jfu.make_frame_surfels(d0, bil(d0, 4.5), rgb0, small_cam, 1.0, 4.5)
    store = jfu.initialise(fs, jnp.eye(4), 1 << 17, time=1)
    poses = jnp.broadcast_to(jnp.eye(4), (3, 4, 4))
    stores = jax.tree.map(lambda a: jnp.broadcast_to(a[None], (3,) + a.shape), store)
    pred = jax.jit(jrz.splat_predict_b, static_argnums=(2, 3))(
        stores, poses, small_cam, cfg, 1, 200, jnp.full((3,), 4.5), jnp.full((3,), 0.0),
    )
    so3_ref = jpp.pyr_down_gauss(jpp.pyr_down_gauss(jpp.rgb_to_intensity(rgb0)))
    filtered1 = np.array(bil(jnp.asarray(f1["depth"]), 4.5))
    intensity1 = np.array(jpp.rgb_to_intensity(jnp.asarray(f1["rgb"], jnp.float32)))
    return (cfg, filtered1, intensity1, tuple(np.array(a) for a in pred), np.array(so3_ref),
            f1["mask"].astype(np.int32))


def _mask_pyrs(mask, levels):
    out = [mask]
    for _ in range(levels - 1):
        out.append(out[-1][::2, ::2])
    return out


def test_mask_window_bounds_matches(moving_pair):
    mask = moving_pair[-1]
    assert set(np.unique(mask)) == {0, 1}
    jb = jod.mask_window_bounds([jnp.asarray(m) for m in _mask_pyrs(mask, 3)])
    tb = tod.mask_window_bounds([_t(m) for m in _mask_pyrs(mask, 3)])
    for lvl, ((jmn, jmx), (tmn, tmx)) in enumerate(zip(jb, tb)):
        np.testing.assert_array_equal(tmn.numpy(), np.asarray(jmn), err_msg=f"min[{lvl}]")
        np.testing.assert_array_equal(tmx.numpy(), np.asarray(jmx), err_msg=f"max[{lvl}]")


@pytest.fixture(scope="module")
def masked_built(shared, moving_pair, small_cam, tcam):
    """JAX and port frame/model pyramids (3 slots) and the masked per-model
    validity, as the engines' multi-model step builds them (once per test
    session)."""
    return shared.get("torch_odometry_masked_built", lambda: _masked_built(moving_pair, small_cam, tcam))


def _masked_built(moving_pair, small_cam, tcam):
    cfg, filtered1, intensity1, pred_np, _, mask = moving_pair
    image, vert_conf, normal_rad, _, valid = pred_np
    tconf = tcfg.CoFusionConfig(camera=tcam, max_models=3, max_surfels=1 << 17)
    jf = jod.build_frame_pyramid(jnp.asarray(filtered1), jnp.asarray(intensity1), None, 0, small_cam, cfg, 4.5)
    tf = tod.build_frame_pyramid(_t(filtered1), _t(intensity1), tcam, tconf, 4.5)
    jm = jax.vmap(
        lambda v, n, ok, inten, p: jod.build_model_pyramid(v, n, ok, inten, p, small_cam, cfg)
    )(jnp.asarray(vert_conf[..., :3]), jnp.asarray(normal_rad[..., :3]), jnp.asarray(valid),
      jax.jit(jpp.rgb_to_intensity)(jnp.asarray(image)), jnp.broadcast_to(jnp.eye(4), (3, 4, 4)))
    pyrs = [
        tod.build_model_pyramid(
            _t(vert_conf[m, ..., :3]), _t(normal_rad[m, ..., :3]), _t(valid[m]),
            tpp.rgb_to_intensity(_t(image[m])), torch.eye(4), tcam, tconf,
        )
        for m in range(3)
    ]
    tm = tod.ModelPyramid(*(tuple(torch.stack(lv) for lv in zip(*f)) for f in zip(*pyrs)))
    ids = np.arange(3, dtype=np.int32)
    jpyrs = [jnp.asarray(m) for m in _mask_pyrs(mask, 3)]
    jbounds = jod.mask_window_bounds(jpyrs)
    j_valid = tuple(jf.valid[lv][None] & (jpyrs[lv][None] == ids[:, None, None]) for lv in range(3))
    j_rgb_ok = tuple(
        jf.rgb_ok[lv][None] & (jbounds[lv][0][None] == ids[:, None, None])
        & (jbounds[lv][1][None] == ids[:, None, None])
        for lv in range(3)
    )
    tpyrs = [_t(m) for m in _mask_pyrs(mask, 3)]
    t_valid, t_rgb_ok = tod.masked_validity_b(tf, tpyrs, tod.mask_window_bounds(tpyrs), _t(ids))
    for lv in range(3):
        np.testing.assert_array_equal(t_valid[lv].numpy(), np.asarray(j_valid[lv]))
        np.testing.assert_array_equal(t_rgb_ok[lv].numpy(), np.asarray(j_rgb_ok[lv]))
    assert not np.asarray(j_valid[0][2]).any() and np.asarray(j_valid[0][1]).any()
    return cfg, tconf, jf, tf, jm, tm, (j_valid, j_rgb_ok), (t_valid, t_rgb_ok)


def test_masked_track_models_matches(moving_pair, masked_built, small_cam, tcam):
    """Three slots tracked at once under their mask gates: the background
    and the box each against the same prediction; the empty slot finds no
    correspondence (the engine then keeps an inactive slot's pose)."""
    so3_ref = moving_pair[4]
    cfg, tconf, jf, tf, jm, tm, (jv, jr), (tv, tr) = masked_built
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (3, 4, 4)).copy()
    res_j = jax.jit(jod.track_models, static_argnames=("cam", "cfg", "params"))(
        jnp.asarray(poses), jf, jv, jr, jm, jnp.asarray(so3_ref), cam=small_cam, cfg=cfg,
        params=TrackingParams(),
    )
    res_t = tod.track_models(_t(poses), tf, tv, tr, tm, _t(so3_ref), tcam, tconf, tcfg.TrackingParams())
    np.testing.assert_allclose(res_t.pose.numpy(), np.asarray(res_j.pose), atol=1e-5)
    for f in ("icp_count", "rgb_count"):
        np.testing.assert_allclose(
            getattr(res_t, f).numpy(), np.asarray(getattr(res_j, f)), rtol=1e-3, err_msg=f
        )
    assert np.asarray(res_j.icp_count)[1] > 50 and np.asarray(res_j.icp_count)[2] == 0


@pytest.mark.parametrize("stride", [1, 2])
def test_icp_error_maps_b_matches(moving_pair, masked_built, small_cam, tcam, stride):
    """The CRF's unary input: ungated per-pixel ICP distance of every slot
    at its new pose against its previous one (stride 2 nearest-fills back
    to full resolution)."""
    cfg, tconf, jf, tf, jm, tm, _, _ = masked_built
    prev = np.broadcast_to(np.eye(4, dtype=np.float32), (3, 4, 4)).copy()
    new = prev.copy()
    new[1, :3, 3] = (0.01, -0.005, 0.002)
    new[2, :3, 3] = (0.0, 0.02, 0.0)
    maps_j = jod.icp_error_maps_b(
        jnp.asarray(new), jnp.asarray(prev), jf.vmap[0], jf.nmap[0], jf.valid[0], jm,
        small_cam, TrackingParams(), stride=stride,
    )
    maps_t = tod.icp_error_maps_b(
        _t(new), _t(prev), tf.vmap[0], tf.nmap[0], tf.valid[0], tm, tcam, tcfg.TrackingParams(),
        stride=stride,
    )
    assert maps_t.shape == (3,) + small_cam.shape
    np.testing.assert_allclose(maps_t.numpy(), np.asarray(maps_j), rtol=RTOL, atol=ATOL)
    assert (np.asarray(maps_j)[1] > 0.005).mean() > 0.3


# --- the loop closure's and relocalisation's one-model solves


def test_frame_pyramid_from_maps_matches(pair, small_cam, tcam, tconf):
    """The model-to-model odometry's current side, built from a predicted
    view (the JAX-rendered prediction of frame 0)."""
    cfg = pair[0]
    image, vert_conf, normal_rad, _, valid = pair[3]
    inten = np.array(jax.jit(jpp.rgb_to_intensity)(jnp.asarray(image[0])))
    jf = jod.build_frame_pyramid_from_maps(
        jnp.asarray(vert_conf[0, ..., :3]), jnp.asarray(normal_rad[0, ..., :3]),
        jnp.asarray(valid[0]), jnp.asarray(inten), small_cam, cfg,
    )
    tf = tod.build_frame_pyramid_from_maps(
        _t(vert_conf[0, ..., :3]), _t(normal_rad[0, ..., :3]), _t(valid[0]), _t(inten), tcam, tconf,
    )
    assert np.asarray(jf.valid[0]).mean() > 0.5
    for field in tod.FramePyramid._fields:
        for lvl, (t, j) in enumerate(zip(getattr(tf, field), getattr(jf, field))):
            msg = f"{field}[{lvl}]"
            if t.dtype == torch.bool:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL, err_msg=msg)


@pytest.mark.parametrize("solve", ["local_loop", "fern"])
def test_get_incremental_transformation_matches(pair, built, small_cam, tcam, tconf, solve):
    """The unbatched JAX tracker against the port's one-model `track_models`
    call, in the two configurations the engine runs it in: the local loop's
    (no SO(3) pre-align, no GN stride) and the fern ICP's (20 ICP-only
    iterations at level 0).  Pose within 1e-5 x max(1, condition / 1e2)
    (ROADMAP C8)."""
    cfg, _, _, _, so3_ref, gt_pose = pair
    jf, tf, jm, tm = built
    if solve == "local_loop":
        kw, params = dict(use_so3=False, gn_stride_l0=1), dict()
    else:
        kw = dict(use_so3=False, use_pyramid=False, gn_iters=(20, 0, 0), gn_stride_l0=1)
        params = dict(icp_weight=100.0)
    jcfg, tcfg_ = cfg.replace(**kw), tconf.replace(**kw)
    res_j = jod.get_incremental_transformation(
        jnp.eye(4, dtype=jnp.float32), jf, jax.tree.map(lambda a: a[0], jm), jnp.asarray(so3_ref),
        small_cam, jcfg, TrackingParams(**params),
    )
    res_t = tod.get_incremental_transformation(
        torch.eye(4), tf, tod.ModelPyramid(*(tuple(lv[0] for lv in f) for f in tm)), _t(so3_ref),
        tcam, tcfg_, tcfg.TrackingParams(**params),
    )
    assert res_t.pose.shape == (4, 4) and res_t.A.shape == (6, 6)
    assert np.abs(np.asarray(res_j.pose)[:3, 3] - gt_pose[:3, 3]).max() < 5e-3
    kappa = np.linalg.cond(res_t.A.double().numpy())
    np.testing.assert_allclose(res_t.pose.numpy(), np.asarray(res_j.pose),
                               atol=1e-5 * max(1.0, kappa / 1e2))
    for f in ("icp_count", "rgb_count"):
        np.testing.assert_allclose(float(getattr(res_t, f)), float(getattr(res_j, f)), rtol=1e-3,
                                   err_msg=f)
    np.testing.assert_allclose(float(res_t.icp_error), float(res_j.icp_error), rtol=1e-3)
