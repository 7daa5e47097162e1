"""cofusion_tpu_torch/ops/rasterize.py and the plain window splat
(ops/cuda_splat.py) against cofusion_tpu/ops/rasterize.py on the CPU.

Bars:
  * z-buffer winners (`predict_indices` index maps) and splat taps: exact;
  * rendered float attributes: rtol=1e-5, atol=1e-6 (a few float32 ops per
    value; XLA CPU contracts multiply-adds into FMAs, PyTorch does not);
  * splat z: rtol=1e-4, atol=1e-5, the bar of tests/test_pallas_splat.py —
    XLA's FMA in the per-tap p.n sum is amplified by 1/|l.n| on grazing rays.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.config import CameraConfig, CoFusionConfig
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu.ops import fusion as jfu
from cofusion_tpu.ops import preprocess as jpp
from cofusion_tpu.ops import rasterize as jrz
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.ops import cuda_splat
from cofusion_tpu_torch.ops import rasterize as trz

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _splat_fixture(B, H, W):
    """tests/test_pallas_splat.py's random-disk fixture."""
    cam = CameraConfig(width=W, height=H, fx=60.0, fy=60.0, cx=W / 2, cy=H / 2)
    rng = np.random.default_rng(7)
    u = np.arange(W, dtype=np.float32)[None, :]
    v = np.arange(H, dtype=np.float32)[:, None]
    z = rng.uniform(0.5, 3.0, size=(B, H, W)).astype(np.float32)
    px = (u - cam.cx) / cam.fx * z
    py = (v - cam.cy) / cam.fy * z
    nr = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    nr[..., 2] -= 1.5
    nr /= np.linalg.norm(nr, axis=-1, keepdims=True)
    rad = rng.uniform(0.0, 0.2, size=(B, H, W)).astype(np.float32)
    valid = rng.random((B, H, W)) < 0.6
    return cam, np.stack([px, py, z], axis=-1), nr, rad, valid


def _xla_window(cam, pos, nr, rad, valid, r):
    B, H, W = valid.shape

    def shifted_b(x, dy, dx, fill=0.0):
        pt, pb = max(0, -dy), max(0, dy)
        pl_, pr = max(0, -dx), max(0, dx)
        pad = [(0, 0), (pt, pb), (pl_, pr)] + [(0, 0)] * (x.ndim - 3)
        xp = jnp.pad(x, pad, constant_values=fill)
        return jax.lax.slice(
            xp, (0, pt + dy, pl_ + dx) + (0,) * (x.ndim - 3),
            (B, pt + dy + H, pl_ + dx + W) + x.shape[3:],
        )

    uu = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    vv = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    lx = (uu - cam.cx) / cam.fx
    ly = (vv - cam.cy) / cam.fy
    lnorm = jnp.sqrt(lx * lx + ly * ly + 1.0)
    ray = jnp.stack([lx / lnorm, ly / lnorm, 1.0 / lnorm], axis=-1)[None]
    normal_rad = jnp.concatenate([jnp.asarray(nr), jnp.asarray(rad)[..., None]], axis=-1)
    return jrz._splat_window_xla(jnp.asarray(pos), normal_rad, jnp.asarray(valid), ray, shifted_b, r)


def _assert_window(z_t, tap_t, z_ref, tap_ref):
    tap_ref, z_ref = np.asarray(tap_ref), np.asarray(z_ref)
    hit = tap_ref >= 0
    assert hit.mean() > 0.3, "fixture produced too few hits to be meaningful"
    np.testing.assert_array_equal(tap_t.numpy(), tap_ref)
    np.testing.assert_allclose(z_t.numpy()[hit], z_ref[hit], rtol=1e-4, atol=1e-5)
    assert np.all(np.isinf(z_t.numpy()[~hit]))


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 32, 40)])
def test_splat_window_plain_matches_xla(shape):
    cam, pos, nr, rad, valid = _splat_fixture(*shape)
    z_ref, tap_ref = _xla_window(cam, pos, nr, rad, valid, 3)
    z_t, tap_t = cuda_splat.splat_window_plain(
        torch.from_numpy(pos), torch.from_numpy(nr), torch.from_numpy(rad),
        torch.from_numpy(valid), 3, (cam.fx, cam.fy, cam.cx, cam.cy),
    )
    _assert_window(z_t, tap_t, z_ref, tap_ref)


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 32, 40)])
def test_splat_window_plain_matches_pallas_interpret(shape, monkeypatch):
    from cofusion_tpu.ops import pallas_splat as ps

    cam, pos, nr, rad, valid = _splat_fixture(*shape)
    import jax.experimental.pallas as pl

    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **kw: orig(*a, **dict(kw, interpret=True)))
    z_ref, tap_ref = ps.splat_window_pallas(
        jnp.asarray(pos), jnp.asarray(nr), jnp.asarray(rad), jnp.asarray(valid), 3,
        (cam.fx, cam.fy, cam.cx, cam.cy),
    )
    z_t, tap_t = cuda_splat.splat_window(
        torch.from_numpy(pos), torch.from_numpy(nr), torch.from_numpy(rad),
        torch.from_numpy(valid), 3, (cam.fx, cam.fy, cam.cx, cam.cy),
    )
    _assert_window(z_t, tap_t, z_ref, tap_ref)


def test_splat_window_cuda_rejects_cpu_tensors():
    cam, pos, nr, rad, valid = _splat_fixture(1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_splat.splat_window_cuda(
            torch.from_numpy(pos), torch.from_numpy(nr), torch.from_numpy(rad),
            torch.from_numpy(valid), 3, (cam.fx, cam.fy, cam.cx, cam.cy),
        )


def _imap_views(B=2, H=6, W=8):
    """What splat_from_imap hands the kernel: views of (B, H, W, 4) maps."""
    vert_conf = torch.zeros((B, H, W, 4))
    normal_rad = torch.zeros((B, H, W, 4))
    valid = torch.ones((B, H, W), dtype=torch.bool)
    return [vert_conf[..., :3], normal_rad[..., :3], normal_rad[..., 3], valid]


def test_check_window_args_takes_index_map_views():
    B, H, W = 2, 6, 8
    strides = cuda_splat.check_window_args(*_imap_views(B, H, W), 3)
    assert strides == (H * W * 4, W * 4, 4) * 3 + (H * W, W, 1)


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "channel_stride", "radius"])
def test_check_window_args_rejects(case):
    args, r = _imap_views(), 3
    if case == "dtype":
        args[2] = args[2].to(torch.float64)
    elif case == "shape":
        args[1] = args[1][:, :, :-1]
    elif case == "device":
        args[1] = torch.empty(args[1].shape, device="meta")
    elif case == "channel_stride":
        args[0] = torch.zeros((2, 3, 6, 8)).permute(0, 2, 3, 1)
    else:
        r = -1
    with pytest.raises(ValueError):
        cuda_splat.check_window_args(*args, r)


@pytest.mark.parametrize("batched", [False, True])
def test_splat_from_imap_passes_views_the_kernel_takes(batched, monkeypatch):
    """The call site hands over the index map's views uncopied, and
    check_window_args accepts them."""
    cam = tcfg.CameraConfig(width=16, height=12, fx=15.0, fy=15.0, cx=8.0, cy=6.0)
    cfg = tcfg.CoFusionConfig(camera=cam, max_models=1)
    rng = np.random.default_rng(2)
    lead = (2,) if batched else ()
    z = rng.uniform(1.0, 2.0, lead + (12, 16)).astype(np.float32)
    zero = np.zeros_like(z)
    imap = trz.IndexMap(
        index=torch.zeros(lead + (12, 16), dtype=torch.int32),
        vert_conf=torch.from_numpy(np.stack([zero, zero, z, zero + 1], -1)),
        normal_rad=torch.from_numpy(np.stack([zero, zero, zero - 1, zero + 0.05], -1)),
        color_time=torch.zeros(lead + (12, 16, 4)),
        last_time=torch.zeros(lead + (12, 16)),
        valid=torch.from_numpy(rng.random(lead + (12, 16)) < 0.8),
    )
    seen = []

    def window(pos, norm, rad, valid, r, cam_tup):
        seen.append(cuda_splat.check_window_args(pos, norm, rad, valid, r))
        assert pos.data_ptr() == imap.vert_conf.data_ptr()
        assert rad.data_ptr() == imap.normal_rad.data_ptr() + 3 * 4
        return cuda_splat.splat_window_plain(pos, norm, rad, valid, r, cam_tup)

    monkeypatch.setattr(cuda_splat, "splat_window", window)
    out = trz.splat_from_imap(imap, cam, cfg, conf_threshold=0.5)
    assert len(seen) == 1 and seen[0][2] == 4 and seen[0][8] == 4
    assert out.valid.any()


@pytest.fixture(scope="module")
def scene(small_cam):
    """A JAX-initialised map of frame 0 and the pose of frame 3, converted to
    the port: both packages render the identical store."""
    frames, gt, _ = make_sequence(small_cam, 4, kind="orbit")
    f0 = frames[0]
    rgb = jnp.asarray(f0["rgb"], jnp.float32)
    depth = jnp.asarray(f0["depth"])
    filtered = jax.jit(jpp.bilateral_filter)(depth, 4.5)
    fs = jfu.make_frame_surfels(depth, filtered, rgb, small_cam, 1.0, 4.5)
    store_j = jfu.initialise(fs, jnp.eye(4), 1 << 17, time=1)
    store_np = tuple(np.array(a) for a in store_j)
    pose = np.asarray(gt[3], np.float32)
    return store_j, store_np, pose


@pytest.fixture(scope="module")
def tcam(small_cam):
    """The port's CameraConfig equal to small_cam."""
    return tcfg.CameraConfig(**dataclasses.asdict(small_cam))


@pytest.fixture(scope="module")
def tconf(tcam):
    return tcfg.CoFusionConfig(camera=tcam, max_models=1, max_surfels=1 << 17)


def _assert_imap(t, j):
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.index.numpy(), np.asarray(j.index))
    for f in ("vert_conf", "normal_rad", "color_time", "last_time"):
        np.testing.assert_allclose(
            getattr(t, f).numpy(), np.asarray(getattr(j, f)), rtol=RTOL, atol=ATOL, err_msg=f
        )


def test_predict_indices_matches(scene, small_cam, tcam):
    store_j, store_np, pose = scene
    ref = jrz.predict_indices(store_j, jnp.asarray(pose), small_cam, 2, 200, 4.5)
    out = trz.predict_indices(
        convert.store_from_numpy(store_np), torch.from_numpy(pose), tcam, 2, 200, 4.5
    )
    assert np.asarray(ref.valid).mean() > 0.5
    _assert_imap(out, ref)


def test_predict_indices_b_matches(scene, small_cam, tcam):
    store_j, store_np, pose = scene
    jb = jax.tree.map(lambda a: a[None], store_j)
    ref = jrz.predict_indices_b(
        jb, jnp.asarray(pose)[None], small_cam, 2, 200, jnp.full((1,), 4.5),
        conf_threshold=jnp.full((1,), 0.5),
    )
    tb = convert.store_from_numpy(tuple(a[None] for a in store_np))
    out = trz.predict_indices_b(
        tb, torch.from_numpy(pose)[None], tcam, 2, 200, torch.full((1,), 4.5),
        conf_threshold=torch.full((1,), 0.5),
    )
    _assert_imap(out, ref)


def test_splat_predict_matches(scene, small_cam, tcam, tconf):
    """Point render + splat in one call, confidence-gated at the render."""
    store_j, store_np, pose = scene
    cfg = CoFusionConfig(camera=small_cam, max_models=1, max_surfels=1 << 17)
    ref = jrz.splat_predict(store_j, jnp.asarray(pose), small_cam, cfg, 2, 200, 4.5, 0.5)
    out = trz.splat_predict(
        convert.store_from_numpy(store_np), torch.from_numpy(pose), tcam, tconf, 2, 200, 4.5, 0.5
    )
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert np.asarray(ref.valid).mean() > 0.5
    vc_t, vc_j = out.vert_conf.numpy(), np.asarray(ref.vert_conf)
    other = ~np.isclose(vc_t, vc_j, rtol=1e-4, atol=1e-5).all(-1)
    assert np.all(_bucket_edge(vc_t[..., 2])[other] & _bucket_edge(vc_j[..., 2])[other])
    assert other.mean() < 1e-3


def test_zbuffer_two_pass_above_2_19(scene, small_cam, tcam):
    """Capacities above 2^19 leave < 12 key bits and take the exact two-pass
    float z-buffer."""
    store_j, store_np, pose = scene
    pad = (1 << 20) - store_np[0].shape[0]
    big_np = tuple(np.concatenate([a, np.zeros(pad, a.dtype)]) if a.ndim else a for a in store_np)
    big_j = type(store_j)(*(jnp.asarray(a) for a in big_np))
    ref = jrz.predict_indices(big_j, jnp.asarray(pose), small_cam, 2, 200, 4.5)
    out = trz.predict_indices(
        convert.store_from_numpy(big_np), torch.from_numpy(pose), tcam, 2, 200, 4.5
    )
    assert trz._zkey_bits(1 << 20) < 12
    _assert_imap(out, ref)


def _bucket_edge(z):
    """Within ~4 float32 ulps (at 3 m) of a 1/4096 z-bucket boundary."""
    q = z * 4096.0
    return np.abs(q - np.round(q)) < 4e-3


def test_splat_from_imap_on_real_render(scene, small_cam, tcam, tconf):
    """Both packages splat the SAME index render (the JAX one, carried
    across), so the comparison isolates the splat pass.

    A pixel may pick another disk only where both hits sit on a 1/4096
    z-bucket edge: XLA CPU contracts the ray/hit multiply-adds into FMAs
    (ROADMAP C6), which moves z by an ulp across the edge; such pixels are
    bounded (< 0.1%) and every other pixel is held to the bars."""
    store_j, _, pose = scene
    cfg = CoFusionConfig(camera=small_cam, max_models=1, max_surfels=1 << 17)
    imap_j = jrz.predict_indices(store_j, jnp.asarray(pose), small_cam, 2, 200, 4.5)
    ref = jrz.splat_from_imap(imap_j, small_cam, cfg, conf_threshold=0.5)
    imap_t = trz.IndexMap(*(torch.from_numpy(np.array(a)) for a in imap_j))
    out = trz.splat_from_imap(imap_t, tcam, tconf, conf_threshold=0.5)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert np.asarray(ref.valid).mean() > 0.5

    vc_t, vc_j = out.vert_conf.numpy(), np.asarray(ref.vert_conf)
    other = ~np.isclose(vc_t, vc_j, rtol=1e-4, atol=1e-5).all(-1)
    assert np.all(_bucket_edge(vc_t[..., 2])[other] & _bucket_edge(vc_j[..., 2])[other])
    assert other.mean() < 1e-3
    same = ~other
    np.testing.assert_allclose(vc_t[same], vc_j[same], rtol=1e-4, atol=1e-5)
    for f in ("image", "normal_rad", "time"):
        np.testing.assert_allclose(
            getattr(out, f).numpy()[same], np.asarray(getattr(ref, f))[same],
            rtol=RTOL, atol=ATOL, err_msg=f,
        )


# --- the loop closure's inactive renders and the tier merge


def _aged(store_j, store_np):
    """The scene's store with every other surfel last updated 500 ticks
    back: at time 2, window 200, half the map is INACTIVE."""
    lt = np.array(store_np[12])
    lt[::2] = np.where(np.asarray(store_np[13])[::2], -500.0, lt[::2])
    aged_np = store_np[:12] + (lt,) + store_np[13:]
    return store_j._replace(last_time=jnp.asarray(lt)), aged_np


@pytest.mark.parametrize("active_window", [True, False])
def test_predict_indices_window_matches(scene, small_cam, tcam, active_window):
    store_j, store_np, pose = scene
    aged_j, aged_np = _aged(store_j, store_np)
    ref = jrz.predict_indices(aged_j, jnp.asarray(pose), small_cam, 2, 200, 4.5,
                              conf_threshold=0.5, active_window=active_window)
    out = trz.predict_indices(convert.store_from_numpy(aged_np), torch.from_numpy(pose), tcam, 2,
                              200, 4.5, conf_threshold=0.5, active_window=active_window)
    assert np.asarray(ref.valid).mean() > 0.3
    _assert_imap(out, ref)
    # every rendered surfel is on the asked side of the window
    lt = out.last_time.numpy()[out.valid.numpy()]
    assert ((2 - lt <= 200) == active_window).all()


def test_splat_predict_inactive_matches(scene, small_cam, tcam, tconf):
    store_j, store_np, pose = scene
    aged_j, aged_np = _aged(store_j, store_np)
    cfg = CoFusionConfig(camera=small_cam, max_models=1, max_surfels=1 << 17)
    ref = jrz.splat_predict(aged_j, jnp.asarray(pose), small_cam, cfg, 2, 200, 4.5, 0.5,
                            active_window=False)
    out = trz.splat_predict(convert.store_from_numpy(aged_np), torch.from_numpy(pose), tcam, tconf,
                            2, 200, 4.5, 0.5, active_window=False)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert np.asarray(ref.valid).mean() > 0.3
    vc_t, vc_j = out.vert_conf.numpy(), np.asarray(ref.vert_conf)
    other = ~np.isclose(vc_t, vc_j, rtol=1e-4, atol=1e-5).all(-1)
    assert np.all(_bucket_edge(vc_t[..., 2])[other] & _bucket_edge(vc_j[..., 2])[other])
    assert other.mean() < 1e-3


def test_splat_merge_exact(scene, small_cam):
    """The nearer valid hit wins, the first on ties (pure selects: exact)."""
    store_j, store_np, pose = scene
    aged_j, _ = _aged(store_j, store_np)
    cfg = CoFusionConfig(camera=small_cam, max_models=1, max_surfels=1 << 17)
    a = jrz.splat_predict(aged_j, jnp.asarray(pose), small_cam, cfg, 2, 200, 4.5, 0.5)
    b = jrz.splat_predict(aged_j, jnp.asarray(pose), small_cam, cfg, 2, 200, 4.5, 0.5,
                          active_window=False)
    ref = jrz.splat_merge(a, b)
    out = trz.splat_merge(*(trz.SplatMap(*(torch.from_numpy(np.array(x)) for x in m)) for m in (a, b)))
    for f, t, j in zip(trz.SplatMap._fields, out, ref):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f)
    assert 0 < np.asarray(a.valid).sum() < np.asarray(ref.valid).sum()
