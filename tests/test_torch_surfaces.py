"""The port's remaining surfaces against the JAX package on the CPU:
ground-truth poses ('-p': GroundTruthOdometry and the engine's '-p' step,
static and with 3 slots and GT masks), `render_views` ('-en'/'-ev'),
frame-to-frame RGB ('-ftf'), the readers' backward playback ('-r') and
colour flip ('-f'), read_ply and the PNG exports, and the CLI's remaining
flags.  Mirrors tests/test_flags_r2.py, test_flags_r3.py (rewind, -icl),
test_fixes_r2.py::test_export_ply_transform and test_io.py's read_ply.

Bars:
  * GroundTruthOdometry: poses equal to JAX's bit for bit;
  * the '-p' runs: logged poses equal to the given fp32 poses, surfel counts
    exact on every frame, and the map (both tiers of every slot) within
    fp32 rounding of the JAX package run eagerly (`jax.disable_jit`: the
    same code without XLA's fused multiply-adds); against the jitted JAX
    run the counts are exact and the map differs only in rows where the
    jitted run differs from its own eager run (ROADMAP C6);
  * `render_views`: valid exact and image/normal within fp32 rounding of
    JAX's eager render of the same map; against JAX's jitted render, only
    pixels on a 1/4096 z-bucket edge may differ (< 0.1%, ROADMAP C6);
  * '-ftf': per-frame poses within 1e-5 + 2e-6*step, counts exact;
  * readers, read_ply, the PNGs: equal bit for bit / byte for byte.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from cofusion_tpu.config import CameraConfig, CoFusionConfig, FusionParams
from cofusion_tpu.engine import CoFusion as JaxCoFusion
from cofusion_tpu.io import readers as jreaders
from cofusion_tpu.io.ground_truth import GroundTruthOdometry as JaxGroundTruth
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu.ops import fillin as jfi
from cofusion_tpu.ops.rasterize import SplatMap as JaxSplatMap
from cofusion_tpu.utils import export as jexport
from cofusion_tpu_torch import cli, convert
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.engine import CoFusion, _unbatch
from cofusion_tpu_torch.io import readers as treaders
from cofusion_tpu_torch.io.ground_truth import GroundTruthOdometry
from cofusion_tpu_torch.ops import fillin as tfi
from cofusion_tpu_torch.ops import rasterize as trz
from cofusion_tpu_torch.utils import export as texport

torch.set_num_threads(1)
TINY = CameraConfig(width=80, height=64, fx=66.0, fy=66.0, cx=40.0, cy=32.0)
N = 6
RTOL, ATOL = 1e-5, 1e-5
# frame normals are finite differences: an ulp of a vertex is ~1e-5 of a
# normal (tests/test_torch_engine.py)
NORMAL_ATOL = 1e-4


def _tcam(cam):
    return tcfg.CameraConfig(**dataclasses.asdict(cam))


def _pose_bar(step):
    return 1e-5 + 2e-6 * step


# --- GroundTruthOdometry


def _random_trajectory(seed, n=8):
    rng = np.random.default_rng(seed)
    poses = []
    for _ in range(n):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(scale=0.3, size=3)).as_matrix()
        T[:3, 3] = rng.normal(scale=0.5, size=3)
        poses.append(T)
    return poses


@pytest.mark.parametrize("case", ["exact", "jitter", "unknown", "isam", "comma"])
def test_ground_truth_odometry_matches_jax(tmp_path, case):
    """The accumulated '-p' poses of both packages for the same file and the
    same queried timestamps: exact timestamps, jitter within half a frame,
    an unknown timestamp (the last pose is held), the iSAM basis, and a
    comma-separated file."""
    poses = _random_trajectory(seed=11)
    stamps = [1000 * i + 33 for i in range(len(poses))]
    sep = "," if case == "comma" else " "
    path = tmp_path / "gt.txt"
    path.write_text("# ts x y z qx qy qz qw\n" + "".join(
        jexport.pose_to_tum_line(ts, T.astype(np.float32)).replace(" ", sep) + "\n"
        for ts, T in zip(stamps, poses)
    ))
    queries = list(stamps)
    if case == "jitter":
        queries = [ts + (-1) ** i * 400 for i, ts in enumerate(stamps)]
    elif case == "unknown":
        queries = stamps[:3] + [99_999_999] + stamps[3:]
    isam = case == "isam"
    ref = JaxGroundTruth(str(path), isam_basis=isam)
    out = GroundTruthOdometry(str(path), isam_basis=isam)
    got = [(out.pose_for(q), ref.pose_for(q)) for q in queries]
    for i, (a, b) in enumerate(got):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b, err_msg=f"query {i}")
    if case == "unknown":
        np.testing.assert_array_equal(got[3][0], got[2][0])
    assert not np.allclose(got[-1][0], np.eye(4))


# --- the '-p' engine step


def _gt_configs(multi):
    """(JAX config, port config, fusion kwargs, engine kwargs): the static
    engine, or test_multimodel.py's GT-mask engine at 3 slots."""
    kw = dict(max_models=3 if multi else 1, max_surfels=1 << 14)
    fusion = dict(depth_cutoff=4.5, confidence_global=1.5)
    if multi:
        fusion.update(confidence_object=0.01, model_spawn_offset=0)
    return (CoFusionConfig(camera=TINY, **kw), tcfg.CoFusionConfig(camera=_tcam(TINY), **kw),
            fusion, dict(enable_multi_model=multi))


def _run(eng, frames, poses, eager=False):
    """Per-frame surfel counts of a '-p' run (the first frame initialises)."""
    counts = []
    for i, f in enumerate(frames):
        if eager:
            with jax.disable_jit():
                eng.process_frame(f, gt_pose=poses[i] if i else None)
                counts.append(eng.stats()["surfel_counts"].tolist())
        else:
            eng.process_frame(f, gt_pose=poses[i] if i else None)
            counts.append(eng.stats()["surfel_counts"].tolist())
    return counts


def _maps(state):
    """The active and stable tiers of every slot as numpy SurfelStores."""
    return state.models.store, state.models.stable


def _map_rows_off(a, b):
    """Rows (slot, row) where any field of SurfelStore `a` is outside the
    fp32 bars of `b`'s."""
    off = np.asarray(a.valid) != np.asarray(b.valid)
    for name in a._fields[:-2]:
        x = np.asarray(getattr(a, name), np.float64)
        y = np.asarray(getattr(b, name), np.float64)
        atol = NORMAL_ATOL if name in ("nx", "ny", "nz") else ATOL
        off |= np.abs(x - y) > atol + RTOL * np.abs(y)
    return off


def _bucket_edge(z):
    """Within ~4 float32 ulps (at 3 m) of a 1/4096 z-bucket boundary."""
    q = z * 4096.0
    return np.abs(q - np.round(q)) < 4e-3


@pytest.mark.parametrize("mode", ["static", "gt_masks_3_slots"])
def test_gt_pose_run_matches_jax(mode):
    """'-p' over 6 orbit frames (with a sliding box and its GT masks in
    the multi-model mode: '-p' skips segmentation, so nothing spawns):
    the port against the JAX package, then `render_views` on the final
    maps."""
    multi = mode != "static"
    frames, gt, _ = make_sequence(TINY, N, kind="orbit", moving_object=multi)
    jcfg, tc, fusion, opts = _gt_configs(multi)
    eager = JaxCoFusion(jcfg, fusion_params=FusionParams(**fusion), **opts)
    port = CoFusion(tc, fusion_params=tcfg.FusionParams(**fusion), device="cpu", **opts)
    eager_counts = _run(eager, frames, gt, eager=True)
    port_counts = _run(port, frames, gt)

    for i, (ts, p) in enumerate(port.pose_log):
        want = np.eye(4, dtype=np.float32) if i == 0 else gt[i].astype(np.float32)
        np.testing.assert_array_equal(p[0], want, err_msg=f"frame {i}")
        np.testing.assert_array_equal(eager.pose_log[i][1][0], want)
    assert port_counts == eager_counts
    assert port.stats()["active"].tolist() == [True] + [False] * (tc.max_models - 1)
    jstate = jax.tree.map(np.asarray, eager.state)
    tstate = convert.state_to_numpy(port.state)
    for tier, a, b in zip(("store", "stable"), _maps(tstate), _maps(jstate)):
        assert not _map_rows_off(a, b).any(), tier
        np.testing.assert_array_equal(a.count, b.count)

    if not multi:
        # the jitted reference: counts exact; its map leaves the port's only
        # where it leaves its own eager run (fused multiply-adds, C6)
        jit = JaxCoFusion(jcfg, fusion_params=FusionParams(**fusion), **opts)
        assert _run(jit, frames, gt) == port_counts
        jit_state = jax.tree.map(np.asarray, jit.state)
        for a, b, c in zip(_maps(tstate), _maps(jit_state), _maps(jstate)):
            assert not (_map_rows_off(a, b) & ~_map_rows_off(c, b)).any()

    # render_views: the same JAX map rendered eagerly, and jitted
    tv = port.render_views()
    with jax.disable_jit():
        ev = eager.render_views()
    assert tv["valid"].mean() > 0.3
    np.testing.assert_array_equal(tv["valid"], ev["valid"])
    np.testing.assert_allclose(tv["image"], ev["image"], rtol=RTOL, atol=1e-3)
    np.testing.assert_allclose(tv["normal"], ev["normal"], rtol=RTOL, atol=NORMAL_ATOL)
    jv = eager.render_views()
    np.testing.assert_array_equal(tv["valid"], jv["valid"])
    other = ~(np.isclose(tv["image"], jv["image"], rtol=RTOL, atol=1e-3).all(-1)
              & np.isclose(tv["normal"], jv["normal"], rtol=RTOL, atol=NORMAL_ATOL).all(-1))
    st, m = port.state, port.state.models
    z = trz.splat_merge(
        trz.splat_predict(_unbatch(m.store), m.pose[0], tc.camera, tc, st.tick, tc.time_delta, 4.5,
                          m.conf_threshold[0]),
        trz.splat_predict(_unbatch(m.stable), m.pose[0], tc.camera, tc, st.tick, 1 << 30, 4.5,
                          m.conf_threshold[0]),
    ).vert_conf[..., 2].numpy()
    assert np.all(_bucket_edge(z)[other]) and other.mean() < 1e-3


def test_render_views_reads_both_tiers():
    """The stable tier is rendered with no time window and z-merged over
    the active tier's view: a map whose every surfel sits in the stable
    tier renders the same view as when it sat in the active tier."""
    frames, gt, _ = make_sequence(TINY, N, kind="orbit")
    _, tc, fusion, _ = _gt_configs(False)
    eng = CoFusion(tc, fusion_params=tcfg.FusionParams(**fusion), device="cpu")
    for i, f in enumerate(frames):
        eng.process_frame(f, gt_pose=gt[i] if i else None)
    before = eng.render_views()
    m = eng.state.models
    eng.state = eng.state._replace(models=m._replace(store=m.stable, stable=m.store))
    after = eng.render_views()
    assert before["valid"].mean() > 0.1
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


# --- '-ftf': the image passes through while the geometry stays predicted


@pytest.mark.parametrize("geom,rgb", [(False, False), (False, True), (True, True)])
def test_fill_in_passthrough_matches_jax(geom, rgb):
    rng = np.random.default_rng(5)
    H, W = TINY.height, TINY.width
    splat = JaxSplatMap(
        image=(rng.random((H, W, 3)) * 255).astype(np.float32),
        vert_conf=np.concatenate([rng.normal(size=(H, W, 2)), rng.uniform(0.5, 3, (H, W, 2))],
                                 axis=-1).astype(np.float32),
        normal_rad=rng.normal(size=(H, W, 4)).astype(np.float32),
        time=np.ones((H, W), np.float32),
        valid=rng.random((H, W)) < 0.6,
    )
    raw = (rng.random((H, W, 3)) * 255).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, (H, W)).astype(np.float32)
    ref = jfi.fill_in(splat, raw, depth, TINY, 4.5, passthrough_geom=geom, passthrough_rgb=rgb)
    tsplat = trz.SplatMap(*(torch.from_numpy(np.asarray(a)) for a in splat))
    lost = torch.tensor(geom)
    out = tfi.fill_in(tsplat, torch.from_numpy(raw), torch.from_numpy(depth), _tcam(TINY), 4.5,
                      passthrough_geom=lost, passthrough_rgb=lost if rgb == geom else torch.tensor(rgb))
    for name in ("image", "valid"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    # the raw maps' normals are finite differences (an ulp of a vertex)
    for name, atol in (("vert", ATOL), ("normal", NORMAL_ATOL)):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=atol, err_msg=name)


def test_ftf_tracking_matches_jax():
    """'-ftf' tracks photometrically against the previous raw frame: per
    frame the port's pose within the bar of JAX's, counts exact; and the
    option changes the port's trajectory (test_flags_r2.py's check)."""
    frames, gt, _ = make_sequence(TINY, N, kind="orbit")
    # a low global confidence, so the prediction renders within 6 frames and
    # the two image sources differ
    fusion = dict(depth_cutoff=4.5, confidence_global=0.5)
    kw = dict(max_models=1, max_surfels=1 << 13)
    jeng = JaxCoFusion(CoFusionConfig(camera=TINY, **kw), fusion_params=FusionParams(**fusion),
                       frame_to_frame_rgb=True)
    runs = {}
    for ftf in (True, False):
        teng = CoFusion(tcfg.CoFusionConfig(camera=_tcam(TINY), **kw),
                        fusion_params=tcfg.FusionParams(**fusion), frame_to_frame_rgb=ftf,
                        device="cpu")
        runs[ftf] = [(teng.process_frame(f, sync=True).get("poses"),
                      teng.stats()["surfel_counts"].tolist()) for f in frames]
    for step, f in enumerate(frames):
        jeng.process_frame(f)
        st = jeng.stats()
        pose, counts = runs[True][step]
        assert counts == st["surfel_counts"].tolist(), step
        if step:
            np.testing.assert_allclose(pose, st["poses"], atol=_pose_bar(step), err_msg=f"frame {step}")
    final = {k: v[-1][0][0] for k, v in runs.items()}
    assert not np.allclose(final[True], final[False]), "'-ftf' had no effect"
    for k in final:
        assert np.linalg.norm(final[k][:3, 3] - gt[-1][:3, 3]) < 0.02


# --- readers: backward playback ('-r') and the colour flip ('-f')


def _reader_frames(seed=9, n=5, w=40, h=32):
    rng = np.random.default_rng(seed)
    return [{"rgb": rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
             "depth": (rng.integers(0, 5000, (h, w)) * 0.001).astype(np.float32),
             "mask": (rng.random((h, w)) < 0.3).astype(np.uint8) * 3,
             "timestamp": 1000 * i + 5} for i in range(n)]


def _make_reader(pkg, kind, root, frames):
    import cv2

    w, h = frames[0]["depth"].shape[1], frames[0]["depth"].shape[0]
    if kind != "images":
        path = os.path.join(root, "log.klg")
        if not os.path.exists(path):
            jreaders.write_klg(path, frames, w, h)
        return pkg.KlgLogReader(path, w, h)
    d = os.path.join(root, "imgs")
    if not os.path.isdir(d):
        os.makedirs(d)
        for i, f in enumerate(frames):
            cv2.imwrite(os.path.join(d, f"Color{i:04d}.png"), f["rgb"][..., ::-1])
            cv2.imwrite(os.path.join(d, f"Depth{i:04d}.png"), np.round(f["depth"] * 1000).astype(np.uint16))
            cv2.imwrite(os.path.join(d, f"Mask{i:04d}.png"), f["mask"])
    return pkg.ImageLogReader(d, mask_directory=d, png_depth_scale=0.001)


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("kind", ["klg-native", "klg-python", "images"])
def test_readers_rewind_and_get_previous_match_jax(tmp_path, monkeypatch, kind, flip):
    """Forward to the end, back to the start with get_previous, rewind and
    forward again: the port's frames equal the JAX readers' frame for frame
    (the reference's ping-pong order, test_flags_r3.py), with and without
    the colour flip."""
    if kind == "klg-python":
        monkeypatch.setattr(jreaders, "_NATIVE", False)
        monkeypatch.setattr(treaders, "_load_native", lambda: None)
    frames = _reader_frames()
    readers = [_make_reader(pkg, kind, str(tmp_path), frames) for pkg in (treaders, jreaders)]
    for r in readers:
        r.flip_colors = flip
    n = len(frames)

    def play(r):
        out = [r.get_next() for _ in range(n)]
        assert not r.has_more()
        out += [r.get_previous() for _ in range(n - 1)]
        r.rewind()
        assert r.current_frame == 0
        out += [r.get_next() for _ in range(2)]
        return out

    got, ref = (play(r) for r in readers)
    stamps = [f["timestamp"] for f in got]
    want = [f["timestamp"] for f in frames]
    assert stamps == [f["timestamp"] for f in ref]
    if kind == "images":  # synthesised at 24 Hz
        want = [int(i * 1e6 / 24.0) for i in range(n)]
    assert stamps == want + want[-2::-1] + want[:2]
    for a, b in zip(got, ref):
        for k in ("rgb", "depth"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if kind == "images":
            np.testing.assert_array_equal(a["mask"], b["mask"])
    first = frames[0]["rgb"][..., ::-1] if flip else frames[0]["rgb"]
    np.testing.assert_array_equal(got[0]["rgb"], first)
    for r in readers:
        getattr(r, "close", lambda: None)()


# --- read_ply and the PNG exports


def _surfels(seed, n=60):
    rng = np.random.default_rng(seed)
    return {
        "pos": rng.standard_normal((n, 3)).astype(np.float32),
        "normal": rng.standard_normal((n, 3)).astype(np.float32),
        "color": (rng.random((n, 3)) * 255).astype(np.float32),
        "radius": rng.random(n).astype(np.float32),
        "conf": np.linspace(0, 20, n).astype(np.float32),
    }


def test_read_ply_round_trip_matches_jax(tmp_path):
    """test_io.py's PLY round trip: the port's file read back by both
    packages' read_ply, and the JAX package's file by the port's."""
    surfels = _surfels(1)
    tpath, jpath = str(tmp_path / "t.ply"), str(tmp_path / "j.ply")
    n = texport.export_ply(tpath, surfels, conf_threshold=10.0)
    assert n == jexport.export_ply(jpath, surfels, conf_threshold=10.0) == (surfels["conf"] > 10).sum()
    with open(tpath, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    back = texport.read_ply(tpath)
    ref = jexport.read_ply(tpath)
    assert back.keys() == ref.keys()
    for k in back:
        assert back[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    keep = surfels["conf"] > 10.0
    np.testing.assert_array_equal(back["pos"], surfels["pos"][keep])
    np.testing.assert_array_equal(back["normal"], -surfels["normal"][keep])


def test_export_ply_transform(tmp_path):
    """test_fixes_r2.py's check: an object cloud exported with P_cam P_obj^-1
    lands in world coordinates, normals rotated and flipped; the file
    equals the JAX exporter's."""
    surfels = _surfels(3, n=50)
    surfels["conf"] = np.full(50, 20.0, np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec([0.2, -0.4, 0.1]).as_matrix()
    T[:3, 3] = (1.0, -2.0, 0.5)
    path = str(tmp_path / "cloud-1.ply")
    texport.export_ply(path, surfels, conf_threshold=10.0, transform=T)
    back = texport.read_ply(path)
    np.testing.assert_allclose(back["pos"], surfels["pos"] @ T[:3, :3].T + T[:3, 3], atol=1e-5)
    want_n = -(surfels["normal"] @ np.linalg.inv(T[:3, :3].astype(np.float32)))
    np.testing.assert_allclose(back["normal"], want_n, atol=1e-5)
    jexport.export_ply(str(tmp_path / "j.ply"), surfels, conf_threshold=10.0, transform=T)
    with open(path, "rb") as a, open(tmp_path / "j.ply", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("shape", [(64, 80), (1, 1), (7, 33)])
@pytest.mark.parametrize("kind", ["normals", "viewport", "segmentation", "labels"])
def test_pngs_byte_equal_jax(tmp_path, kind, shape):
    """'-en', '-ev', '-es', '-el': for the same arrays the port's PNG files
    equal the JAX exporter's (cv2.imwrite) byte for byte."""
    rng = np.random.default_rng(sum(shape))
    H, W = shape
    valid = rng.random((H, W)) < 0.7
    normal = rng.standard_normal((H, W, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    image = (rng.random((H, W, 3)) * 300 - 20).astype(np.float32)
    mask = rng.integers(0, 6, (H, W)).astype(np.uint8)
    mask[rng.random((H, W)) < 0.1] = 255
    paths = [str(tmp_path / f"{pkg}.png") for pkg in ("t", "j")]
    for ex, path in zip((texport, jexport), paths):
        if kind == "normals":
            ex.export_normal_png(path, normal, valid)
        elif kind == "viewport":
            ex.export_viewport_png(path, image, valid)
        elif kind == "segmentation":
            ex.export_mask_png(path, mask)
        else:
            ex.export_label_png(path, mask)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


# --- the CLI's remaining flags


def _klg_with_gt(root, n=N, cam=TINY):
    frames, gt, _ = make_sequence(cam, n, kind="orbit")
    klg = os.path.join(root, "log.klg")
    jreaders.write_klg(klg, frames, cam.width, cam.height)
    cal = os.path.join(root, "cal.txt")
    with open(cal, "w") as f:
        f.write(f"{cam.fx} {cam.fy} {cam.cx} {cam.cy} {cam.width} {cam.height}")
    gt_file = os.path.join(root, "gt.txt")
    with open(gt_file, "w") as f:
        for fr, T in zip(frames, gt):
            f.write(jexport.pose_to_tum_line(fr["timestamp"], T.astype(np.float32)) + "\n")
    return klg, cal, gt_file, frames, gt


def test_cli_flags_reach_engine_like_jax(tmp_path):
    """Every flag this slice adds lands where the JAX CLI puts it."""
    from cofusion_tpu import cli as jcli

    klg, cal, gt_file, _, _ = _klg_with_gt(str(tmp_path))
    argv = ["-l", klg, "-cal", cal, "-static", "-p", gt_file, "-en", "-ev", "-or", "-4.5", "-fo",
            "-nso", "-ftf", "-icl", "-f", "-r", "-fs", "-checkpoint", "a.ckpt", "-resume", "b.ckpt"]
    reader, eng, opt = cli.build_from_args(argv + ["-device", "cpu"])
    jreader, jeng, jopt = jcli.build_from_args(argv)
    assert eng.cfg.fast_odom is jeng.cfg.fast_odom is True
    assert eng.cfg.use_so3 is jeng.cfg.use_so3 is False
    assert eng.fusion.outlier_coefficient == jeng.fusion.outlier_coefficient == -4.5
    assert eng._fparams["outlier_coeff"] == -4.5
    assert eng.frame_to_frame_rgb is jeng.frame_to_frame_rgb is True and eng._fparams["ftf"]
    assert reader.flip_colors is jreader.flip_colors is True
    for key in ("frame_skip", "rewind", "export_models", "icl", "export_normals",
                "export_viewport", "checkpoint", "resume"):
        assert opt[key] == jopt[key], key
    assert isinstance(opt["ground_truth"], GroundTruthOdometry)
    _, eng2, opt2 = cli.build_from_args(["-l", klg, "-cal", cal, "-device", "cpu"])
    assert eng2.cfg.use_so3 and not eng2.cfg.fast_odom and not eng2.frame_to_frame_rgb
    assert eng2.fusion.outlier_coefficient == 3.0 and opt2["ground_truth"] is None
    assert not (opt2["rewind"] or opt2["frame_skip"] or opt2["export_models"])


def test_cli_gt_pose_and_view_exports(tmp_path):
    """`-p -en -ev -or -fo -nso -icl -f` on the CPU: the pose file replays
    the ground truth, every frame writes Normals<tick-1>.png and
    Viewport<tick-1>.png, and '-icl' writes the model."""
    klg, cal, gt_file, frames, gt = _klg_with_gt(str(tmp_path))
    out = str(tmp_path / "out")
    rc = cli.run(["-l", klg, "-cal", cal, "-static", "-p", gt_file, "-en", "-ev", "-or", "5",
                  "-fo", "-nso", "-icl", "-f", "-ep", "-d", "4.5", "-confG", "1.5", "-ns", "8192",
                  "-exportdir", out, "-device", "cpu"])
    assert rc == 0
    ts, poses = texport.load_tum_trajectory(os.path.join(out, "poses-0.txt"))
    assert len(ts) == N
    for i in range(N):
        np.testing.assert_allclose(poses[i][:3, 3], gt[i][:3, 3], atol=1e-4)
        np.testing.assert_allclose(poses[i][:3, :3], gt[i][:3, :3], atol=1e-4)
    for t in range(N):
        for name in (f"Normals{t}.png", f"Viewport{t}.png"):
            assert os.path.exists(os.path.join(out, name)), name
    assert texport.read_ply(os.path.join(out, "cloud-0.ply"))["pos"].shape[0] > 0


def test_cli_rewind_and_frame_skip(tmp_path, monkeypatch):
    """'-r' plays the log forward then backward, 2N - 2 frames by default;
    '-fs' drops a frame for every sensor period the last `Run` took beyond
    the first (here a `Run` of 70 ms: 2 frames dropped after each); and
    `-p -en -ev -or -fo -nso -icl -f -r -fs` together."""
    from cofusion_tpu_torch.utils.stopwatch import Stopwatch

    klg, cal, gt_file, frames, _ = _klg_with_gt(str(tmp_path), n=4)
    stamps = [f["timestamp"] for f in frames]
    seen = []
    orig = CoFusion.process_frame

    def record(self, frame, *a, **kw):
        seen.append(frame["timestamp"])
        return orig(self, frame, *a, **kw)

    monkeypatch.setattr(CoFusion, "process_frame", record)
    base = ["-l", klg, "-cal", cal, "-static", "-d", "4.5", "-ns", "8192", "-device", "cpu"]
    assert cli.run(base + ["-r"]) == 0
    assert seen == stamps + stamps[-2:0:-1]
    seen.clear()
    monkeypatch.setattr(Stopwatch, "timings", lambda self: {"Run": 70.0})
    assert cli.run(base + ["-fs"]) == 0
    assert seen == [stamps[0], stamps[3]]
    # every flag of this slice in one run: forward 0, 3 (1-2 dropped), then
    # back from 2, each frame with its ground-truth pose and its views
    seen.clear()
    out = str(tmp_path / "all")
    assert cli.run(base + ["-p", gt_file, "-en", "-ev", "-or", "5", "-fo", "-nso", "-icl", "-f",
                           "-r", "-fs", "-ep", "-exportdir", out]) == 0
    assert seen[:2] == [stamps[0], stamps[3]] and len(seen) == 6
    assert sorted(os.listdir(out)) == sorted(
        ["cloud-0.ply", "poses-0.txt"] + [f"{k}{t}.png" for k in ("Normals", "Viewport")
                                          for t in range(6)])
