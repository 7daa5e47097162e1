"""The port's static engine (cofusion_tpu_torch/engine.py) against the JAX
engine on the CPU, over one 12-frame small_cam orbit written to a .klg log
and read back (so the engines and the CLI see the identical frames).

Bars:
  * per-frame camera poses: within 1e-5 + 2e-6*step — one GN solve's fp32
    reduction-order noise (~1e-7 relative, amplified by the 6x6 system's
    conditioning) compounded over frames; the bound `__graft_entry__.py:162-176`
    derives for the JAX engine's own sharded-vs-single-device runs;
  * surfel counts (active tier and stable ring): exact;
  * one step from the identical converted state: the pose within 1e-5, the
    counts and valid masks exact, surfel attributes rtol=1e-5, atol=1e-5
    (normals atol=1e-4, see NORMAL_ATOL);
  * the port's rerun: bit-identical poses and map.

Counts are exact on this orbit at confidence 1.5.  At the default 10 one
surfel of frame 9 merges in the port where JAX appends it (21296 vs 21297):
a ~1e-6 pose difference from fp32 reduction order flips one association
gate — traced in ROADMAP C6; the one-step check from the identical state
stays exact there.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from cofusion_tpu.config import CoFusionConfig, FusionParams
from cofusion_tpu.engine import CoFusion as JaxCoFusion
from cofusion_tpu.io.readers import KlgLogReader, write_klg
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu.utils import export as jexport
from cofusion_tpu_torch import cli, convert
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch.engine import CoFusion, _step
from cofusion_tpu_torch.utils import export as texport

from torch_shared import shared  # noqa: F401  (a fixture)

torch.set_num_threads(1)
N_FRAMES = 12
ONE_STEP_AFTER = 5
# frame normals are cross products of neighbouring vertex differences: the
# jitted JAX step contracts the vertex multiply-adds into FMAs, and the
# finite difference amplifies that ulp by |v|/|dv| ~ 10^2
NORMAL_ATOL = 1e-4
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(cam):
    return CoFusionConfig(camera=cam, max_models=1, max_surfels=1 << 17)


def _tcfg(cam):
    """The port's configuration equal to `_cfg(cam)`."""
    return tcfg.CoFusionConfig(
        camera=tcfg.CameraConfig(**dataclasses.asdict(cam)), max_models=1, max_surfels=1 << 17
    )


# confidence 1.5 (as tests/test_e2e_cli.py): the default 10 is reached by no
# surfel within 12 frames, which would leave the exported PLY empty
FUSION = FusionParams(depth_cutoff=4.5, confidence_global=1.5)
TFUSION = tcfg.FusionParams(depth_cutoff=4.5, confidence_global=1.5)


def _pose_bar(step):
    return 1e-5 + 2e-6 * step


def _jax_run(root, small_cam):
    """Frames decoded from a .klg log, and the JAX engine's run over them:
    per-frame poses and surfel counts, and numpy copies of its state after
    ONE_STEP_AFTER and ONE_STEP_AFTER + 1 frames."""
    frames, gt, _ = make_sequence(small_cam, N_FRAMES, kind="orbit")
    klg = str(root / "orbit.klg")
    write_klg(klg, frames, small_cam.width, small_cam.height)
    reader = KlgLogReader(klg, small_cam.width, small_cam.height)
    decoded = [reader.get_next() for _ in range(N_FRAMES)]

    eng = JaxCoFusion(_cfg(small_cam), fusion_params=FUSION)
    counts, states = [], {}
    for i, f in enumerate(decoded):
        eng.process_frame(f)
        st = eng.stats()
        counts.append(int(st["surfel_counts"][0]))
        if i + 1 in (ONE_STEP_AFTER, ONE_STEP_AFTER + 1):
            # np.array copies: the next jitted step donates the state buffers
            states[i + 1] = jax.tree.map(lambda a: np.array(a), eng.state)
    poses = [p[0] for _, p in eng.pose_log]
    jexport.export_poses("", eng.pose_log_for(0), 0, str(root / "jax_out"))
    n_ply = jexport.export_ply(
        str(root / "jax_out" / "cloud-0.ply"), eng.download_model(0),
        conf_threshold=float(eng.state.models.conf_threshold[0]),
    )
    return dict(root=root, klg=klg, frames=decoded, gt=gt, poses=poses, counts=counts,
                states=states, n_ply=n_ply)


@pytest.fixture
def data(shared, small_cam):
    """The JAX run of `_jax_run`, made once per test session (its files in
    the session's shared directory, which the tests only read)."""
    return shared.get("torch_engine_jax", lambda: _jax_run(shared.fresh_dir("torch_engine"), small_cam))


def _run_port(cam, frames):
    eng = CoFusion(_tcfg(cam), fusion_params=TFUSION, device="cpu")
    counts = []
    for f in frames:
        eng.process_frame(f)
        counts.append(int(eng.stats()["surfel_counts"][0]))
    return eng, [p[0] for _, p in eng.pose_log], counts


def _tiers(eng):
    return {tier: tuple(getattr(eng.state.models, tier)) for tier in ("store", "stable")}


@pytest.fixture
def port_run(shared, data, small_cam):
    """The port's run over the same frames, made once per test session:
    (both tiers' tensors by field, poses, counts)."""
    def run():
        eng, poses, counts = _run_port(small_cam, data["frames"])
        return _tiers(eng), poses, counts

    return shared.get("torch_engine_port", run)


def test_orbit_matches_jax_engine(data, port_run):
    _, poses, counts = port_run
    assert len(poses) == len(data["poses"]) == N_FRAMES
    for step, (p, j) in enumerate(zip(poses, data["poses"])):
        np.testing.assert_allclose(p, j, atol=_pose_bar(step), err_msg=f"frame {step}")
    assert counts == data["counts"]
    # and the run is healthy: millimetre tracking on the synthetic orbit
    err = [np.linalg.norm(p[:3, 3] - g[:3, 3]) for p, g in zip(poses, data["gt"])]
    assert np.sqrt(np.mean(np.square(err))) < 0.003


def test_one_step_from_converted_jax_state(data, small_cam):
    before = data["states"][ONE_STEP_AFTER]
    after = data["states"][ONE_STEP_AFTER + 1]
    state = convert.state_from_numpy(before)
    assert state.tick == ONE_STEP_AFTER
    # the conversion round-trips
    back = convert.state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(tuple(before))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    f = data["frames"][ONE_STEP_AFTER]
    fparams = dict(depth_cutoff=4.5, outlier_coeff=3.0, icp_weight=10.0, time_delta=200,
                   weight_multiplier=1.0)
    cfg = _tcfg(small_cam)
    new_state, out = _step(
        state, torch.from_numpy(f["rgb"].astype(np.float32)), torch.from_numpy(f["depth"]),
        torch.zeros(small_cam.shape, dtype=torch.int32), fparams,
        cam=cfg.camera, cfg=cfg, tparams=tcfg.TrackingParams(),
    )
    ref_models = after.models
    assert new_state.tick == ONE_STEP_AFTER + 1
    np.testing.assert_allclose(new_state.models.pose.numpy(), ref_models.pose, atol=1e-5)
    got = convert.state_to_numpy(new_state)
    for tier in ("store", "stable"):
        t, j = getattr(got.models, tier), getattr(ref_models, tier)
        assert int(t.count[0]) == int(j.count[0]), tier
        np.testing.assert_array_equal(t.valid, j.valid, err_msg=tier)
        for name in t._fields[:-2]:
            np.testing.assert_allclose(
                getattr(t, name), getattr(j, name), rtol=1e-5,
                atol=NORMAL_ATOL if name in ("nx", "ny", "nz") else 1e-5, err_msg=f"{tier}.{name}",
            )
    np.testing.assert_array_equal(out.surfel_counts.numpy(), ref_models.store.count)


def test_port_rerun_is_bit_identical(data, port_run, small_cam):
    tiers1, poses1, counts1 = port_run
    eng2, poses2, counts2 = _run_port(small_cam, data["frames"])
    assert counts1 == counts2
    for a, b in zip(poses1, poses2):
        np.testing.assert_array_equal(a, b)
    tiers2 = _tiers(eng2)
    for tier in ("store", "stable"):
        for name, a, b in zip(eng2.state.models.store._fields, tiers1[tier], tiers2[tier]):
            assert torch.equal(a, b), f"{tier}.{name}"


def test_cli_static_export_matches_jax_engine(data, small_cam, tmp_path):
    """`python -m cofusion_tpu_torch -l <klg> -static ...` on the CPU: the
    TUM pose file matches the JAX engine's pose log (within the pose bar
    plus the exporter's 6-significant-digit text), line for line in the JAX
    exporter's format; the PLY reads back with the JAX package's reader."""
    from cofusion_tpu.utils.export import load_tum_trajectory, read_ply

    root = data["root"]
    cal = tmp_path / "calib.txt"
    cal.write_text(f"{small_cam.fx} {small_cam.fy} {small_cam.cx} {small_cam.cy} "
                   f"{small_cam.width} {small_cam.height}\n")
    out = tmp_path / "port_out"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "cofusion_tpu_torch", "-l", data["klg"], "-cal", str(cal),
         "-static", "-run", "-q", "-d", "4.5", "-confG", "1.5", "-ns", str(1 << 17), "-device", "cpu",
         "-ep", "-em", "-exportdir", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=_REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert f"Processed {N_FRAMES} frames." in proc.stdout

    port_lines = (out / "poses-0.txt").read_text().splitlines()
    jax_lines = (root / "jax_out" / "poses-0.txt").read_text().splitlines()
    assert len(port_lines) == len(jax_lines) == N_FRAMES
    for a, b in zip(port_lines, jax_lines):
        pa, pb = a.split(" "), b.split(" ")
        assert len(pa) == len(pb) == 8 and pa[0] == pb[0]
    ts, poses = load_tum_trajectory(str(out / "poses-0.txt"))
    np.testing.assert_array_equal(ts, np.arange(N_FRAMES))
    for step, (p, j) in enumerate(zip(poses, data["poses"])):
        np.testing.assert_allclose(p, j, atol=_pose_bar(step) + 5e-6, err_msg=f"frame {step}")
    # the port's own reader and ATE agree with the JAX package's
    t_ts, t_poses = texport.load_tum_trajectory(str(out / "poses-0.txt"))
    np.testing.assert_array_equal(t_ts, ts)
    np.testing.assert_allclose(t_poses, poses, atol=1e-6)
    for align in (False, True):
        assert abs(
            texport.ate_rmse(list(t_poses), data["gt"], align=align)
            - jexport.ate_rmse(list(poses), data["gt"], align=align)
        ) < 1e-6

    ply = read_ply(str(out / "cloud-0.ply"))
    n = ply["pos"].shape[0]
    assert n > 0 and np.isfinite(ply["pos"]).all()
    assert n == data["n_ply"]
    assert 1.0 < ply["pos"][:, 2].min() and ply["pos"][:, 2].max() < 3.5


@pytest.mark.parametrize(
    "option",
    ["enable_relocalization", "close_loops", "frame_to_frame_rgb"],
)
def test_unported_engine_options_raise(small_cam, option):
    """Every engine option of the JAX package is ported (relocalisation and
    loop closure in ROADMAP A12-A13, frame-to-frame RGB in A14): each builds
    an engine with the option on, and '-ftf' reaches the step's scalars."""
    eng = CoFusion(_tcfg(small_cam), device="cpu", **{option: True})
    assert getattr(eng, option) is True
    assert eng._fparams["ftf"] is (option == "frame_to_frame_rgb")


def test_cli_device_defaults_to_cuda_and_refuses_without_it(data, monkeypatch):
    """No quiet CPU fallback: without `-device cpu` the CLI asks for CUDA and
    fails where it is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.build_from_args(["-l", data["klg"], "-static"])
