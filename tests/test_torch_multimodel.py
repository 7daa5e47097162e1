"""The port's multi-model engine with ground-truth masks against the JAX
engine on the CPU: `tests/test_multimodel.py`'s exact configuration
(small_cam, max_models=3, 2^16 surfels, 8 orbit frames with a sliding box),
so the JAX package's compile cache serves both files; and a lifecycle
scenario (spawn cooldown, unseen deactivation, smart delete against
`-keep`, a recycled slot at identity pose).  Each engine comparison runs
inside one test function; the JAX engines of one worker share one jitted
step (tests/torch_shared.py `share_jax_steps`: one configuration).

Bars:
  * camera poses within 1e-5 + 2e-6*step on every frame (the fp32
    reduction-order bound of tests/test_torch_engine.py);
  * active flags and listener events exact on every frame;
  * one step of the JAX engine from the port's own state at every frame
    (carried across by convert.py): every slot's pose within 1e-5, surfel
    counts, active flags and the segmentation mask exact — every step of
    the port's run is held to the reference;
  * one step of the port from the JAX engine's state at every frame: every
    pose within 1e-5, counts exact;
  * the whole runs: object poses within the bar plus the reference's own
    response (how far the JAX step from the port's state lands from the
    JAX run), counts equal wherever that JAX step's counts equal the JAX
    run's.  A small object's solve can turn a ~1e-7 state difference
    into ~1e-3 in the reference itself (ROADMAP C8), so the runs may part
    there, and only there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofusion_tpu.config import CoFusionConfig, FusionParams
from cofusion_tpu.engine import CoFusion as JaxCoFusion
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu_torch import config as tcfg
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.engine import CoFusion, EngineState, _step

from torch_shared import share_jax_steps

torch.set_num_threads(1)
M = 3


def _pose_bar(step):
    return 1e-5 + 2e-6 * step


def _engines(cam, keep=False, **fusion):
    """A JAX engine and the port's, on test_multimodel.py's configuration."""
    jeng = share_jax_steps(JaxCoFusion(
        CoFusionConfig(camera=cam, max_models=M, max_surfels=1 << 16),
        fusion_params=FusionParams(**fusion), enable_multi_model=True, keep_models=keep,
    ))
    tcam = tcfg.CameraConfig(**dataclasses.asdict(cam))
    teng = CoFusion(
        tcfg.CoFusionConfig(camera=tcam, max_models=M, max_surfels=1 << 16),
        fusion_params=tcfg.FusionParams(**fusion), enable_multi_model=True, keep_models=keep,
        device="cpu",
    )
    return jeng, teng


def _record_steps(jeng):
    """Wrap the JAX engine's jitted steps so that every call's step function
    and inputs (rgb, depth, mask, fparams) are kept for replay."""
    calls = []
    get = jeng._get_step

    def wrapped(*a, **k):
        fn = get(*a, **k)

        def step(state, *args):
            calls.append((fn, args))
            return fn(state, *args)

        return step

    jeng._get_step = wrapped
    return calls


def _play(eng, frames, snapshot=False):
    """Per-frame (poses, active, counts), the listener events and, with
    `snapshot`, numpy copies of the state after every frame (keyed by the
    number of frames played) and the host slot masks fed to each step."""
    events = []
    eng.add_new_model_listener(lambda s: events.append((len(log), "new", s)))
    eng.add_inactive_model_listener(lambda s: events.append((len(log), "inactive", s)))
    log, states, masks = [], {}, {}
    for i, f in enumerate(frames):
        eng.process_frame(f)
        st = eng.stats()
        log.append((np.asarray(st["poses"]), np.asarray(st["active"]), np.asarray(st["surfel_counts"])))
        if snapshot:
            state = eng.state
            if isinstance(state, EngineState):  # the port's steps update stores in place
                state = convert.state_to_numpy(state)
            # np.array copies: the next jitted step donates the state buffers
            states[i + 1] = jax.tree.map(lambda a: np.array(a), state)
            masks[i] = np.array(eng.current_segmentation())
    return log, events, states, masks


def _counts(models):
    return np.asarray(models.store.count) + np.minimum(
        np.asarray(models.stable.count), np.asarray(models.stable.valid).shape[1]
    )


def _cross_steps(jeng, calls, tstates, tlog):
    """One JAX step from the port's state after every frame, against the
    port's next frame.  Returns per frame the JAX step's (poses, counts)."""
    treedef = jax.tree.structure(jeng.state)
    out = [(tlog[0][0], tlog[0][2])]
    for k, (fn, args) in enumerate(calls, start=1):
        leaves = jax.tree.leaves(tstates[k])
        assert len(leaves) == treedef.num_leaves
        new, _ = fn(jax.tree.unflatten(treedef, [jnp.asarray(a) for a in leaves]), *args)
        pose, counts = np.asarray(new.models.pose), _counts(new.models)
        tpose, tactive, tcounts = tlog[k]
        np.testing.assert_allclose(tpose, pose, atol=1e-5, err_msg=f"JAX step from port state, frame {k}")
        np.testing.assert_array_equal(tcounts, counts, err_msg=f"counts, frame {k}")
        np.testing.assert_array_equal(tactive, np.asarray(new.models.active), err_msg=f"active, frame {k}")
        np.testing.assert_array_equal(
            tstates[k + 1].prev_mask, np.asarray(new.prev_mask), err_msg=f"mask, frame {k}"
        )
        out.append((pose, counts))
    return out


def _compare_runs(jlog, tlog, cross):
    """The whole-run bars of the module docstring; returns the first frame
    at which an object pose leaves the bar or a count differs (len(jlog) if
    none does) and the reference's own response there."""
    flip, note = len(jlog), ""
    for step, ((jp, ja, jc), (tp, ta, tc), (cp, cc)) in enumerate(zip(jlog, tlog, cross)):
        np.testing.assert_allclose(tp[0], jp[0], atol=_pose_bar(step), err_msg=f"camera, frame {step}")
        np.testing.assert_array_equal(ta, ja, err_msg=f"active, frame {step}")
        response = np.abs(cp - jp).max()
        assert np.abs(tp - jp).max() <= _pose_bar(step) + response, f"poses, frame {step}"
        assert (tc == jc).all() or (cc != jc).any(), f"counts, frame {step}: {tc} vs {jc}"
        if flip == len(jlog) and (np.abs(tp - jp).max() > _pose_bar(step) or (tc != jc).any()):
            flip = step
            note = (f"pose |d| {np.abs(tp - jp).max():.3g}, counts {tc} vs {jc}; the JAX step from "
                    f"the port's state: pose |d| {response:.3g} from the JAX run, counts {cc}")
    print(f"first frame off the bar: {flip} of {len(jlog)} {note}")
    return flip


def _one_step(teng, state_np, frame, mask, new_slot):
    cfg = teng.cfg
    fparams = dict(teng._fparams, weight_multiplier=1.0, new_slot=new_slot,
                   allow_new=new_slot >= 0, gt_masks=True)
    state = convert.state_from_numpy(state_np)
    return _step(
        state, torch.from_numpy(frame["rgb"].astype(np.float32)), torch.from_numpy(frame["depth"]),
        torch.from_numpy(mask.astype(np.int32)), fparams,
        cam=cfg.camera, cfg=cfg, tparams=tcfg.TrackingParams(), sparams=teng.segmentation,
    )[0]


def test_gt_mask_engine_matches_jax_engine(small_cam):
    """8 frames of test_multimodel.py's run through both engines, one JAX
    step from each port state and one port step from each JAX state (the
    states carried across by convert.py round-trip exactly)."""
    fusion = dict(depth_cutoff=4.5, confidence_object=0.01, model_spawn_offset=0)
    jeng, teng = _engines(small_cam, **fusion)
    frames, _, _ = make_sequence(small_cam, 8, kind="orbit", moving_object=True)
    calls = _record_steps(jeng)
    jlog, jev, states, masks = _play(jeng, frames, snapshot=True)
    tlog, tev, tstates, _ = _play(teng, frames, snapshot=True)

    assert jev == tev == [(1, "new", 1)]
    assert jlog[-1][1].tolist() == [True, True, False] and jlog[-1][2][1] > 200
    _compare_runs(jlog, tlog, _cross_steps(jeng, calls, tstates, tlog))

    back = convert.state_to_numpy(convert.state_from_numpy(states[4]))
    for a, b in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(tuple(states[4]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k in range(1, len(frames)):
        spawned = [s for f, kind, s in jev if f == k and kind == "new"]
        new = _one_step(teng, states[k], frames[k], masks[k], spawned[0] if spawned else -1)
        ref = states[k + 1].models
        np.testing.assert_allclose(new.models.pose.numpy(), ref.pose, atol=1e-5, err_msg=f"step {k}")
        for tier in ("store", "stable"):
            np.testing.assert_array_equal(
                getattr(new.models, tier).count.numpy(), getattr(ref, tier).count, err_msg=f"{tier} {k}"
            )
        np.testing.assert_array_equal(new.models.active.numpy(), ref.active)
        np.testing.assert_array_equal(new.prev_mask.numpy(), states[k + 1].prev_mask)


def _lifecycle_frames(cam):
    """12 frames of the sliding box: dataset id 5 on frames 1-5, no object
    id on frames 6-7, a new id 9 on frames 8-11 (the same box, seen as a
    new object)."""
    frames, _, _ = make_sequence(cam, 12, kind="orbit", moving_object=True)
    for i, f in enumerate(frames):
        box = f["mask"] == 1
        vid = 5 if 1 <= i <= 5 else 9 if i >= 8 else 0
        f["mask"] = np.where(box, vid, 0).astype(np.uint8)
    return frames


@pytest.mark.parametrize("keep", [False, True])
def test_lifecycle_matches_jax_engine(small_cam, keep):
    """Spawn offset 2: id 5 first appears at frame 1, the cooldown admits it
    at frame 3.  Deactivate count 2: unseen at frames 6-7, deactivated at
    frame 7; the ~300-surfel map is below smart delete's 4000, so it is
    wiped unless '-keep'.  Id 9 at frame 8 recycles slot 1 at identity
    pose."""
    fusion = dict(depth_cutoff=4.5, confidence_object=0.01, model_spawn_offset=2,
                  model_deactivate_count=2)
    jeng, teng = _engines(small_cam, keep=keep, **fusion)
    frames = _lifecycle_frames(small_cam)
    calls = _record_steps(jeng)
    jlog, jev, _, _ = _play(jeng, frames)
    tlog, tev, tstates, _ = _play(teng, frames, snapshot=True)

    assert jev == tev == [(3, "new", 1), (7, "inactive", 1), (8, "new", 1)], (jev, tev)
    active1 = [bool(a[1][1]) for a in tlog]
    assert active1 == [False] * 3 + [True] * 4 + [False] + [True] * 4, active1
    # the deactivated map: wiped by smart delete, or kept by '-keep'
    assert (tlog[7][2][1] > 0) == keep and (jlog[7][2][1] > 0) == keep
    # the recycled slot restarts at identity pose with the object threshold
    for log, eng in ((tlog, teng), (jlog, jeng)):
        np.testing.assert_array_equal(log[8][0][1], np.eye(4, dtype=np.float32))
    assert float(teng.state.models.conf_threshold[1]) == float(jeng.state.models.conf_threshold[1])
    _compare_runs(jlog, tlog, _cross_steps(jeng, calls, tstates, tlog))


def test_cli_multi_model_with_masks(small_cam, tmp_path):
    """`python -m cofusion_tpu_torch -dir <images with masks> -es -el -ep -em`
    without `-static` on the CPU: 4 model slots, the object spawns from its
    mask, the exported segmentation equals the host's remap of the masks
    read back, and every model ever active gets a pose log and a cloud (the
    object's in the world frame)."""
    import os
    import subprocess
    import sys

    import cv2

    from cofusion_tpu_torch.utils import export as texport

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    frames, _, _ = make_sequence(small_cam, 6, kind="orbit", moving_object=True)
    data = tmp_path / "seq"
    data.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(data / f"Color{i:04d}.png"), f["rgb"][..., ::-1])
        cv2.imwrite(str(data / f"Depth{i:04d}.png"), np.round(f["depth"] * 1000).astype(np.uint16))
        cv2.imwrite(str(data / f"Mask{i:04d}.png"), np.where(f["mask"] == 1, 7, 0).astype(np.uint8))
    c = small_cam
    (data / "calibration.txt").write_text(f"{c.fx} {c.fy} {c.cx} {c.cy} {c.width} {c.height}\n")
    out = tmp_path / "out"
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=repo)
    proc = subprocess.run(
        [sys.executable, "-m", "cofusion_tpu_torch", "-dir", str(data), "-maskdir", str(data),
         "-pngScale", "0.001", "-d", "4.5", "-confG", "1.5", "-confO", "0.01", "-offset", "0",
         "-ns", str(1 << 16), "-device", "cpu", "-es", "-el", "-ep", "-em", "-exportdir", str(out)],
        capture_output=True, text=True, timeout=300, env=env, cwd=repo,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Processed 6 frames." in proc.stdout
    for tick in range(2, 7):  # frame i is processed at tick i + 1
        seg = cv2.imread(str(out / f"Segmentation{tick}.png"), cv2.IMREAD_UNCHANGED)
        want = np.where(frames[tick - 1]["mask"] == 1, 1, 0)
        np.testing.assert_array_equal(seg, want, err_msg=f"tick {tick}")
        labels = cv2.imread(str(out / f"Labels{tick - 1}.png"))[..., ::-1]
        np.testing.assert_array_equal(labels, texport.colorize_labels(want.astype(np.uint8)))
    for m in (0, 1):
        ts, poses = texport.load_tum_trajectory(str(out / f"poses-{m}.txt"))
        assert len(ts) == 6 and np.isfinite(poses).all()
    assert not (out / "poses-2.txt").exists()
    from cofusion_tpu.utils.export import read_ply

    obj = read_ply(str(out / "cloud-1.ply"))["pos"]
    assert obj.shape[0] > 50
    # the object's cloud lies in the world frame, around the sliding box
    centre = np.median(obj, axis=0)
    assert np.linalg.norm(centre - np.array([0.14 + 0.22, -0.32 + 0.1, 1.82])) < 0.35, centre


@pytest.mark.parametrize("flag", ["-rl", "-cl", "-p"])
def test_cli_refuses_what_multi_model_leaves_out(flag):
    """What the multi-model path left out is ported since: relocalisation
    and loop closure (ROADMAP A12-A13) and ground-truth poses (A14).  The
    CLI takes each flag and goes on to open the log."""
    from cofusion_tpu_torch import cli

    with pytest.raises(OSError, match="missing.klg"):
        cli.build_from_args(["-l", "missing.klg", flag, "x"])


def test_active_readback_double_buffer():
    """The CRF path's read-back alternates two buffers: a started copy
    keeps its values after the next one starts, until it is consumed."""
    from cofusion_tpu_torch.engine import _ActiveReadback

    rb = _ActiveReadback(3, torch.device("cpu"))
    first = rb.start(torch.tensor([True, False, True]))
    second = rb.start(torch.tensor([True, True, False]))
    assert first[0] is not second[0]
    np.testing.assert_array_equal(_ActiveReadback.finish(first), [True, False, True])
    np.testing.assert_array_equal(_ActiveReadback.finish(second), [True, True, False])
    third = rb.start(torch.tensor([False, False, False]))
    assert third[0] is first[0]
