"""The port's CLI end to end against the JAX CLI: one synthetic image-dir
dataset on disk, both `cli.run`s with tests/test_e2e_cli.py's flags, both
export directories scored by both packages' tools (tools/evaluate.py and
cofusion_tpu_torch.tools.evaluate).  The port's counterpart of
tests/test_e2e_cli.py.

The dataset: small_cam (160x128), FRAMES frames of the orbit with a moving
object, written by `_write_dataset` (Color/Depth PNGs and calibration.txt,
the ground-truth masks in a sibling directory, so both engines run the CRF
path).  Cuts, for the CPU's time: FRAMES = 30 (the JAX test plays 60; the
two CLIs, the JAX compile and the replayed steps took ~300 s at 60 on one
worker, ~130 s at 30; the 30-frame orbit moves the object twice as far a
frame, and neither engine spawns a model for it, where at 60 frames both
do, at different frames: ROADMAP C13, traced by tests/torch_trace_c13.py),
and `-ns 65536` surfels a slot (the CLI's default 4 x 2^20 runs the port
at ~1.7 s a frame here; 2^16 is the capacity of the other CPU engine
tests at small_cam, 3.2x a frame's pixels).

Bars (those of the port's other whole-run tests, ROADMAP "Bars", C8):
  * the two evaluators print the same JSON line on each export directory;
  * every step of the port's run is the reference's step from the same
    state: before each frame k >= 1 the JAX CLI's recorded step runs from
    the port's state, and its camera pose must lie within 1e-5 x max(1,
    condition / 1e2) of the port's (the condition that of the port's
    worst-conditioned 6x6 camera system in that step), its surfel counts
    and active flags equal the port's;
  * the camera track of the exported pose files within the per-frame
    whole-run bar (1e-5 + 2e-6 x k) x max(1, condition / 1e2) plus the
    reference's own response to the port's state (that same JAX step's
    camera against the JAX run's at frame k); the counts of the two runs
    part only where that JAX step's counts part from the JAX run's too;
  * spawn frames and the models exported equal, or else parted only as
    the reference parts: the step-by-step bar above makes every one of
    the port's spawns (and non-spawns) the reference's own decision from
    the port's state, and the runs' states differ by the reference's
    response to rounding (ROADMAP C13: on this sequence the whole runs'
    cameras part from ~1e-6 at frame 4 to millimetres, with every step
    agreeing to ~1e-7 both ways);
  * the port's ATE within the largest camera bar of the run of the
    reference's.  Mean IoU is printed, not held: it follows the spawn
    frame.  Neither is held to the 3 cm / 0.45 bounds, which the
    reference itself fails (ROADMAP C1).
"""

import contextlib
import importlib.util
import io
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cofusion_tpu import cli as jcli
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu_torch import cli as tcli
from cofusion_tpu_torch import convert
from cofusion_tpu_torch.ops import odometry as tod
from cofusion_tpu_torch.tools import evaluate as tevaluate
from cofusion_tpu_torch.utils.export import load_tum_trajectory

from test_e2e_cli import _write_dataset
import test_torch_multimodel as mm

torch.set_num_threads(1)
FRAMES = 30
FLAGS = ["-run", "-q", "-d", "4.5", "-confG", "1.5", "-confO", "0.01", "-offset", "4",
         "-ep", "-es", "-ns", str(1 << 16)]
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_evaluate():
    spec = importlib.util.spec_from_file_location("jax_tools_evaluate", os.path.join(_REPO, "tools", "evaluate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json_line(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue().strip().splitlines()[-1]


class _Recorder:
    """Wraps a CLI's `build_from_args` to keep its engine, its lifecycle
    events and, after every frame, (poses, active, counts); `before(eng)`
    runs before every frame."""

    def __init__(self, cli, before=None):
        self.cli, self.build, self.before = cli, cli.build_from_args, before
        self.log, self.events = [], []
        cli.build_from_args = self._build

    def _build(self, argv):
        reader, eng, opt = self.build(argv)
        self.engine = eng
        eng.add_new_model_listener(lambda s: self.events.append((len(self.log), "new", s)))
        eng.add_inactive_model_listener(lambda s: self.events.append((len(self.log), "inactive", s)))
        step = eng.process_frame

        def process_frame(frame, **kw):
            if self.before is not None:
                self.before(eng)
            step(frame, **kw)
            st = eng.stats()
            self.log.append((np.asarray(st["poses"]), np.asarray(st["active"]),
                             np.asarray(st["surfel_counts"])))

        eng.process_frame = process_frame
        return reader, eng, opt

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cli.build_from_args = self.build


def test_cli_matches_jax_cli_end_to_end(tmp_path, small_cam):
    frames, gt_cam, _ = make_sequence(small_cam, FRAMES, kind="orbit", moving_object=True)
    ds, gt_masks = _write_dataset(str(tmp_path), small_cam, frames, with_masks=True)
    gt_npy = str(tmp_path / "gt.npy")
    np.save(gt_npy, np.stack(gt_cam))
    out = {k: str(tmp_path / f"out_{k}") for k in ("jax", "port")}

    with _Recorder(jcli) as jrec:
        calls = None

        def record(eng):
            nonlocal calls
            if calls is None:
                calls = mm._record_steps(eng)

        jrec.before = record
        assert jcli.run(["-dir", ds, *FLAGS, "-exportdir", out["jax"]]) == 0
    jeng = jrec.engine
    treedef = jax.tree.structure(jeng.state)

    # the reference's step from the port's state before every frame k >= 1
    # (the JAX CLI's recorded step k), and the condition of the port's
    # camera systems in its own step k
    replay, kappa, systems = {}, {}, []
    track = tod.track_models

    def tracked(*a, **kw):
        res = track(*a, **kw)
        systems.append(res.A[0])
        return res

    def take_kappa(k):
        conds = np.linalg.cond(torch.stack(systems).double().numpy()) if systems else [1.0]
        kappa[k] = float(np.nan_to_num(conds, nan=1.0, posinf=1.0).max())
        systems.clear()

    def respond(eng):
        k = len(trec.log)
        if k == 0:
            return
        take_kappa(k - 1)
        fn, args = calls[k - 1]
        leaves = jax.tree.leaves(jax.tree.map(np.array, convert.state_to_numpy(eng.state)))
        new, _ = fn(jax.tree.unflatten(treedef, [jnp.asarray(a) for a in leaves]), *args)
        replay[k] = (np.asarray(new.models.pose), np.asarray(new.models.active), mm._counts(new.models))

    tod.track_models = tracked
    t0 = time.perf_counter()
    try:
        with _Recorder(tcli, before=respond) as trec:
            assert tcli.run(["-dir", ds, *FLAGS, "-device", "cpu", "-exportdir", out["port"]]) == 0
        take_kappa(FRAMES - 1)
    finally:
        tod.track_models = track
    print(f"port CLI and the replayed JAX steps: {time.perf_counter() - t0:.1f} s")

    # both evaluators, both export directories
    argv = ["--gt-poses", gt_npy, "--no-align", "--gt-masks", gt_masks,
            "--min-px", str(max(60, (small_cam.width * small_cam.height) // 400))]
    scores = {}
    for k, d in out.items():
        ref = _json_line(_jax_evaluate().main, ["--export", d] + argv)
        got = _json_line(tevaluate.main, ["--export", d] + argv)
        assert got == ref, (k, got, ref)
        scores[k] = json.loads(got)
    assert len(trec.log) == len(jrec.log) == FRAMES

    # every step of the port's run is the reference's from the same state
    for k in range(1, FRAMES):
        tp, ta, tc = trec.log[k]
        rp, ra, rc = replay[k]
        scale = max(1.0, kappa[k] / 1e2)
        assert np.abs(rp[0] - tp[0]).max() <= 1e-5 * scale, (k, np.abs(rp[0] - tp[0]).max(), scale)
        np.testing.assert_array_equal(ra, ta, err_msg=f"active, the JAX step from the port's state {k}")
        np.testing.assert_array_equal(rc, tc, err_msg=f"counts, the JAX step from the port's state {k}")

    # the whole runs: the camera track of the exported files, counts
    cam = {k: load_tum_trajectory(os.path.join(d, "poses-0.txt"))[1] for k, d in out.items()}
    worst_bar, first_off = 0.0, None
    for k in range(1, FRAMES):
        (jp, ja, jc), (tp, ta, tc) = jrec.log[k], trec.log[k]
        response = float(np.abs(replay[k][0][0] - jp[0]).max())
        assert (tc == jc).all() or (replay[k][2] != jc).any(), (
            f"counts, frame {k}: {tc} vs {jc}; the JAX step from the port's state: {replay[k][2]}")
        bar = (1e-5 + 2e-6 * k) * max(1.0, kappa[k] / 1e2) + response
        worst_bar = max(worst_bar, bar)
        d = float(np.abs(cam["port"][k] - cam["jax"][k]).max())
        assert d <= bar, f"camera, frame {k}: {d} > {bar}"
        if first_off is None and d > 1e-5 + 2e-6 * k:
            first_off = (k, d, response, kappa[k])

    spawns = {k: [e for e in rec.events if e[1] == "new"] for k, rec in (("jax", jrec), ("port", trec))}
    files = {k: sorted(f for f in os.listdir(d) if f.startswith("poses-")) for k, d in out.items()}
    print("first frame off the plain bar (frame, camera gap, the reference's response, condition):",
          first_off, "spawns", spawns, "pose files", files, "scores", scores)
    assert abs(scores["port"]["ate_rmse_m"] - scores["jax"]["ate_rmse_m"]) <= worst_bar
