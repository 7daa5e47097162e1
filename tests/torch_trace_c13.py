"""The trace behind ROADMAP C13: where the port's CLI run and the JAX CLI's
part on tests/test_e2e_cli.py's 60-frame sequence, and whose doing that
is.  Not collected by pytest (~5 minutes, the JAX compile included):

    JAX_PLATFORMS=cpu python tests/torch_trace_c13.py steps [--frames 60]
    JAX_PLATFORMS=cpu python tests/torch_trace_c13.py depth-scale

steps:
The sequence of tests/test_e2e_cli.py (small_cam orbit with a moving
object, written by its `_write_dataset`) is read by the port's reader and
played through the engines both CLIs build from that test's flags (plus
`-ns 65536`, as tests/test_torch_e2e_cli.py runs them).  For every frame k:
the runs' camera gap, counts and active flags; the port's step from the
JAX run's state before k against the JAX run (pose, counts); the JAX step
from the port's state against the port's run; and the reference's own
response, that JAX step's camera against the JAX run's.  The lifecycle
events of both runs come first.

depth-scale (ROADMAP C1, ~10 minutes): both CLIs on the same 60 frames
with that test's flags as they are (the CLI's default capacity), then
again with `-pngScale 0.001`: the test writes depth in millimetres and
passes no scale, so the reader's default of 0.0006 shrinks every depth to
0.6 of the scene's.  Each export directory scored by tools/evaluate.py as
that test scores it.
"""

import argparse
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_multimodel as mm  # noqa: E402
from cofusion_tpu import cli as jcli  # noqa: E402
from cofusion_tpu.config import CameraConfig  # noqa: E402
from cofusion_tpu.io.synthetic import make_sequence  # noqa: E402
from cofusion_tpu_torch import cli as tcli  # noqa: E402
from cofusion_tpu_torch import convert  # noqa: E402
from cofusion_tpu_torch.engine import _step  # noqa: E402
from test_e2e_cli import _write_dataset  # noqa: E402
from test_torch_e2e_cli import FLAGS  # noqa: E402

SMALL = dict(width=160, height=128, fx=132.0, fy=132.0, cx=80.0, cy=64.0)


def depth_scale(opts):
    import test_e2e_cli

    cam = CameraConfig(**SMALL)
    flags = ["-run", "-q", "-d", "4.5", "-confG", "1.5", "-confO", "0.01", "-offset", "4", "-ep", "-es"]
    with tempfile.TemporaryDirectory() as root:
        frames, gt, _ = make_sequence(cam, 60, kind="orbit", moving_object=True)
        ds, gt_masks = _write_dataset(root, cam, frames, with_masks=True)
        gt_npy = os.path.join(root, "gt.npy")
        np.save(gt_npy, np.stack(gt))
        for scale in ([], ["-pngScale", "0.001"]):
            for name, cli, extra in (("JAX", jcli, []), ("port", tcli, ["-device", "cpu"])):
                out = os.path.join(root, f"out_{name}{len(scale)}")
                assert cli.run(["-dir", ds, *flags, *scale, *extra, "-exportdir", out]) == 0
                res = test_e2e_cli._evaluate(
                    ["--export", out, "--gt-poses", gt_npy, "--no-align", "--gt-masks", gt_masks,
                     "--min-px", str(max(60, (cam.width * cam.height) // 400))])
                print(f"{name} {' '.join(scale) or 'no -pngScale'}: {res}", flush=True)


def steps(opts):
    n = opts.frames
    cam = CameraConfig(**SMALL)
    with tempfile.TemporaryDirectory() as root:
        frames, _, _ = make_sequence(cam, n, kind="orbit", moving_object=True)
        ds, _ = _write_dataset(root, cam, frames, with_masks=True)
        _, jeng, _ = jcli.build_from_args(["-dir", ds, *FLAGS])
        reader, teng, _ = tcli.build_from_args(["-dir", ds, *FLAGS, "-device", "cpu"])
        frames = [reader.get_next() for _ in range(n)]
        reader.close()
    calls = mm._record_steps(jeng)
    jlog, jev, jst, _ = mm._play(jeng, frames, snapshot=True)
    tlog, tev, tst, _ = mm._play(teng, frames, snapshot=True)
    print("lifecycle events (frames played, kind, slot): JAX", jev, "port", tev, flush=True)
    treedef = jax.tree.structure(jeng.state)
    fparams = dict(teng._fparams, weight_multiplier=1.0, new_slot=-1, allow_new=False, gt_masks=False)
    for k in range(1, n):
        (jp, ja, jc), (tp, ta, tc) = jlog[k], tlog[k]
        f = frames[k]
        new, _ = _step(convert.state_from_numpy(jst[k]), torch.from_numpy(f["rgb"].astype(np.float32)),
                       torch.from_numpy(f["depth"]), torch.zeros(teng.cfg.camera.shape, dtype=torch.int32),
                       fparams, cam=teng.cfg.camera, cfg=teng.cfg, tparams=teng.tracking,
                       sparams=teng.segmentation, use_crf=True)
        port_from_jax = np.abs(new.models.pose.numpy() - jp).max()
        port_counts = np.array_equal(mm._counts(convert.state_to_numpy(new).models), jc)
        fn, args = calls[k - 1]
        jn, _ = fn(jax.tree.unflatten(treedef, [jnp.asarray(a) for a in jax.tree.leaves(tst[k])]), *args)
        jax_from_port = np.abs(np.asarray(jn.models.pose) - tp).max()
        jax_counts = np.array_equal(mm._counts(jn.models), tc) and np.array_equal(np.asarray(jn.models.active), ta)
        response = np.abs(np.asarray(jn.models.pose)[0] - jp[0]).max()
        print(f"frame {k}: runs camera {np.abs(tp[0] - jp[0]).max():.2e} all {np.abs(tp - jp).max():.2e} "
              f"counts {tc.tolist()} / {jc.tolist()} active {ta.astype(int).tolist()} / "
              f"{ja.astype(int).tolist()} | port from JAX's state {port_from_jax:.2e} counts equal "
              f"{port_counts} | JAX from the port's state {jax_from_port:.2e} counts and flags equal "
              f"{jax_counts} | response {response:.2e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", choices=("steps", "depth-scale"))
    ap.add_argument("--frames", type=int, default=60)
    opts = ap.parse_args(argv)
    torch.set_num_threads(1)
    {"steps": steps, "depth-scale": depth_scale}[opts.trace](opts)


if __name__ == "__main__":
    main()
