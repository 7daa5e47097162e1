"""The port's dataset tools (cofusion_tpu_torch/tools/evaluate.py and
view.py) against the JAX package's (tools/evaluate.py, tools/view.py) on
one export directory written by the JAX CLI: a 6-frame small_cam orbit
with a moving object, GT masks ('-es -ep -em', 4 model slots).

Bars: the JSON line each evaluator prints is the same string, for every
flag combination; `view --no-png` writes the same view.html bytes.  The
export directory is made once per worker (module fixture: the tests read
it and never change it, so the order xdist runs them in does not matter).
"""

import contextlib
import importlib.util
import io
import os
import sys

import cv2
import numpy as np
import pytest

from cofusion_tpu import cli as jcli
from cofusion_tpu.io.synthetic import make_sequence
from cofusion_tpu_torch.tools import evaluate as tevaluate
from cofusion_tpu_torch.tools import view as tview

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", os.path.join(_REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(main, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory, small_cam):
    """(export dir, GT poses .npy, GT mask dir) of a JAX CLI run."""
    root = tmp_path_factory.mktemp("jax_export")
    frames, gt, _ = make_sequence(small_cam, 6, kind="orbit", moving_object=True)
    data, masks = root / "seq", root / "gt_masks"
    data.mkdir()
    masks.mkdir()
    for i, f in enumerate(frames):
        cv2.imwrite(str(data / f"Color{i:04d}.png"), f["rgb"][..., ::-1])
        cv2.imwrite(str(data / f"Depth{i:04d}.png"), np.round(f["depth"] * 1000).astype(np.uint16))
        mask = np.where(f["mask"] == 1, 7, 0).astype(np.uint8)
        cv2.imwrite(str(data / f"Mask{i:04d}.png"), mask)
        cv2.imwrite(str(masks / f"Mask{i:04d}.png"), mask)
    c = small_cam
    (data / "calibration.txt").write_text(f"{c.fx} {c.fy} {c.cx} {c.cy} {c.width} {c.height}\n")
    out = root / "out"
    rc = jcli.run(["-dir", str(data), "-maskdir", str(data), "-pngScale", "0.001", "-run", "-q",
                   "-d", "4.5", "-confG", "1.5", "-confO", "0.01", "-offset", "0", "-ns", str(1 << 16),
                   "-es", "-ep", "-em", "-exportdir", str(out)])
    assert rc == 0
    gt_npy = root / "gt.npy"
    np.save(gt_npy, np.stack(gt))
    assert (out / "poses-1.txt").exists() and (out / "cloud-0.ply").exists()
    return str(out), str(gt_npy), str(masks)


@pytest.mark.parametrize("case", ["trajectory", "masks", "both", "mask_offset", "no_align"])
def test_evaluate_prints_the_jax_tools_json(jax_export, case):
    out, gt, masks = jax_export
    traj = ["--gt-poses", gt]
    seg = ["--gt-masks", masks, "--min-px", "20"]
    argv = ["--export", out] + {
        "trajectory": traj,
        "masks": seg,
        "both": traj + seg,
        "mask_offset": seg + ["--mask-offset", "1"],
        "no_align": traj + seg + ["--no-align"],
    }[case]
    rc_ref, ref = _run(_jax_tool("evaluate").main, argv)
    rc, got = _run(tevaluate.main, argv)
    assert rc == rc_ref == 0
    assert got.strip().splitlines()[-1] == ref.strip().splitlines()[-1]
    if case != "trajectory":
        assert '"mean_iou"' in got


def test_view_writes_the_jax_tools_html(jax_export, tmp_path):
    out, _, _ = jax_export
    for name, main in (("port", tview.main), ("jax", _jax_tool("view").main)):
        rc, _ = _run(main, ["--export", out, "--out", str(tmp_path / name), "--no-png"])
        assert rc == 0
    html = (tmp_path / "port" / "view.html").read_bytes()
    assert html == (tmp_path / "jax" / "view.html").read_bytes()
    assert b"trajectories" in html and not (tmp_path / "port" / "view.png").exists()


def test_view_snapshot_without_matplotlib_fails_and_says_why(jax_export, tmp_path, monkeypatch, capsys):
    out, _, _ = jax_export
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert tview.main(["--export", out, "--out", str(tmp_path)]) != 0
    assert "needs matplotlib" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
