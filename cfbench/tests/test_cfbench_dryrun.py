"""The frame loop of every cell, dry at 160x128 on the CPU: the harness
drives the program and compares what it produced with the scene's exact
poses and surfaces, and reports no device metric.  With the timed path broken underneath,
`correct` comes out false; so does the control put in the program's place.
The measurement path itself refuses to run without a card."""

import json

import cfbench_paths  # noqa: F401
import numpy as np
import pytest

import control
import run
from harness import cell as cells

CELLS = [w["name"] for w in cells.load_json(cells.manifest_path())["workloads"]]
SEED = 2**31 + 77


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_dry_run_reports_no_device_metric(name, trace):
    res = run.run_cell(cells.resolve(name), SEED, 0.5, bool(trace), "cpu", run.DRY_RUN)
    assert res["metrics"] == {} and res["device"]["platform"] == "cpu"
    assert res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(cells.resolve(name).limits) <= set(res["checks"])
    assert all(np.isfinite(v["value"]) for v in res["checks"].values())


def test_main_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


@pytest.mark.parametrize("side", ["stuck", "half", "nudge"])
def test_broken_timed_path_is_not_correct(side):
    with control.SIDES[side]():
        res = run.run_cell(cells.resolve("static.orbit"), SEED, 1.0, False, "cpu", run.DRY_RUN)
    assert res["correct"] is False
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    r = control.readings(cells.resolve(name), SEED, 1.0, "control", "cpu", overrides=run.DRY_RUN)
    assert r["correct_under_limits"] is False


def test_refuses_without_the_program(tmp_path):
    import os
    import shutil
    import subprocess
    import sys

    shutil.copy(os.path.join(cfbench_paths.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(cfbench_paths.BENCH, tmp_path / "cfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "cfbench/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
