"""The import check compares top-level module names whole."""

import os
import subprocess
import sys

import cfbench_paths
import pytest

from harness.imports import forbidden_loaded


@pytest.mark.parametrize("modules,found", [
    (["cofusion_tpu_torch", "cofusion_tpu_torch.engine", "torch"], []),
    (["cofusion_tpu"], ["cofusion_tpu"]),
    (["cofusion_tpu.ops.fusion"], ["cofusion_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax"], ["flax", "jaxlib"]),
    (["jaxtyping", "cofusion_tpu_tools", "flaxen"], []),
])
def test_top_level_names_compared_whole(modules, found):
    assert forbidden_loaded(modules) == found


def test_harness_port_and_reference_load_no_jax():
    code = (
        "import sys; sys.argv=['run.py']; import run, control; "
        "from harness import cell, system; import importlib; "
        "[importlib.import_module(m) for m in ('cofusion_tpu_torch.engine', 'truth')]; "
        "from harness.imports import forbidden_loaded; print(forbidden_loaded())"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(cfbench_paths.BENCH, "reference"), cfbench_paths.BENCH, cfbench_paths.ROOT]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         cwd=cfbench_paths.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(cfbench_paths.BENCH, "reference")
    for dirpath, _, files in os.walk(ref):
        for fn in files:
            if fn.endswith(".py"):
                text = open(os.path.join(dirpath, fn)).read()
                assert "cofusion_tpu" not in text.replace("cofusion_tpu/", ""), fn
