"""The port stands without JAX: no module of cofusion_tpu_torch imports it,
the package, its engine, its CLI, its readers and PNG codec, its
ground-truth poses, its checkpoints, its dataset tools, its device-mesh
sharding and chip_smoke.py
import in a process where `import jax` fails and import nothing of the JAX
package either, nor OpenCV or matplotlib (PNG datasets are read, and runs
scored, without them), and on CPU tensors the kernel dispatchers never
reach the CUDA kernel loader."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cofusion_tpu_torch.config import CameraConfig, CoFusionConfig
from cofusion_tpu_torch.ops import _build, cuda_splat, cuda_stencil
from cofusion_tpu_torch.ops import preprocess as tpp
from cofusion_tpu_torch.ops import rasterize as trz

torch.set_num_threads(1)
_REPO = pathlib.Path(__file__).resolve().parents[1]
_PKG = _REPO / "cofusion_tpu_torch"


def test_no_source_file_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.MULTILINE)
    offenders = [
        str(p.relative_to(_REPO))
        for p in sorted(_PKG.rglob("*.py")) + [_REPO / "chip_smoke.py"]
        if pattern.search(p.read_text())
    ]
    assert offenders == []


@pytest.mark.parametrize(
    "module",
    ["cofusion_tpu_torch", "cofusion_tpu_torch.engine", "cofusion_tpu_torch.cli",
     "cofusion_tpu_torch.convert", "cofusion_tpu_torch.utils.export",
     "cofusion_tpu_torch.io.synthetic", "cofusion_tpu_torch.io.readers",
     "cofusion_tpu_torch.ops.segmentation", "cofusion_tpu_torch.ops.ferns",
     "cofusion_tpu_torch.ops.deformation", "cofusion_tpu_torch.ops.local_loop",
     "cofusion_tpu_torch.io.ground_truth", "cofusion_tpu_torch.utils.checkpoint",
     "cofusion_tpu_torch.io.png", "cofusion_tpu_torch.tools", "cofusion_tpu_torch.tools.evaluate",
     "cofusion_tpu_torch.tools.view", "cofusion_tpu_torch.parallel", "chip_smoke"],
)
def test_imports_with_jax_blocked(module):
    banned = ("jax", "cofusion_tpu", "cv2", "matplotlib")
    code = (
        "import sys; sys.modules['jax'] = None\n"
        f"import importlib; importlib.import_module({module!r})\n"
        f"bad = [m for m, v in sys.modules.items() if v is not None and m.split('.')[0] in {banned!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(_REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=str(_REPO), env=env,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.fixture
def loader_forbidden(monkeypatch):
    def refuse():
        raise AssertionError("the CUDA kernel loader was reached on a CPU tensor")

    monkeypatch.setattr(_build, "load", refuse)


def test_bilateral_filter_on_cpu_never_loads_kernels(loader_forbidden):
    depth = torch.from_numpy(np.random.default_rng(0).uniform(0.5, 3.0, (24, 32)).astype(np.float32))
    out = tpp.bilateral_filter(depth, 3.0)
    assert out.shape == depth.shape and out.device.type == "cpu"
    assert cuda_stencil.bilateral_filter_cuda.launches == 0


def test_splat_from_imap_on_cpu_never_loads_kernels(loader_forbidden):
    cam = CameraConfig(width=32, height=24, fx=30.0, fy=30.0, cx=16.0, cy=12.0)
    cfg = CoFusionConfig(camera=cam, max_models=1)
    rng = np.random.default_rng(1)
    H, W = cam.height, cam.width
    z = rng.uniform(1.0, 2.0, (H, W)).astype(np.float32)
    vert_conf = np.stack([np.zeros_like(z), np.zeros_like(z), z, np.ones_like(z)], -1)
    normal_rad = np.stack([np.zeros_like(z), np.zeros_like(z), -np.ones_like(z), np.full_like(z, 0.05)], -1)
    imap = trz.IndexMap(
        index=torch.zeros((H, W), dtype=torch.int32),
        vert_conf=torch.from_numpy(vert_conf),
        normal_rad=torch.from_numpy(normal_rad),
        color_time=torch.zeros((H, W, 4)),
        last_time=torch.zeros((H, W)),
        valid=torch.ones((H, W), dtype=torch.bool),
    )
    out = trz.splat_from_imap(imap, cam, cfg)
    assert out.valid.any()
    assert cuda_splat.splat_window_cuda.launches == 0
