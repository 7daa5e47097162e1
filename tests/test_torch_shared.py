"""tests/torch_shared.py: a reference run that one pytest-xdist worker
computed and pickled into the session's shared directory is bit for bit
the same run computed in the test's own process (every worker pins
`torch.set_num_threads(1)`), so a test that loads it checks what it would
have checked on its own run.  The run: tests/test_torch_parallel.py's
unsharded teleport reference (per-frame stats, step outputs, gathered
states, events, conditions, read-outs), which eight tests share.  And the
file lock under contention: of sixteen processes asking for one
name at once, exactly one computes.
"""

import os
import subprocess
import sys

import numpy as np
import torch

import test_torch_parallel as tp
from torch_shared import shared  # noqa: F401  (a fixture)


def _assert_identical(got, want, path="reference"):
    """Exact equality: arrays and tensors by dtype, shape and every bit;
    containers element by element; anything else by ==."""
    if isinstance(want, (np.ndarray, torch.Tensor, np.generic)):
        assert type(got) is type(want), (path, type(got), type(want))
        tp._assert_same(got, want, path)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for key in want:
            _assert_identical(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_identical(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def test_shared_reference_is_bit_identical(shared):
    tp._reference(shared)  # computed here or on another worker
    loaded = shared.load("parallel_crf_reference")  # the file as written
    fresh = tp._compute_reference()  # this process, from scratch
    _assert_identical(loaded, fresh)
    assert len(fresh["snaps"]) == tp.N_STEPS + 1


_CHILD = """
import os, sys, time
sys.path.insert(0, {tests!r})
import numpy as np
from torch_shared import Shared

def compute():
    with open({log!r}, "a") as f:
        f.write(f"{{os.getpid()}}\\n")
    time.sleep(2.0)
    return np.arange(4) * os.getpid()

print(Shared({root!r}).get("stress", compute).tolist())
"""


def test_shared_computes_once_across_processes(tmp_path):
    """Sixteen processes (more than the tier-1 run's workers) ask for one
    name at once: exactly one computes, and every one gets that value."""
    tests = os.path.dirname(os.path.abspath(__file__))
    code = _CHILD.format(tests=tests, log=str(tmp_path / "log"), root=str(tmp_path))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True)
             for _ in range(16)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert all(p.returncode == 0 for p in procs)
    makers = (tmp_path / "log").read_text().split()
    assert len(makers) == 1, makers
    assert len(set(outs)) == 1 and outs[0].strip() == str([i * int(makers[0]) for i in range(4)])
