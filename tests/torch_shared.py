"""Reference runs computed once per test session and shared by every
pytest-xdist worker.

The port's parity tests hold it to reference runs (the JAX engine's, the
JAX CLI's, the unsharded port's) that take tens of seconds each, and
several tests, on several workers, need the same one.  `Shared.get(name,
compute)` returns `compute()`: under a file lock in the session's shared
temporary directory, the first worker that asks computes it and pickles it
there, and every other worker loads the file (pickle keeps numpy arrays
and tensors bit for bit).  Nothing depends on which worker asks first or
on the order of the tests: whoever finds no file computes.  A `Shared`
keeps what it computed or loaded, so it reads the disk once per name.

`compute` must not ask for another name that could ask for this one (two
workers would each hold one lock and wait for the other's), and must
return what pickle can write: numpy arrays, tensors, NamedTuples, dicts,
lists.

Under xdist the directory is the parent of the worker's base temporary
directory (`pytest-<n>/`, one per session, shared by the workers; pytest
keeps the last three sessions' and removes older ones); without xdist it
is the session's own base temporary directory.

`share_jax_steps` is the in-process counterpart for JAX engines of one
configuration: one traced and compiled step per worker.
"""

import os
import pathlib
import pickle
import shutil

import pytest
from filelock import FileLock


_JAX_STEPS = {}  # (cam, cfg, tracking, segmentation) -> a JAX engine's _step_fns


class Shared:
    def __init__(self, root):
        self.root = root
        self._held = {}  # name -> value, in this process

    def path(self, name):
        return os.path.join(self.root, f"shared_{name}.pkl")

    def get(self, name, compute):
        """compute() once per session; loaded from the shared file on every
        worker but the one that computed it."""
        if name not in self._held:
            path = self.path(name)
            with FileLock(path + ".lock"):
                if os.path.exists(path):
                    value = self.load(name)
                else:
                    value = compute()
                    tmp = f"{path}.{os.getpid()}"
                    with open(tmp, "wb") as f:
                        pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
                    os.replace(tmp, path)
            self._held[name] = value
        return self._held[name]

    def fresh_dir(self, name):
        """An empty directory `name` in the shared directory, for a compute
        that writes files (call it inside `compute`)."""
        path = pathlib.Path(self.root) / name
        shutil.rmtree(path, ignore_errors=True)
        path.mkdir()
        return path

    def load(self, name):
        """The shared file of `name` as written (whoever computed it)."""
        with open(self.path(name), "rb") as f:
            return pickle.load(f)


def share_jax_steps(jeng):
    """Give a JAX engine (`cofusion_tpu.engine.CoFusion`) the jitted steps
    of this worker's earlier engines with the same camera, configuration,
    tracking and segmentation parameters: what `_get_step` binds (its own
    key adds the step's flags; fusion parameters and '-keep' are traced
    arguments).  Such engines then trace and compile their step once per
    worker.  Call it before the engine's first step."""
    key = (jeng.cam, jeng.cfg, jeng.tracking, jeng.segmentation)
    jeng._step_fns = _JAX_STEPS.setdefault(key, {})
    return jeng


@pytest.fixture(scope="session")
def shared(tmp_path_factory):
    """The session's `Shared` (import this fixture into a test module)."""
    base = tmp_path_factory.getbasetemp()
    return Shared(str(base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base))
