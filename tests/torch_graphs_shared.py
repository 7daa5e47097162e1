"""What the CUDA-graph tests share (test_torch_graphs.py and the stage
files test_torch_graphed_*.py): the card fixture, a cache that runs every
stage eagerly, and a graphed engine beside an eager twin with the
comparison of their states.  Imports no JAX: on the card these files run
without the suite's conftest."""

import pytest
import torch

from cofusion_tpu_torch.engine import CoFusion
from cofusion_tpu_torch.graphs import StepGraphs


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs capture only there")
    return torch.device("cuda")


class EagerGraphs(StepGraphs):
    """The same stages, run eagerly on every call."""

    def run(self, stage, fn, inputs, statics, **kw):
        return fn(inputs)


def pair(card, settings: dict):
    """Two engines of the same settings (`cfg` and the constructor's
    keywords): one replays its stages' graphs, the other runs them eagerly."""
    settings = dict(settings)
    cfg = settings.pop("cfg")
    graphed, eager = (CoFusion(cfg, device=card, **settings) for _ in range(2))
    eager.graphs = EagerGraphs(cfg.max_models)
    return graphed, eager


def _leaves(eng: CoFusion) -> list:
    """(name, tensor) for every tensor of the engine's state and last outputs."""
    out = []

    def walk(name, v):
        if isinstance(v, torch.Tensor):
            out.append((name, v))
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            for f, a in zip(v._fields, v):
                walk(f"{name}.{f}", a)

    walk("state", eng.state)
    walk("outputs", eng._last_outputs)
    return out


def diff(a: CoFusion, b: CoFusion) -> list:
    """The names of the state and output leaves where the engines differ."""
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    return [n for (n, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]
