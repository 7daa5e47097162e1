"""On the card only: the program's spans leave the device's trace as the
benchmark reads it.  Two engines of `static.orbit` on one seed, each with
one profiled frame after its warm-up inside the benchmark's stage ranges,
the first with the Stopwatch's switch off and the second with it on.  The
same device records, launches and stage launches, and no device record of
a `step.*` range (a range projected onto the device's timeline would count
as a launch and as busy time).  Whether there is a card is decided in the
fixture, so every machine collects the same tests.

    python3 -m pytest -q cfbench/tests/test_cfbench_spans_card.py   # on the H100
"""

import cfbench_paths  # noqa: F401
import pytest

import trace_spans
from harness import cell as cells


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiled frames' device records exist only there")
    return "cuda"


def test_spans_add_no_device_record(card):
    cell = cells.resolve("static.orbit")
    off, on = (trace_spans.run_window(cell, 2**31 + 11, 0.0, spans_on, card, profile_frames=1)
               for spans_on in (False, True))
    assert off["correct"] is True and on["correct"] is True
    assert not [r for r in off["ranges"] if r[0].startswith("step.")]
    assert {"Run", "step.preprocess", "step.tracking", "step.fuse_clean", "step.predict"} \
        <= {r[0] for r in on["ranges"]}
    assert not [r for r in on["records"] if r.name.startswith(("step.", "Run"))]
    assert len(on["records"]) == len(off["records"])
    launches = [{k: v for k, v in trace_spans.stage_metrics(cell, w).items() if "launches" in k}
                for w in (off, on)]
    assert launches[0] == launches[1] and launches[0]["launches_per_frame"] > 0
