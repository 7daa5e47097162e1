"""On the card only: one short run of the static cell through the
measurement path.  Whether there is a card is decided in the fixture, so
every machine collects the same tests.

    python3 -m pytest -q cfbench/tests/test_cfbench_card.py   # on the H100
"""

import cfbench_paths  # noqa: F401
import pytest

import run
from harness import cell as cells


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the measurement path refuses to run without one")
    return "cuda"


def test_short_run_reports_every_end_to_end_metric(card):
    cell = cells.resolve("static.orbit")
    res = run.run_cell(cell, 2**31 + 5, 5.0, False, card)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in res["metrics"].values())
