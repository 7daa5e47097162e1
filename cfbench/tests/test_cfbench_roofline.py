"""The roofline arithmetic against hand counts."""

import cfbench_paths  # noqa: F401
import numpy as np
import pytest

from harness import roofline as rf


def test_bound_takes_the_slower_side():
    ms, by = rf.bound_ms(3.35e12, {"fp32": (67e12 / 2, rf.FP32_OPS_PER_S)})
    assert ms == pytest.approx(1000.0) and by == "bytes"
    ms, by = rf.bound_ms(0, {"fp32": (67e12, rf.FP32_OPS_PER_S), "sfu": (1, rf.SFU_OPS_PER_S)})
    assert ms == pytest.approx(1000.0) and by == "operations"


def test_splat_bound_by_hand():
    # 10 px, 4 valid, 30 tests: bytes 4*28 + 10*9 = 202; ops 30*26 + 4*6 + 10*10 = 904
    ms, by = rf.splat_bound_ms(10, 4, 30)
    assert ms == pytest.approx(max(202 / 3.35e12, 904 / 67e12) * 1e3)
    assert by == "bytes"


def test_bilateral_exp_count_by_brute_force():
    rng = np.random.default_rng(1)
    d = rng.uniform(0.0, 5.0, (9, 11)).astype(np.float32)
    d[2, 3] = np.inf
    d[5, 5] = np.nan
    want = 0
    for y in range(9):
        for x in range(11):
            if 0.3 <= d[y, x] <= 4.5:
                win = d[max(0, y - 6):y + 7, max(0, x - 6):x + 7]
                want += int(np.isfinite(win).sum())
    assert rf.bilateral_exp_count(d, 4.5) == want
    ms, by = rf.bilateral_bound_ms(d, 4.5)
    assert ms == pytest.approx(max(d.size * 8 / 3.35e12, want / rf.SFU_OPS_PER_S,
                                   want * 10 / 67e12) * 1e3)
    assert by == "operations"
