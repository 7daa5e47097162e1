"""Named-section wall-clock timer, the reference's Stopwatch singleton
(Core/Utils/Stopwatch.h:64-170) without its UDP telemetry.  Sections around
an asynchronous call measure the time to enqueue it, not device time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Stopwatch:
    _instance: "Stopwatch | None" = None

    def __init__(self):
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._last: dict[str, float] = {}

    @classmethod
    def get(cls) -> "Stopwatch":
        if cls._instance is None:
            cls._instance = Stopwatch()
        return cls._instance

    @contextlib.contextmanager
    def section(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - start) * 1e3
            self._last[name] = ms
            self._totals[name] += ms
            self._counts[name] += 1

    def timings(self) -> dict[str, float]:
        """Most recent ms per section (what the '-fs' frame-skip policy
        reads)."""
        return dict(self._last)

    def report(self) -> str:
        lines = ["section                          mean ms     last ms   calls"]
        for k in sorted(self._totals):
            lines.append(
                f"{k:<30} {self._totals[k] / self._counts[k]:>10.2f} "
                f"{self._last[k]:>10.2f} {self._counts[k]:>7d}"
            )
        return "\n".join(lines)
