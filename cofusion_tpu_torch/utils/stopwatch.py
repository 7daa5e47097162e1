"""Named-section wall-clock timer, the reference's Stopwatch
(Core/Utils/Stopwatch.h:64-170) without its UDP telemetry, and the frame
step's span recorder.  Sections around an asynchronous call measure the
time to enqueue it, not device time.

Always on: each section adds its host ms to a per-name total, count and
last value (`timings()` feeds the CLI's '-fs' frame skip, `report()` its
closing table, with the host counters the caller hands it).  With
`spans_on` set, each section also opens a profiler range of its own name
(a `torch.profiler` trace then holds it on the clock of its device
records) and appends a `Span` to a list bounded at `MAX_SPANS`, read after
the run with `spans()`.  Turn the switch between frames: a section that
opened with it off records no span.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import NamedTuple

import torch

MAX_SPANS = 1 << 20


class Span(NamedTuple):
    name: str
    parent: str      # the section open around it, "" at the top
    tick: int        # the frame's tick: every span of one frame shares it
    start_ns: int    # time.perf_counter_ns
    end_ns: int


class Stopwatch:
    def __init__(self):
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._last: dict[str, float] = {}
        self.spans_on = False
        self.tick = 0
        self.dropped = 0
        self._spans: list[Span] = []
        self._open: list[str] = []

    @contextlib.contextmanager
    def section(self, name: str):
        if not self.spans_on:
            start = time.perf_counter()
            try:
                yield
            finally:
                self._add(name, (time.perf_counter() - start) * 1e3)
            return
        # a function-scope record, not a user annotation: the profiler
        # projects no range of it onto the device's timeline
        parent = self._open[-1] if self._open else ""
        self._open.append(name)
        rec = torch._C._profiler._RecordFunctionFast(name)
        rec.__enter__()
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            rec.__exit__(None, None, None)
            self._open.pop()
            self._add(name, (end - start) / 1e6)
            if len(self._spans) < MAX_SPANS:
                self._spans.append(Span(name, parent, self.tick, start, end))
            else:
                self.dropped += 1

    def _add(self, name: str, ms: float) -> None:
        self._last[name] = ms
        self._totals[name] += ms
        self._counts[name] += 1

    def timings(self) -> dict[str, float]:
        """Most recent ms per section (what the '-fs' frame-skip policy
        reads)."""
        return dict(self._last)

    def totals(self) -> dict[str, tuple[float, int]]:
        """(total ms, calls) per section since construction."""
        return {k: (self._totals[k], self._counts[k]) for k in self._totals}

    def spans(self) -> list[Span]:
        """The spans recorded while `spans_on`, in the order they closed."""
        return list(self._spans)

    def report(self, counters: dict[str, dict[str, int]] | None = None) -> str:
        """The closing table, and below it each group of `counters`
        ({group: {name: count}}) on a line of its own."""
        lines = ["section                          mean ms     last ms   calls"]
        for k in sorted(self._totals):
            lines.append(
                f"{k:<30} {self._totals[k] / self._counts[k]:>10.2f} "
                f"{self._last[k]:>10.2f} {self._counts[k]:>7d}"
            )
        for group, counts in (counters or {}).items():
            lines.append(f"{group}: " + " ".join(f"{k}={v}" for k, v in counts.items()))
        return "\n".join(lines)


class _NoSections:
    """The step's default: sections that time and record nothing."""

    @staticmethod
    def section(name: str):
        return contextlib.nullcontext()


NO_SECTIONS = _NoSections()
