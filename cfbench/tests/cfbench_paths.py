"""Puts the benchmark's folders on sys.path for its tests, as run.py does:
the reference package, the harness and the repository root."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(BENCH, "reference"), BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
