"""launches_per_frame: kernel records (memory copies and sets left out) of
the profiled frames, per frame."""

from harness.trace import counted


def read(rec, arg=None):
    n = sum(1 for r in counted(rec.records) if r.is_kernel)
    return n / rec.frames if n else None
