"""stage_launches.<stage>: kernel records launched inside the stage's range
(innermost range first), per profiled frame."""

from harness.trace import counted


def read(rec, arg):
    n = sum(1 for r in counted(rec.records) if r.stage == arg and r.is_kernel)
    return n / rec.frames if n else None
