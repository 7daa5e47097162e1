"""device_busy_ms: ms per profiled frame in which some kernel, copy or set
ran on the device (the union of their intervals)."""

from harness.trace import counted, union_us


def read(rec, arg=None):
    busy = union_us(counted(rec.records))
    return busy / 1e3 / rec.frames if busy > 0 else None
