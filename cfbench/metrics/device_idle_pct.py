"""device_idle_pct: the share of the profiled span (host clock, from the
synchronise before its first frame to the one after its last) in which
nothing ran on the device, in percent."""

from harness.trace import counted, union_us


def read(rec, arg=None):
    busy = union_us(counted(rec.records))
    if busy <= 0 or rec.span_us <= 0:
        return None
    return 100.0 * (1.0 - busy / rec.span_us)
