"""stage_ms.<stage>: device ms per profiled frame of the records (kernels,
copies and sets) launched inside the stage's range, innermost range first;
stage_ms.other: of those launched outside every range.  The stages and
`other` add up to the profiled frames' device time."""

from harness.trace import counted


def read(rec, arg):
    recs = [r for r in counted(rec.records) if r.stage == arg]
    if not recs:
        return None
    return sum(r.end_us - r.start_us for r in recs) / 1e3 / rec.frames
