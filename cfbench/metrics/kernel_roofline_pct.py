"""kernel_roofline_pct.<kernel>: the kernel's roofline bound over its
profiled device time, in percent, summed over its launches in the profiled
frames.  `splat_window`: the bound of each launch's own inputs, counted by
the harness's meter (harness/roofline.py, `splat_bound_ms`); `bilateral`:
the bound of each profiled frame's depth image.  Nothing to read (no launch
of the kernel, or no counts for it) returns None."""

from harness import roofline
from harness.trace import counted


def read(rec, arg):
    launches = [r for r in counted(rec.records) if r.is_kernel and arg in r.name]
    device_ms = sum(r.end_us - r.start_us for r in launches) / 1e3
    if not launches or device_ms <= 0:
        return None
    if arg == "splat_window":
        bounds = [roofline.splat_bound_ms(*row)[0] for row in rec.splat_bounds]
    elif arg == "bilateral":
        bounds = [roofline.bilateral_bound_ms(d, rec.max_depth)[0] for d in rec.bilateral_inputs]
    else:
        return None
    if not bounds:
        return None
    # the same launches on both sides where they pair up, else mean against mean
    if len(bounds) == len(launches):
        return 100.0 * sum(bounds) / device_ms
    return 100.0 * (sum(bounds) / len(bounds)) / (device_ms / len(launches))
