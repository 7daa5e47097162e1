"""host_enqueue_ms: host-clock ms per `process_frame` call, the mean over
the traced window's frames outside the profile (the profiler's own cost
would inflate the profiled ones).  Close to frame_ms where the host sets
the pace."""


def read(rec, arg=None):
    if not rec.host_enqueue_ms:
        return None
    return sum(rec.host_enqueue_ms) / len(rec.host_enqueue_ms)
