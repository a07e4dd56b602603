"""Share of the traced window in which no operation ran on the device,
from the profiler's device timeline, in %."""


def read(trace, counts, config):
    if trace.window_s <= 0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
