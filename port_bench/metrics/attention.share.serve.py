"""Share of the window's device time launched inside the program's
``attention`` spans (prefill's flash kernel, decode's attention over the
cache, the projections around them), in %."""


def read(trace, counts, config):
    inside, total = trace.device_s_in("attention"), trace.device_s()
    if not inside or not total:
        return None
    return 100.0 * inside / total
