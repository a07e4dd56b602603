"""Device idle milliseconds a serving step while ``serve.step`` is open and
``serve.admit`` is not: the decode tick and the engine's bookkeeping.
``serve.idle_*`` times the window's ``serve.step`` spans add up to its
idle time."""

from port_bench import spans


def read(trace, counts, config):
    split = spans.serve_idle_ms(trace)
    return None if split is None else split["tick"]
