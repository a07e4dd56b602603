"""Device idle milliseconds a serving step while no ``serve.step`` span is
open: the engine's caller between steps (the closed-loop clients).
``serve.idle_*`` times the window's ``serve.step`` spans add up to its
idle time."""

from port_bench import spans


def read(trace, counts, config):
    split = spans.serve_idle_ms(trace)
    return None if split is None else split["caller"]
