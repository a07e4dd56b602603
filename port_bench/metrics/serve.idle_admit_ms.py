"""Device idle milliseconds a serving step while the engine's ``serve.admit``
span is open: admissions (prompt upload, prefill, splice, the first
token's read).  ``serve.idle_*`` times the window's ``serve.step`` spans
add up to its idle time."""

from port_bench import spans


def read(trace, counts, config):
    split = spans.serve_idle_ms(trace)
    return None if split is None else split["admit"]
