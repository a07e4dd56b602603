"""Device operations a decode tick: those launched inside the program's
``model.decode`` spans, over those spans."""

from port_bench import spans


def read(trace, counts, config):
    return spans.per_decode(trace, len(spans.launched_in(trace, "model.decode")))
