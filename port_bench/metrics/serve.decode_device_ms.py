"""Device milliseconds a decode tick: the device time of the operations
launched inside the program's ``model.decode`` spans, over those spans."""

from port_bench import spans


def read(trace, counts, config):
    ops = spans.launched_in(trace, "model.decode")
    return spans.per_decode(trace, spans.device_ms(ops))
