"""Device milliseconds a decode tick of attention over the cache: the
device time of the operations launched inside the program's
``attention.decode`` spans (the KV expansion and ``decode_attention``,
every layer), over the ``model.decode`` spans."""

from port_bench import spans


def read(trace, counts, config):
    ops = spans.launched_in(trace, "attention.decode")
    return spans.per_decode(trace, spans.device_ms(ops))
