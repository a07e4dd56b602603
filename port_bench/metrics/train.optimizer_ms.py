"""Device milliseconds a training step launched inside the program's
``train.optimizer`` span: AdamW (``adamw.apply_updates``: the clipping
norm and the update of every leaf)."""

from port_bench import spans


def read(trace, counts, config):
    return spans.train_ms(trace, counts, "train.optimizer")
