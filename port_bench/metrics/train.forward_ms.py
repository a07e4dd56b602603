"""Device milliseconds a training step launched inside the program's
``train.forward`` span: the forward and the loss (``loss_fn``)."""

from port_bench import spans


def read(trace, counts, config):
    return spans.train_ms(trace, counts, "train.forward")
