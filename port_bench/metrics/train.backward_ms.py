"""Device milliseconds a training step launched inside the program's
``train.backward`` span: ``torch.autograd.grad``, the recompute included
(autograd launches from its own thread while the step waits in the
span)."""

from port_bench import spans


def read(trace, counts, config):
    return spans.train_ms(trace, counts, "train.backward")
