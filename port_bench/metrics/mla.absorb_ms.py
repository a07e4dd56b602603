"""Device milliseconds a decode tick in the program's ``mla.absorb`` spans:
the absorbed products of latent attention (each head's no-RoPE query into
the latent space, the weighted latents through the value up-projection),
every layer, over the ``model.decode`` spans."""

from port_bench import spans


def read(trace, counts, config):
    if not spans.clipped(trace, "mla.absorb"):
        return None
    return spans.per_decode(trace, spans.device_ms(spans.launched_in(trace, "mla.absorb")))
