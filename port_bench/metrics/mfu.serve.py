"""Model FLOPs of the window's prefills and decoded tokens over the
window's seconds at the card's bf16 peak, in %."""

from port_bench import arith


def read(trace, counts, config):
    decodes = counts.get("decodes", ())
    flops = sum(arith.prefill_flops(config, n) for n in counts.get("prefill_lens", ()))
    flops += sum(arith.decode_flops(config, n, ctx) for n, ctx in decodes)
    if not flops:
        return None
    return 100.0 * flops / (counts["window_s"] * arith.PEAK_BF16_FLOPS)
