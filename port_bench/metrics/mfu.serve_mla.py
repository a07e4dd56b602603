"""Model FLOPs of the window's prefills and decoded tokens over the
window's seconds at the card's bf16 peak, in %, for latent attention
(``arith_mla``: un-absorbed prefill, absorbed decode)."""

from port_bench import arith_mla


def read(trace, counts, config):
    if not config.get("kv_lora_rank"):
        return None
    flops = sum(arith_mla.prefill_flops(config, n) for n in counts.get("prefill_lens", ()))
    flops += sum(arith_mla.decode_flops(config, n, ctx) for n, ctx in counts.get("decodes", ()))
    if not flops:
        return None
    return 100.0 * flops / (counts["window_s"] * arith_mla.PEAK_BF16_FLOPS)
