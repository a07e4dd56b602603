"""The flash forward kernel's share of its roofline in the window's
latent-attention prefills, in %: the least time of each prefill's calls,
one a layer at the true MLA widths (``arith_mla``: 16 heads, queries and
keys 192 wide, values 128, bf16), over the device time of the flash
kernel's launches, found by name in the trace.  Padding the widths for the
kernel shows as a lower share, whatever implements the call."""

from port_bench import arith_mla

KERNEL = r"\bflash_kernel_(wgmma|f32)\b"


def read(trace, counts, config):
    lens, layers = counts.get("prefill_lens", ()), config["num_layers"]
    seconds = trace.device_s(KERNEL)
    if (not config.get("kv_lora_rank") or not lens or not seconds
            or counts.get("flash_forward_calls") != layers * len(lens)):
        return None
    bound = layers * sum(arith_mla.flash_forward_bound_s(config, n) for n in lens)
    return 100.0 * bound / seconds
