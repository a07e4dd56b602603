"""The flash-attention forward kernel's share of its roofline in the
window's prefills, in %: the least time of every call (``arith``: bytes
at the HBM bandwidth or products at the bf16 peak, the larger) over the
device time of the kernel's launches, found by name in the trace.  Each
prefill of P tokens is one causal call [1, H, P, hd] a layer."""

from port_bench import arith

KERNEL = r"\bflash_kernel_(wgmma|f32)\b"


def read(trace, counts, config):
    lens, layers = counts.get("prefill_lens", ()), config["num_layers"]
    seconds = trace.device_s(KERNEL)
    if not lens or not seconds or counts.get("flash_forward_calls") != layers * len(lens):
        return None
    bound = layers * sum(arith.flash_forward_bound_s(
        1, config["num_heads"], config["num_kv_heads"], n, config["head_dim"])
        for n in lens)
    return 100.0 * bound / seconds
