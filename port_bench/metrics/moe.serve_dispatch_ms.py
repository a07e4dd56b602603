"""Device milliseconds a prefill of the MoE FFN outside its expert
products: operations launched inside both the program's ``model.prefill``
and ``moe_ffn`` spans, less those inside ``moe_experts`` (routing, the
dropless sort, gather and scatter, the weighting, the shared expert), over
the window's prefills."""

from port_bench import spans


def read(trace, counts, config):
    n = len(counts.get("prefill_lens", ()))
    prefill = {id(op) for op in spans.launched_in(trace, "model.prefill")}
    ffn = [op for op in spans.launched_in(trace, "moe_ffn") if id(op) in prefill]
    if not n or not ffn:
        return None
    experts = [op for op in spans.launched_in(trace, "moe_experts") if id(op) in prefill]
    return (spans.device_ms(ffn) - spans.device_ms(experts)) / n
