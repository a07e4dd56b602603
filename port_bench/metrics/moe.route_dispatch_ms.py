"""Device milliseconds a training step of the MoE FFN outside its expert
products: the program's ``moe_ffn`` spans less its ``moe_experts`` spans
(routing, the one-hot dispatch, scatter and gather) in the forward and in
the recompute.  The backward's kernels are launched after the recompute's
span has closed, so none of them is counted here."""


def read(trace, counts, config):
    ffn, experts = trace.device_s_in("moe_ffn"), trace.device_s_in("moe_experts")
    if not ffn or experts is None or not counts.get("steps"):
        return None
    return (ffn - experts) / counts["steps"] * 1e3
