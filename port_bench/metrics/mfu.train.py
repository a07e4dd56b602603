"""Model FLOPs of the window's training steps (6 N tokens and the causal
attention) over the window's seconds at the card's bf16 peak, in %."""

from port_bench import arith


def read(trace, counts, config):
    if not counts.get("steps"):
        return None
    batch, seq = counts["batch"], counts["seq_len"]
    flops = counts["steps"] * arith.train_step_flops(config, batch, seq)
    return 100.0 * flops / (counts["window_s"] * arith.PEAK_BF16_FLOPS)
