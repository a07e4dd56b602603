"""The flash-attention backward kernels' share of their roofline in the
window's training steps, in %: the least time of every call (one causal
call [B, H, S, hd] a layer a step; ``arith``) over the device time of
the backward's launches (prologue, dK/dV, dQ and reduce kernels), found
by name in the trace."""

from port_bench import arith

KERNELS = r"\bbwd_(prologue|reduce|dkdv_wgmma|dkdv_own_wgmma|dq_wgmma|dkdv_f32|dq_f32)\b"


def read(trace, counts, config):
    calls = counts.get("flash_backward_calls", 0)
    seconds = trace.device_s(KERNELS)
    if not calls or not seconds:
        return None
    bound = calls * arith.flash_backward_bound_s(
        counts["batch"], config["num_heads"], config["num_kv_heads"],
        counts["seq_len"], config["head_dim"])
    return 100.0 * bound / seconds
