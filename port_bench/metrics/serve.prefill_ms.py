"""Device milliseconds a prefill: the device time of the operations
launched inside the benchmark's ``bench.prefill`` span (around the
program's ``lm.prefill``), over the prefills in the window."""


def read(trace, counts, config):
    n = len(counts.get("prefill_lens", ()))
    seconds = trace.device_s_in("bench.prefill")
    if not n or not seconds:
        return None
    return seconds / n * 1e3
