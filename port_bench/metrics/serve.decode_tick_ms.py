"""Host milliseconds a decode tick, from the engine's own clock
(``ServingEngine.timing`` "host/run": from the tick's inputs to its tokens
on the host, so the device's work is in it)."""


def read(trace, counts, config):
    if not counts.get("ticks"):
        return None
    return counts["tick_host_ms"] / counts["ticks"]
