"""Nearest-rank 90th percentile of the time to first token, over every
request submitted in the window: from its submission to the end of the
engine step that produced its first token (the first moment a caller of
the engine sees it), on the host's clock."""

import math


def read(trace, counts, config):
    ttft = sorted(counts.get("ttft_ms") or [])
    if not ttft:
        return None
    return ttft[max(math.ceil(0.9 * len(ttft)), 1) - 1]
