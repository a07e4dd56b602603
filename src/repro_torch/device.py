"""Where the port's entry points run.

Entry points take ``device=None`` and then run on the card.  The CPU is
used only when a caller asks for it by name (the tests do), so a machine
without a card can never silently stand in for one.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device with no card present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
