"""Public AdamW leaf update: the tensor's device picks the path.

A CPU tensor takes the plain PyTorch version (``adamw_update_reference``,
the loop's arithmetic); a CUDA tensor takes the CUDA kernel, or raises.
Nothing falls back from one to the other.  A DTensor leaf is updated shard
by shard: the update is elementwise, so each rank updates its local
shards of p, m and v (which share p's placements) from its shard of the
gradient laid out as p.

On the card the update goes through ``repro_torch::adamw_update``, a
``torch.library`` custom op that mutates p, m and v, whose fake impl does
nothing: a fake-tensor trace of a train step (the dry-run) passes through
it without a launch.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _shard
from repro_torch.kernels.adamw.kernel import adamw_update_cuda, host_constants
from repro_torch.kernels.adamw.ref import adamw_update_reference


def _update_impl(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 scale: torch.Tensor, b1c: torch.Tensor, b2c: torch.Tensor,
                 lr: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    adamw_update_cuda(p, g.contiguous(), m, v, scale, b1c, b2c, lr,
                      host_constants(b1, b2, eps, weight_decay))


_update = torch.library.custom_op("repro_torch::adamw_update", _update_impl,
                                  mutates_args=("p", "m", "v"))


@_update.register_fake
def _update_fake(p, g, m, v, scale, b1c, b2c, lr, b1, b2, eps, weight_decay):
    return None


def adamw_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 scale: torch.Tensor, b1c: torch.Tensor, b2c: torch.Tensor,
                 lr: torch.Tensor, b1: float, b2: float, eps: float,
                 weight_decay: float) -> None:
    """One AdamW step of one leaf, in place (``adamw_update_reference``'s
    arguments): ``p``, ``m`` and ``v`` are written, ``g`` is read."""
    if _shard.is_dtensor(p, g, m, v):
        placements = tuple(p.placements)
        for name, t in (("m", m), ("v", v)):
            if not _shard.is_dtensor(t) or tuple(t.placements) != placements:
                raise ValueError(f"{name} must be a DTensor placed as the parameter "
                                 f"({placements}), got {getattr(t, 'placements', None)}")
        scale, b1c, b2c, lr = (_shard.whole(t) for t in (scale, b1c, b2c, lr))
        return adamw_update(p.to_local(), _shard.local(g, placements), m.to_local(),
                            v.to_local(), scale, b1c, b2c, lr, b1, b2, eps, weight_decay)
    if p.device.type == "cpu":
        return adamw_update_reference(p, g, m, v, scale, b1c, b2c, lr, b1, b2, eps,
                                      weight_decay)
    return _update(p, g, m, v, scale, b1c, b2c, lr, b1, b2, eps, weight_decay)
