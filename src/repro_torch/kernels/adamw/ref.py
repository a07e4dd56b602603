"""Plain PyTorch versions of AdamW's update of one leaf.

``adamw_update_reference`` is the plain version: the per-leaf loop of
``optim/adamw.py``, one rounding at a time, updating the leaf in place.
The CPU takes it, and ``chip_smoke.py`` holds the CUDA kernel to it, bit
for bit, on the card.  ``adamw_update_one_pass`` is the kernel's
arithmetic written out in PyTorch (its order, its constants rounded on the
host): the CPU tests hold it to the plain version, bit for bit.
"""

from __future__ import annotations

import torch


def adamw_update_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                           v: torch.Tensor, scale: torch.Tensor, b1c: torch.Tensor,
                           b2c: torch.Tensor, lr: torch.Tensor, b1: float, b2: float,
                           eps: float, weight_decay: float) -> None:
    """One AdamW step of one leaf, in place: ``p`` from its gradient ``g``
    (the dtype of ``p``), moments ``m`` and ``v`` (f32 or bf16); ``scale``
    the clipping factor, ``b1c`` and ``b2c`` the bias corrections, ``lr``
    the learning rate (0-d f32 tensors)."""
    # The reference's arithmetic, one rounding at a time; f32 moments are
    # updated where they lie, so a leaf needs at most three temporaries of
    # its size.
    g = g.float() * scale
    m1 = m.mul_(b1) if m.dtype == torch.float32 else m.float() * b1
    m1.add_(g * (1 - b1))
    v1 = v.mul_(b2) if v.dtype == torch.float32 else v.float() * b2
    sq = g * (1 - b2)
    v1.add_(sq.mul_(g))
    del g, sq
    upd = torch.div(v1, b2c).sqrt_().add_(eps)
    upd = torch.div(m1, b1c).div_(upd)
    upd.add_(weight_decay * p.float()).mul_(lr)
    if m1 is not m:
        m.copy_(m1)
    if v1 is not v:
        v.copy_(v1)
    del m1, v1
    if p.dtype == torch.float32:
        p.sub_(upd)
    else:
        p.copy_(p.float() - upd)


def adamw_update_one_pass(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, scale: torch.Tensor, b1c: torch.Tensor,
                          b2c: torch.Tensor, lr: torch.Tensor,
                          consts: tuple[float, ...]) -> tuple[torch.Tensor, ...]:
    """What the kernel computes, as new (p, m, v) in the inputs' dtypes:
    ``csrc/adamw.cu``'s ``update``, operation for operation, with
    ``consts`` = ``kernel.host_constants(...)`` (already float32 values)."""
    b1, c1, b2, c2, eps, wd = consts
    pf, gs = p.float(), g.float() * scale
    m1 = m.float() * b1 + gs * c1
    v1 = v.float() * b2 + (gs * c2) * gs
    u = (m1 / b1c) / (torch.sqrt(v1 / b2c) + eps)
    u = (u + wd * pf) * lr
    return (pf - u).to(p.dtype), m1.to(m.dtype), v1.to(v.dtype)
