"""Plain PyTorch version of the Mandelbrot escape-time computation.

This is the paper's workload (Appendix B, ``Mdata.calculateColour``): for
each point c = x + iy iterate z <- z^2 + c until |z|^2 >= 4 or the escape
value is reached.  ``iterations`` counts loop trips (capped at
``max_iters``) and ``colour`` is WHITE (1) when the point escaped, BLACK (0)
otherwise — the paper's convention {4:53}.

The loop is the JAX reference's, trip for trip, with its fixed trip count
and ``alive`` mask.  The JAX reference compiles through XLA on the CPU,
which contracts two of its operations into fused multiply-adds::

    new_zx = fma(zx, zx, -zy2) + x0
    new_zy = fma(2 * zx, zy, y0)

A loop that rounds every product instead differs from it at boundary
points (394 of 280,000 on a 400x700 grid at 200 iterations), so this
version computes those two fmas, correctly rounded, with :func:`fma_f32`.
The CUDA kernel computes the same two with ``__fmaf_rn``.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` on any device.

    The float64 product of two float32 values is exact.  Adding ``c`` in
    float64 rounds once; TwoSum recovers what that rounding dropped, and
    rounding to odd (moving an even result one ulp toward the dropped part)
    keeps the final rounding to float32 from rounding twice.
    """
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def mandelbrot_reference(x0: torch.Tensor, y0: torch.Tensor, max_iters: int):
    """x0, y0: f32 tensors of one shape -> (iterations i32, colour i32)."""
    zx = torch.zeros_like(x0)
    zy = torch.zeros_like(x0)
    iters = torch.zeros(x0.shape, dtype=torch.int32, device=x0.device)
    alive = torch.ones(x0.shape, dtype=torch.bool, device=x0.device)
    for _ in range(max_iters):
        zx2 = zx * zx
        zy2 = zy * zy
        alive = alive & ((zx2 + zy2) < 4.0)
        new_zx = fma_f32(zx, zx, -zy2) + x0
        new_zy = fma_f32(2.0 * zx, zy, y0)
        zx = torch.where(alive, new_zx, zx)
        zy = torch.where(alive, new_zy, zy)
        iters += alive.to(torch.int32)
    colour = (iters < max_iters).to(torch.int32)  # WHITE=1 escaped
    return iters, colour


# The paper's view of the plane: x from -2.5 over 3.5, y down from 1.0.
MIN_X, MIN_Y, RANGE_X = -2.5, 1.0, 3.5


def line_stats_reference(width: int, line_y: int, max_iters: int):
    """One line of the paper's job on the CPU -> int64 [2]: (points that
    escaped, the sum of their iteration counts), as the JAX quickstart's
    work function sums them."""
    x0, y0 = line_coords(width, line_y, device="cpu")
    iters, colour = mandelbrot_reference(x0[None], y0[None], max_iters)
    return torch.stack((colour.sum(), iters.sum()))


def line_params(width: int, line_y: int, *, min_x=MIN_X, min_y=MIN_Y,
                range_x=RANGE_X):
    """The paper's geometry of line ``line_y`` {4:26-39}, in Python floats:
    (its y, the x of its first point, the step between points).  Point ``i``
    is at ``min_x + i * delta``."""
    delta = range_x / width
    return min_y - line_y * delta, min_x, delta


def line_coords(width: int, line_y: int, *, min_x=MIN_X, min_y=MIN_Y,
                range_x=RANGE_X, device=None):
    """The paper's ``createInstance`` coordinate layout {4:26-39}.

    The same float32 operations as the JAX package, so the coordinates are
    equal bit for bit: ``min_x`` and ``delta`` round to float32 before the
    float32 product and sum; the row's ``y`` is computed in Python and
    rounded once.
    """
    dev = resolve_device(device)
    f32 = torch.float32
    y, min_x, delta = line_params(width, line_y, min_x=min_x, min_y=min_y,
                                  range_x=range_x)
    x = (torch.tensor(min_x, dtype=f32)
         + torch.arange(width, dtype=f32, device=dev)
         * torch.tensor(delta, dtype=f32))
    return x, torch.full((width,), y, dtype=f32, device=dev)


def grid_coords(height: int, width: int, *, min_x=MIN_X, min_y=MIN_Y,
                range_x=RANGE_X, device=None):
    """[height, width] grids whose row ``r`` is ``line_coords(width, r)``."""
    geometry = dict(min_x=min_x, min_y=min_y, range_x=range_x)
    x, _ = line_coords(width, 0, device=device, **geometry)
    y = torch.tensor([line_params(width, r, **geometry)[0] for r in range(height)],
                     dtype=torch.float32, device=x.device)
    return (x.expand(height, width).contiguous(),
            y[:, None].expand(height, width).contiguous())
