"""The port's Mandelbrot path against the JAX package's, on the CPU.

Coordinates come from the JAX package's ``grid_coords`` and cross as numpy.
The plain PyTorch version must equal the JAX reference exactly: iteration
counts are integers, and the reference's fused multiply-adds (XLA on the
CPU contracts two) are reproduced with a correctly rounded ``fma_f32``.
The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

import importlib.util
import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mandelbrot import ops as jax_ops
from repro.kernels.mandelbrot import ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels.mandelbrot import kernel as port_kernel
from repro_torch.kernels.mandelbrot import ops as port_ops
from repro_torch.kernels.mandelbrot import ref as port_ref

ROOT = Path(__file__).resolve().parents[1]

SMALL = [(16, 128, 50), (32, 300, 100), (9, 77, 30)]
# An uncontracted float32 loop differs from the reference at the last three.
EXACT = SMALL + [(400, 700, 200), (64, 700, 1000)]


def _jax_grid(h, w):
    x, y = jax_ref.grid_coords(h, w)
    return np.asarray(x), np.asarray(y)


def _port(fn, x, y, iters):
    it, col = fn(torch.from_numpy(x.copy()), torch.from_numpy(y.copy()), iters)
    assert it.dtype == col.dtype == torch.int32
    return it.numpy(), col.numpy()


@pytest.mark.parametrize("h,w,iters", EXACT)
def test_plain_version_equals_jax_reference_exactly(h, w, iters):
    x, y = _jax_grid(h, w)
    it_j, col_j = jax_ref.mandelbrot_reference(jnp.asarray(x), jnp.asarray(y), iters)
    it_t, col_t = _port(port_ref.mandelbrot_reference, x, y, iters)
    np.testing.assert_array_equal(it_t, np.asarray(it_j))
    np.testing.assert_array_equal(col_t, np.asarray(col_j))


def _uncontracted(x0, y0, max_iters):
    """The reference's loop with every product rounded: no fma anywhere."""
    zx = torch.zeros_like(x0)
    zy = torch.zeros_like(x0)
    iters = torch.zeros(x0.shape, dtype=torch.int32)
    alive = torch.ones(x0.shape, dtype=torch.bool)
    for _ in range(max_iters):
        zx2, zy2 = zx * zx, zy * zy
        alive &= (zx2 + zy2) < 4.0
        zx, zy = (torch.where(alive, zx2 - zy2 + x0, zx),
                  torch.where(alive, 2.0 * zx * zy + y0, zy))
        iters += alive.to(torch.int32)
    return iters


@pytest.mark.parametrize("h,w,iters,differ", [
    (32, 300, 100, 1), (400, 700, 200, 394), (64, 700, 1000, 48)])
def test_uncontracted_loop_differs_from_reference(h, w, iters, differ):
    """Why the plain version and the kernel compute two fmas: without them
    boundary points get other counts than the reference's."""
    x, y = _jax_grid(h, w)
    it_j, _ = jax_ref.mandelbrot_reference(jnp.asarray(x), jnp.asarray(y), iters)
    it_u = _uncontracted(torch.from_numpy(x.copy()), torch.from_numpy(y.copy()), iters)
    assert int((it_u.numpy() != np.asarray(it_j)).sum()) == differ


@pytest.mark.parametrize("h,w,iters", SMALL)
def test_ops_equals_jax_pallas_kernel(h, w, iters):
    """Against the Pallas kernel in interpret mode, as tests/test_kernels.py
    runs it; the port's ``ops.mandelbrot`` on CPU tensors is the plain path."""
    x, y = _jax_grid(h, w)
    it_j, col_j = jax_ops.mandelbrot(jnp.asarray(x), jnp.asarray(y), max_iters=iters)
    it_t, col_t = _port(lambda a, b, n: port_ops.mandelbrot(a, b, max_iters=n),
                        x, y, iters)
    np.testing.assert_array_equal(it_t, np.asarray(it_j))
    np.testing.assert_array_equal(col_t, np.asarray(col_j))


@pytest.mark.parametrize("h,w,kw", [
    (9, 77, {}), (400, 700, {}), (3, 5600, {}),
    (5, 333, {"min_x": -1.75, "min_y": 0.5, "range_x": 1.25}),
])
def test_grid_coords_bit_exact(h, w, kw):
    x_j, y_j = (np.asarray(a) for a in jax_ref.grid_coords(h, w, **kw))
    x_t, y_t = port_ref.grid_coords(h, w, device="cpu", **kw)
    assert x_t.dtype == y_t.dtype == torch.float32
    np.testing.assert_array_equal(x_t.numpy().view(np.int32), x_j.view(np.int32))
    np.testing.assert_array_equal(y_t.numpy().view(np.int32), y_j.view(np.int32))


@pytest.mark.parametrize("width,line_y", [(5600, 0), (5600, 3199), (700, 399), (77, 5)])
def test_line_coords_bit_exact(width, line_y):
    x_j, y_j = (np.asarray(a) for a in jax_ref.line_coords(width, line_y))
    x_t, y_t = port_ref.line_coords(width, line_y, device="cpu")
    np.testing.assert_array_equal(x_t.numpy().view(np.int32), x_j.view(np.int32))
    np.testing.assert_array_equal(y_t.numpy().view(np.int32), y_j.view(np.int32))


@pytest.mark.parametrize("width,line_y", [(5600, 0), (5600, 3199), (300, 86), (77, 5)])
def test_line_params_give_the_line_kernels_coordinates(width, line_y):
    """The line kernel gets ``line_params`` rounded to float32 and builds
    point i as the float32 sum of min_x and the float32 product i * delta;
    in numpy float32 that is the JAX package's ``line_coords`` bit for bit."""
    y, min_x, delta = (np.float32(v) for v in port_ref.line_params(width, line_y))
    x = min_x + np.arange(width, dtype=np.float32) * delta
    x_j, y_j = (np.asarray(a) for a in jax_ref.line_coords(width, line_y))
    np.testing.assert_array_equal(x.view(np.int32), x_j.view(np.int32))
    np.testing.assert_array_equal(np.full(width, y).view(np.int32), y_j.view(np.int32))


def test_paper_white_fraction():
    """Paper section 8: ~14.06M of 17.92M points are white; a 1/8-scale
    grid at 200 iterations gives a comparable fraction."""
    x, y = port_ref.grid_coords(400, 700, device="cpu")
    _iters, col = port_ops.mandelbrot(x, y, max_iters=200)
    assert 0.70 < float(col.float().mean()) < 0.90


# -- one work item: a line's sums ---------------------------------------------


def _lines(width):
    """Line 0, the image's last line and the line through the real axis, where
    the set's interior runs to max_iters (the image is 4/7 as high as wide)."""
    return [0, 4 * width // 7 - 1, round(width / 3.5)]


@pytest.mark.parametrize("iters", [30, 100])
@pytest.mark.parametrize("width", [300, 5600])
def test_line_stats_equal_jax_work_function(width, iters):
    """The port's work item against the JAX quickstart's: ``line_coords``,
    the Pallas kernel in interpret mode, then the two sums."""
    for line_y in _lines(width):
        x, y = jax_ref.line_coords(width, line_y)
        it_j, col_j = jax_ops.mandelbrot(x[None], y[None], max_iters=iters)
        want = [int(jnp.sum(col_j)), int(jnp.sum(it_j))]
        got = port_ops.mandelbrot_line_stats(width, line_y, iters, device="cpu")
        assert got.dtype == torch.int64 and got.shape == (2,)
        assert got.tolist() == want, line_y
    assert 0 < want[0] < width  # the axis line has interior points


@pytest.fixture(scope="module")
def jax_quickstart():
    """The JAX package's quickstart at a small instance (300 x 32 x 100)."""
    knobs = {"QUICKSTART_WIDTH": "300", "QUICKSTART_LINES": "32",
             "QUICKSTART_ITERS": "100"}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in knobs.items():
            mp.setenv(k, v)
        spec = importlib.util.spec_from_file_location(
            "jax_quickstart_mandelbrot", ROOT / "examples" / "quickstart.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def test_work_function_equals_jax_calculate_on_every_line(jax_quickstart):
    from repro_torch.quickstart import make_calculate

    calculate = make_calculate(300, 100, torch.device("cpu"))
    for line_y in range(32):
        got, want = calculate(line_y), jax_quickstart.calculate(line_y)
        assert got == want and type(got["white"]) is type(got["total_iters"]) is int


# -- fma ---------------------------------------------------------------------


def _exact_fma_f32(a, b, c):
    """Round the exact rational a*b+c to the nearest float32, ties to even."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(exact))
    cands = [f, np.nextafter(f, np.float32(np.inf)), np.nextafter(f, np.float32(-np.inf))]
    best = min(abs(Fraction(float(v)) - exact) for v in cands)
    ties = [v for v in cands if abs(Fraction(float(v)) - exact) == best]
    return min(ties, key=lambda v: int(np.array(v).view(np.int32)) & 1)


# a*b+c = 2^24 + 3 - 2^-30 rounds to 2^24 + 3 in float64, which then rounds
# (ties to even) to 2^24 + 4; the correctly rounded float32 is 2^24 + 2.
DOUBLE_ROUNDING = (1 + 2.0**-15, 1 - 2.0**-15, 2.0**24 + 2)


def test_fma_f32_is_correctly_rounded():
    rng = np.random.default_rng(0)
    n = 3000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-3, 4, n)).astype(np.float32)
    c = (rng.standard_normal(n) * 2.0 ** rng.integers(-6, 6, n)).astype(np.float32)
    a = np.append(a, np.float32(DOUBLE_ROUNDING[0]))
    b = np.append(b, np.float32(DOUBLE_ROUNDING[1]))
    c = np.append(c, np.float32(DOUBLE_ROUNDING[2]))
    got = port_ref.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                           torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma_f32(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_f32_avoids_double_rounding():
    a, b, c = (torch.tensor([v], dtype=torch.float32) for v in DOUBLE_ROUNDING)
    naive = (a.double() * b.double() + c.double()).float()
    assert float(naive) == 2.0**24 + 4  # what rounding twice gives
    assert float(port_ref.fma_f32(a, b, c)) == 2.0**24 + 2


# -- device rule: no silent CPU, no fallback ---------------------------------


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("call", [
    lambda: port_ref.line_coords(16, 0),
    lambda: port_ref.grid_coords(4, 16),
    lambda: port_ref.line_coords(16, 0, device="cuda"),
    lambda: port_ops.mandelbrot_line_stats(16, 0, 10),
])
def test_default_device_is_cuda_and_raises_without_it(no_cuda, call):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def test_cuda_tensors_go_to_the_kernel_not_the_plain_version(monkeypatch):
    """Dispatch is by the tensor's device: a non-CPU tensor never reaches
    the plain version (meta tensors stand in for CUDA ones here)."""
    def plain_must_not_run(*_a, **_k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    seen = []
    monkeypatch.setattr(port_ops, "mandelbrot_reference", plain_must_not_run)
    def kernel(x, y, n):
        seen.append((x.device.type, n))
        return tuple(torch.empty(x.shape, dtype=torch.int32, device=x.device)
                     for _ in range(2))

    monkeypatch.setattr(port_ops, "mandelbrot_cuda", kernel)
    x = torch.empty(2, 3, device="meta")
    # the op's implementation (what a CUDA tensor runs) takes the kernel
    port_ops._mandelbrot_impl(x, x, 7)
    assert seen == [("meta", 7)]
    # the entry point is a torch.library op: a meta tensor takes its fake
    # impl (shapes only), never the plain version
    iters, colour = port_ops.mandelbrot(x, x, max_iters=7)
    assert iters.device.type == colour.device.type == "meta"
    assert iters.dtype == torch.int32 and tuple(iters.shape) == (2, 3)
    assert seen == [("meta", 7)]


def test_cuda_device_goes_to_the_line_kernel_not_the_plain_version(monkeypatch):
    def plain_must_not_run(*_a, **_k):
        raise AssertionError("plain line version reached with a CUDA device")

    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_ops, "line_stats_reference", plain_must_not_run)
    monkeypatch.setattr(port_ops, "mandelbrot_line_cuda",
                        lambda *args: seen.append(args))
    port_ops.mandelbrot_line_stats(300, 5, 30, device="cuda")
    port_ops.mandelbrot_line_stats(300, 7, 40)
    cuda = torch.device("cuda")
    assert seen == [(300, *port_ref.line_params(300, 5), 30, cuda),
                    (300, *port_ref.line_params(300, 7), 40, cuda)]
    delta = 3.5 / 300  # the paper's view: x from -2.5 over 3.5, y down from 1
    assert port_ref.line_params(300, 7) == (1.0 - 7 * delta, -2.5, delta)


@pytest.mark.parametrize("width,max_iters,device", [
    (0, 10, "cuda"), (-3, 10, "cuda"), (2**31, 10, "cuda"),
    (16, -1, "cuda"), (16, 2**31, "cuda"),
    (16, 10, "cpu"), (16, 10, "meta"),
])
def test_line_wrapper_rejects_what_it_cannot_launch(width, max_iters, device):
    launches = port_kernel.LAUNCHES
    with pytest.raises(ValueError):
        port_kernel.mandelbrot_line_cuda(width, 0.5, -2.5, 0.01, max_iters, device)
    assert port_kernel.LAUNCHES == launches


@pytest.mark.parametrize("x0,y0", [
    (torch.zeros(2, 3), torch.zeros(2, 3)),                      # CPU
    (torch.empty(2, 3, device="meta"), torch.empty(2, 3, device="meta")),
    (torch.zeros(2, 3), torch.empty(2, 3, device="meta")),       # mixed
])
def test_kernel_wrapper_rejects_what_it_cannot_launch(x0, y0):
    launches = port_kernel.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        port_kernel.mandelbrot_cuda(x0, y0, 10)
    with pytest.raises(ValueError):  # the op's implementation, off the CPU
        port_ops._mandelbrot_impl(x0.to("meta"), y0, 10)
    assert port_kernel.LAUNCHES == launches


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.os, "access", lambda *_a: False)
    port_kernel.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        port_kernel.load()
    assert not (tmp_path / "build").exists()


def test_modules_import_without_nvcc():
    """Importing the kernel's modules builds nothing and needs no nvcc."""
    probe = ("import repro_torch.kernels.mandelbrot.ops; "
             "from repro_torch.kernels.mandelbrot.kernel import load; "
             "assert load.cache_info().currsize == 0")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), PATH="")
    subprocess.run([sys.executable, "-c", probe], env=env, check=True, timeout=120)
