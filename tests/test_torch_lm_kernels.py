"""The port's RMS-norm and flash-attention paths against the JAX package's,
on the CPU, and the no-fallback rules of every serving kernel (the RG-LRU
scan's own parity tests are in ``test_torch_rglru.py``).

Inputs are made with numpy from a seed and cast to each dtype by each
framework (both round to nearest even, so the inputs are equal).  On CPU
tensors the port's entry points run their plain versions; the CUDA kernels
themselves run only on the card, where ``chip_smoke.py`` holds them against
these plain versions.  Tolerances are the JAX package's own
(``tests/test_kernels.py``): RMS norm 1e-6 (f32) and 2e-2 (bf16); flash
attention 2e-6 against the reference, 3e-6 against the model's blockwise
path, 2e-2 in bf16.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_reference as jax_flash_ref
from repro.kernels.rmsnorm import ops as jax_rms_ops
from repro.kernels.rmsnorm.ref import rms_norm_reference as jax_rms_ref
from repro.models.attention import attention_blockwise as jax_blockwise
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mandelbrot import kernel as mandel_kernel
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rmsnorm import kernel as rms_kernel
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm import ref as rms_ref
from repro_torch.models import attention as port_attn

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(x: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x.copy()).to(tdt)


def _close(port: torch.Tensor, ref, atol: float) -> None:
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


# -- RMS norm ------------------------------------------------------------------

# recurrentgemma-2b's D = 2560 and yi-9b's one row of D = 4096 among them.
RMS_SHAPES = [(8, 512), (3, 100, 256), (4, 1000), (9, 77), (4, 2560), (1, 4096)]
RMS_TOL = {"float32": 1e-6, "bfloat16": 2e-2}


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
def test_rmsnorm_plain_version_matches_jax(shape, dtype, oracle):
    rng = np.random.default_rng(0)
    d = shape[-1]
    jx, tx = _both(rng.standard_normal(shape, dtype=np.float32), dtype)
    scale = (0.2 * rng.standard_normal(d)).astype(np.float32)
    if oracle == "reference":
        want = jax_rms_ref(jx.reshape(-1, d), jnp.asarray(scale)).reshape(shape)
    else:  # the Pallas kernel itself, in interpret mode
        want = jax_rms_ops.rms_norm(jx, jnp.asarray(scale))
    got = rms_ops.rms_norm(tx, torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, want, RMS_TOL[dtype])


def _norm_widths(cfg):
    """Every row width the model normalises: d_model, and head_dim where
    queries and keys are normalised."""
    return {cfg.d_model, cfg.head_dim} if cfg.use_qk_norm else {cfg.d_model}


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_rmsnorm_launch_plan_covers_every_configs_widths(arch, dtype):
    for cfg in (get_config(arch), get_config(arch).smoke()):
        for d in _norm_widths(cfg):
            plan = rms_kernel.launch_plan(d, dtype)
            vec = rms_kernel.UNIT_BYTES // torch.empty((), dtype=dtype).element_size()
            assert plan.unit in (1, vec) and d % plan.unit == 0
            assert plan.unit == vec or d % vec  # vector units wherever D allows
            assert plan.threads % 32 == 0 and plan.threads <= rms_kernel.MAX_THREADS
            units = d // plan.unit
            # the row fits, two units a thread, with no warp left idle
            assert plan.threads * rms_kernel.PER_THREAD >= units
            assert (plan.threads - 32) * rms_kernel.PER_THREAD < units
            assert plan.rows_per_block * plan.threads <= max(
                rms_kernel.BLOCK_THREADS, plan.threads)


def test_rmsnorm_launch_plan_is_a_rows_width_and_type_only():
    """The plan takes no row count, so a row reduces the same in every
    launch; rows wider than the kernel holds are refused."""
    assert list(inspect.signature(rms_kernel.launch_plan).parameters) == [
        "cols", "dtype"]
    assert rms_kernel.launch_plan(4096, torch.bfloat16) == (8, 256, 1)
    assert rms_kernel.launch_plan(2560, torch.bfloat16) == (8, 160, 1)
    assert rms_kernel.launch_plan(77, torch.float32) == (1, 64, 4)
    with pytest.raises(ValueError, match="wider than"):
        rms_kernel.launch_plan(2 * rms_kernel.MAX_THREADS * 4 + 4, torch.float32)


def test_rmsnorm_cpu_entry_point_is_the_plain_version():
    x = torch.randn(5, 33, generator=torch.Generator().manual_seed(0))
    s = torch.full((33,), 0.25)
    before = rms_kernel.LAUNCHES
    assert torch.equal(rms_ops.rms_norm(x, s), rms_ref.rms_norm_reference(x, s))
    assert rms_kernel.LAUNCHES == before


# -- flash attention ------------------------------------------------------------

# (b, h, kv, s, d, causal, window): the sweep of tests/test_kernels.py.
FLASH_SWEEP = [
    (2, 4, 4, 256, 64, True, 0),
    (1, 8, 2, 256, 32, True, 64),
    (2, 2, 2, 128, 128, False, 0),
    (1, 4, 1, 384, 64, True, 128),
    (1, 4, 4, 200, 64, True, 0),  # ragged
]
FLASH_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
BLOCKWISE_TOL = {"float32": 3e-6, "bfloat16": 2e-2}


def _qkv(b, h, kv, s, d, dtype, layout):
    """numpy inputs in [B, heads, S, D] ("bhsd") or [B, S, heads, D]."""
    rng = np.random.default_rng(7)
    shapes = [(b, h, s, d), (b, kv, s, d), (b, kv, s, d)]
    arrays = [rng.standard_normal(shp, dtype=np.float32) for shp in shapes]
    if layout == "bshd":
        arrays = [np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in arrays]
    return [_both(a, dtype) for a in arrays]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FLASH_SWEEP)
def test_flash_plain_version_matches_jax_reference(b, h, kv, s, d, causal,
                                                   window, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, h, kv, s, d, dtype, "bhsd")
    want = jax_flash_ref(jq, jnp.repeat(jk, h // kv, axis=1),
                         jnp.repeat(jv, h // kv, axis=1),
                         causal=causal, window=window)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, want, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kv,s,d,causal,window", FLASH_SWEEP)
def test_model_attention_matches_jax_blockwise(b, h, kv, s, d, causal, window,
                                               dtype):
    """The model's [B, S, H, D] attention against the JAX model's blockwise
    XLA path (grouped KV heads, no repeat)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(b, h, kv, s, d, dtype, "bshd")
    q_chunk = 64 if s % 64 == 0 else 8
    want = jax_blockwise(jq, jk, jv, causal=causal, window=window,
                         q_chunk=q_chunk)
    got = port_attn.attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == tq.shape
    _close(got, want, BLOCKWISE_TOL[dtype])


def test_flash_cpu_entry_point_repeats_kv_heads():
    """GQA on the CPU: query head h reads KV head h // (H / KV)."""
    (_, q), (_, k), (_, v) = _qkv(1, 6, 2, 40, 16, "float32", "bhsd")
    got = flash_ops.flash_attention(q, k, v, window=8)
    for h in range(6):
        one = flash_ops.flash_attention(q[:, h:h + 1], k[:, h // 3:h // 3 + 1],
                                        v[:, h // 3:h // 3 + 1], window=8)
        assert torch.equal(got[:, h:h + 1], one)


# -- what the wgmma variant's TMA unit takes ------------------------------------------

ALIGNED = 1 << 20  # a base address on a 16-byte boundary


@pytest.mark.parametrize("d", flash_kernel.HEAD_DIMS)
@pytest.mark.parametrize("b,h,kv,s", [(1, 32, 4, 77), (1, 10, 1, 3000), (2, 8, 2, 1)])
def test_tma_layout_rule_takes_the_models_views(b, h, kv, s, d):
    """The model passes q, k and v as [B, S, heads, D] tensors transposed to
    [B, heads, S, D] views (``models/attention.py``); the output is
    ``empty_like`` of q.  All of them pass, and so do contiguous tensors."""
    for heads in (h, kv):
        base = torch.empty((b, s, heads, d), dtype=torch.bfloat16)
        for t in (base.transpose(1, 2), torch.empty_like(base.transpose(1, 2)),
                  base.transpose(1, 2).contiguous()):
            assert flash_kernel.tma_layout_error(
                t.shape, t.stride(), t.dtype, ALIGNED) is None, (t.shape, t.stride())


@pytest.mark.parametrize("change,why", [
    (lambda sh, st, dt, p: (sh, (st[0], st[1], st[2] + 1, 1), dt, p), "stride"),
    (lambda sh, st, dt, p: (sh, (st[0], st[1] - 1, st[2], 1), dt, p), "stride"),
    (lambda sh, st, dt, p: (sh, (st[0] + 1, st[1], st[2], 1), dt, p), "stride"),
    (lambda sh, st, dt, p: (sh, st, dt, p + 2), "base address"),
    (lambda sh, st, dt, p: (sh, st, torch.float32, p), "bfloat16"),
    (lambda sh, st, dt, p: (sh, (st[0], st[1], st[2], 2), dt, p), "last dimension"),
    (lambda sh, st, dt, p: ((*sh[:3], 48), st, dt, p), "head_dim"),
    (lambda sh, st, dt, p: (sh[1:], st[1:], dt, p), "not [B, heads, S, D]"),
], ids=["seq_stride_off_by_one", "head_stride_off_by_one", "batch_stride_off_by_one",
        "base_off_by_one_element", "float32", "last_dim_strided", "head_dim_48", "3-D"])
def test_tma_layout_rule_refuses(change, why):
    t = torch.empty((2, 300, 10, 256), dtype=torch.bfloat16).transpose(1, 2)
    args = change(tuple(t.shape), t.stride(), t.dtype, ALIGNED)
    assert why in flash_kernel.tma_layout_error(*args)


def test_tma_strides_ignore_dimensions_of_size_one():
    """A dimension of size 1 is never stepped along: any stride passes the
    rule there, and ``tma_strides`` hands the kernel the row length."""
    t = torch.empty((1, 200, 1, 128), dtype=torch.bfloat16).transpose(1, 2)
    odd = (7, 3, t.stride(2), 1)
    assert flash_kernel.tma_layout_error(t.shape, odd, t.dtype, ALIGNED) is None
    assert flash_kernel.tma_strides(t) == (128, 128, t.stride(2))


def test_flash_variant_follows_the_dtype():
    assert flash_kernel.VARIANTS == {torch.bfloat16: "wgmma", torch.float32: "f32"}
    assert set(flash_kernel.LAUNCHES_BY_VARIANT) == {"wgmma", "f32"}


# -- no fallback, and the build ---------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda t: rms_kernel.rms_norm_cuda(t, torch.zeros(t.shape[-1])),
    lambda t: flash_kernel.flash_attention_cuda(t[None, None], t[None, None],
                                                t[None, None]),
    lambda t: rglru_kernel.rglru_scan_cuda(t[None], t[None]),
    lambda t: rglru_kernel.rglru_scan_cuda(t[None], t[None], t[:1]),
], ids=["rmsnorm", "flash", "rglru", "rglru_h0"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    before = (rms_kernel.LAUNCHES, flash_kernel.LAUNCHES, rglru_kernel.LAUNCHES,
              dict(flash_kernel.LAUNCHES_BY_VARIANT))
    for dtype in (torch.float32, torch.bfloat16):  # either flash variant
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(torch.zeros(8, 32, dtype=dtype))
    assert (rms_kernel.LAUNCHES, flash_kernel.LAUNCHES, rglru_kernel.LAUNCHES,
            flash_kernel.LAUNCHES_BY_VARIANT) == before


@pytest.mark.parametrize("impl,entry", [
    (lambda t: rms_ops._forward_impl(t, torch.zeros(32, device="meta"), 1e-6),
     lambda t: rms_ops.rms_norm(t, torch.zeros(32, device="meta"))),
    (lambda t: flash_ops._forward_impl(t[None, None], t[None, None],
                                       t[None, None], True, 0),
     lambda t: flash_ops.flash_attention(t[None, None], t[None, None],
                                         t[None, None])),
    (lambda t: rglru_ops._scan_impl(t[None], t[None]),
     lambda t: rglru_ops.rglru_scan(t[None], t[None])),
    (lambda t: rglru_ops._scan_impl(torch.zeros(1, 8, 32), torch.zeros(1, 8, 32),
                                    t[:1]),
     lambda t: rglru_ops.rglru_scan(torch.zeros(1, 8, 32, device="meta"),
                                    torch.zeros(1, 8, 32, device="meta"), t[:1])),
], ids=["rmsnorm", "flash", "rglru", "rglru_h0_off_cpu"])
def test_entry_points_send_non_cpu_tensors_to_the_kernel(impl, entry, monkeypatch):
    """A tensor off the CPU never takes the plain version: the op's
    implementation (what a CUDA tensor runs) hands it to the kernel's
    wrapper, which refuses anything but a CUDA tensor.  Through the public
    entry point (a ``torch.library`` op) a meta tensor takes the op's fake
    impl: shapes only, no plain version and no launch."""
    def plain_must_not_run(*_a, **_k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    for module, name in ((rms_ops, "rms_norm_reference"),
                         (flash_ops, "attention_reference"),
                         (rglru_ops, "rglru_scan_reference")):
        monkeypatch.setattr(module, name, plain_must_not_run)
    before = (rms_kernel.LAUNCHES, flash_kernel.LAUNCHES, rglru_kernel.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):  # either flash variant
        t = torch.zeros(8, 32, device="meta", dtype=dtype)
        with pytest.raises(ValueError, match="CUDA tensor"):
            impl(t)
        out = entry(t)
        out = out[0] if isinstance(out, tuple) else out
        assert out.device.type == "meta"
    assert (rms_kernel.LAUNCHES, flash_kernel.LAUNCHES,
            rglru_kernel.LAUNCHES) == before


def test_build_flags_are_per_source_and_hashed():
    sources = (mandel_kernel.SOURCE, rms_kernel.SOURCE, flash_kernel.SOURCE,
               rglru_kernel.SOURCE)
    paths = {_build.library_path(s, f) for s in sources
             for f in ((), ("-fmad=false",))}
    assert len(paths) == 8  # the flags and the source each change the name
    assert mandel_kernel.FLAGS == ("-fmad=false",)
    assert "-fmad=false" not in _build.NVCC_FLAGS
    assert all(p.parent == _build.BUILD_DIR for p in paths)
