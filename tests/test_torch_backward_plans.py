"""The plans of the port's two backward kernels, on the CPU: how the
RMS-norm backward cuts rows over threads, blocks and its scratch, and how
the flash backward's dK/dV pass picks its keys a block and its split.

Both plans fix the order of every sum the kernels take, so they must follow
from the shapes and dtypes alone and never from the card (its SM count):
then a replayed training step gives the same bits on any card.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds them against
their plain versions and checks that two calls give the same bits.
"""

import contextlib
import inspect
import types

import pytest
import torch

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.rmsnorm import kernel as rms_kernel

DTYPES = [torch.float32, torch.bfloat16]


def _widths(cfg):
    return {cfg.d_model, cfg.head_dim} if cfg.use_qk_norm else {cfg.d_model}


def test_rmsnorm_backward_plan_is_a_rows_width_and_type_only():
    """The plan takes the width and the type, and the grid the row count
    and the plan: nothing of the card."""
    assert list(inspect.signature(rms_kernel.backward_plan).parameters) == ["cols", "dtype"]
    assert list(inspect.signature(rms_kernel.backward_blocks).parameters) == ["rows", "plan"]
    # recurrentgemma-2b's training rows: 3 warps a row, 4 rows a block, a
    # ring of 2 rows a lane, 128 blocks of 4 rows a lane at N = 2,048.
    plan = rms_kernel.backward_plan(2560, torch.bfloat16)
    assert plan == (8, 96, 4, 2)
    assert rms_kernel.backward_blocks(2048, plan) == 128
    assert rms_kernel.backward_plan(4096, torch.bfloat16) == (8, 128, 3, 2)
    assert rms_kernel.backward_plan(1024, torch.bfloat16) == (8, 32, 8, 4)
    # ragged rows are not whole 16-byte units: registers, not the ring
    assert rms_kernel.backward_plan(77, torch.float32) == (1, 32, 8, 0)
    # the widest rows take the whole block and leave no room for a ring
    assert rms_kernel.backward_plan(16384, torch.bfloat16) == (8, 512, 1, 0)
    with pytest.raises(ValueError, match="wider than"):
        rms_kernel.backward_plan(4 * 512 * 8 + 8, torch.bfloat16)


@pytest.mark.parametrize("rows", [1, 4, 9, 2048, 8192, 10**6])
@pytest.mark.parametrize("cols,dtype", [(2560, torch.bfloat16), (77, torch.float32),
                                        (4096, torch.float32), (64, torch.bfloat16)])
def test_rmsnorm_backward_blocks_cover_the_rows_within_the_cap(rows, cols, dtype):
    """Every row has a lane; a row a lane until the grid reaches its cap,
    and then a lane walks more, so the scratch never passes the cap's rows."""
    plan = rms_kernel.backward_plan(cols, dtype)
    blocks = rms_kernel.backward_blocks(rows, plan)
    assert 1 <= blocks <= rms_kernel.BACKWARD_BLOCKS
    lanes = blocks * plan.groups
    assert lanes * -(-rows // lanes) >= rows
    if blocks < rms_kernel.BACKWARD_BLOCKS:
        assert (blocks - 1) * plan.groups < rows <= lanes
    assert rms_kernel.backward_blocks(rows, plan) == blocks  # a function of its inputs


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rmsnorm_backward_plan_covers_every_configs_widths(arch, dtype):
    size = torch.empty((), dtype=dtype).element_size()
    vec = rms_kernel.UNIT_BYTES // size
    for cfg in (get_config(arch), get_config(arch).smoke()):
        for d in _widths(cfg):
            plan = rms_kernel.backward_plan(d, dtype)
            assert plan.unit in (1, vec) and d % plan.unit == 0
            assert plan.unit == vec or d % vec  # vector units wherever D allows
            assert plan.threads % 32 == 0
            units = d // plan.unit
            # the row fits, four units a thread, with no warp left idle
            assert plan.threads * rms_kernel.BACKWARD_PER_THREAD >= units
            assert (plan.threads - 32) * rms_kernel.BACKWARD_PER_THREAD < units
            assert 1 <= plan.groups <= rms_kernel.BACKWARD_MAX_GROUPS
            assert plan.groups * plan.threads <= rms_kernel.BACKWARD_BLOCK_THREADS
            # the ring holds whole rows of 16-byte units, within its budget
            if plan.ring:
                assert plan.unit == vec and (d * size) % 16 == 0
                assert (4 * d * (1 + plan.groups) + plan.groups * plan.ring * (2 * d * size + 8)
                        <= rms_kernel.BACKWARD_SMEM)


class _RecordingLibrary:
    """Stands in for the built library: records the launch's arguments."""

    def __init__(self):
        self.calls = []

    def rmsnorm_bwd_launch(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("rows,cols,dtype", [(2048, 2560, torch.bfloat16),
                                             (9, 77, torch.float32),
                                             (5000, 1024, torch.bfloat16)])
def test_rmsnorm_backward_scratch_is_what_the_plan_says(monkeypatch, rows, cols, dtype):
    """The wrapper allocates ``partial`` as one row of D floats a block of
    ``backward_blocks`` and hands the kernel that plan and grid (the library
    and the stream are stood in for: no card here)."""
    lib = _RecordingLibrary()
    empties = []
    real_empty = torch.empty

    def recording_empty(*args, **kwargs):
        t = real_empty(*args, **kwargs)
        empties.append(t)
        return t

    monkeypatch.setattr(rms_kernel, "load_backward", lambda: lib)
    monkeypatch.setattr(rms_kernel, "_check_rows", lambda x, scale: None)
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    x = real_empty((rows, cols), dtype=dtype)
    scale = real_empty((cols,), dtype=torch.float32)
    before = rms_kernel.BACKWARD_LAUNCHES
    rms_kernel.rms_norm_bwd_cuda(x, scale, real_empty((rows, cols), dtype=dtype))
    plan = rms_kernel.backward_plan(cols, dtype)
    blocks = rms_kernel.backward_blocks(rows, plan)
    (args,) = lib.calls
    assert args[6:8] == (rows, cols)
    assert args[10:15] == (*plan, blocks)
    (partial,) = [t for t in empties if t.dtype == torch.float32 and t.dim() == 2]
    assert partial.shape == (blocks, cols) and args[5] == partial.data_ptr()
    assert rms_kernel.BACKWARD_LAUNCHES == before + 1


@pytest.mark.parametrize("variant", ["wgmma", "f32"])
def test_flash_backward_keys_a_block_come_from_the_variant_and_head_dim(variant):
    """The keys a block are a table of the variant and the head_dim, known
    without building or loading the library: 32 in f32; in wgmma 64 where
    the warpgroups split by role (D >= 128), 128 where each owns 64 keys."""
    before = flash_kernel.load_backward.cache_info().currsize
    keys = {d: flash_kernel.backward_keys_per_block(variant, d)
            for d in flash_kernel.HEAD_DIMS}
    want = ({d: 32 for d in keys} if variant == "f32"
            else {16: 128, 32: 128, 64: 128, 128: 64, 256: 64})
    assert keys == want
    assert flash_kernel.load_backward.cache_info().currsize == before
    with pytest.raises(ValueError, match="head_dim"):
        flash_kernel.backward_keys_per_block(variant, 96)


@pytest.mark.parametrize("b,h,kv,s,d,want", [
    (1, 10, 1, 2048, 256, 10),   # recurrentgemma-2b: 32 key tiles, every head its own block
    (1, 16, 16, 2048, 128, 1),   # olmoe: 512 blocks already
    (1, 16, 8, 2304, 128, 1),    # internvl2-2b: 36 tiles x 8 KV heads = 288 blocks
    (1, 16, 16, 1024, 64, 1),    # seamless-m4t: 8 tiles of 128 keys x 16 heads = 128 blocks
    (1, 40, 8, 512, 128, 5),     # maverick at 512: 64 blocks, x5
])
def test_flash_backward_split_follows_from_the_shapes(b, h, kv, s, d, want):
    keys = flash_kernel.backward_keys_per_block("wgmma", d)
    assert flash_kernel.backward_split(keys, b, kv, h // kv, s) == want


class _RecordingFlashLibrary:
    """Stands in for the flash backward's library: records each launch."""

    def __init__(self):
        self.calls = []

    def flash_attention_bwd_wgmma_launch(self, *args):
        self.calls.append(("wgmma", args))
        return 0

    def flash_attention_bwd_f32_launch(self, *args):
        self.calls.append(("f32", args))
        return 0


@pytest.mark.parametrize("dtype,b,h,kv,s,d", [
    (torch.bfloat16, 1, 10, 1, 300, 256),   # MQA, split over the query heads
    (torch.bfloat16, 1, 4, 2, 200, 64),     # GQA at 128 keys a block
    (torch.float32, 2, 4, 4, 100, 32),      # MHA in f32, nothing to split
])
def test_flash_backward_launch_gets_the_keys_its_split_assumed(monkeypatch, dtype, b, h, kv,
                                                               s, d):
    """The wrapper hands the launch the split and the keys a block that
    split was computed from (the library refuses any other keys), and sizes
    its scratch by the split (the library and the stream are stood in for:
    no card here)."""
    lib = _RecordingFlashLibrary()
    monkeypatch.setattr(flash_kernel, "load_backward", lambda: lib)
    monkeypatch.setattr(flash_kernel, "_check_inputs",
                        lambda q, k, v, **_: flash_kernel.VARIANTS[q.dtype])
    monkeypatch.setattr(flash_kernel, "_check_tma", lambda **_: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    q, out, d_out = (torch.zeros(b, h, s, d, dtype=dtype) for _ in range(3))
    k, v = torch.zeros(b, kv, s, d, dtype=dtype), torch.zeros(b, kv, s, d, dtype=dtype)
    lse = torch.zeros(b, h, s)
    before = flash_kernel.BACKWARD_LAUNCHES
    flash_kernel.flash_attention_backward_cuda(q, k, v, out, d_out, lse)
    variant = flash_kernel.VARIANTS[dtype]
    keys = flash_kernel.BACKWARD_KEYS_PER_BLOCK[variant][d]
    split = flash_kernel.backward_split(keys, b, kv, h // kv, s)
    ((called, args),) = lib.calls
    assert called == variant
    assert args[11:17] == (b, h, kv, s, s, d)
    assert args[-3:-1] == (split, keys)
    assert (args[10] is None) == (split == 1)
    assert flash_kernel.BACKWARD_LAUNCHES == before + 1
