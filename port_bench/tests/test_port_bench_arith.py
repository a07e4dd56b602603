"""The frozen FLOP and byte arithmetic against counts by hand from the
configurations' widths, and against the program's own conventions."""

import json

import pytest

from port_bench import arith, program
from port_bench.tests.small import ROOT
from repro_torch.models import flops

OLMOE = json.loads((ROOT / "port_bench/configs/olmoe-1b-7b-l8.json").read_text())
YI = json.loads((ROOT / "port_bench/configs/yi-9b.json").read_text())


def test_olmoe_by_hand():
    attn = 2048 * (16 + 32) * 128 + 16 * 128 * 2048  # q, k, v; o
    assert attn == 16_777_216
    layer = attn + 2048 * 64 + 8 * 3 * 2048 * 1024  # router; 8 experts
    assert arith.body_active_params(OLMOE) == 8 * layer == 537_919_488
    head = 2048 * 50304
    step = 6 * (8 * layer + head) * 4096 + 3 * 8 * 4 * 16 * 128 * (4096 * 4097 // 2)
    assert arith.train_step_flops(OLMOE, 1, 4096) == step
    assert 17.3e12 < step < 17.5e12


def test_yi_by_hand():
    layer = 4096 * (32 + 8) * 128 + 32 * 128 * 4096 + 3 * 4096 * 11008
    assert arith.body_active_params(YI) == 48 * layer
    prompt = 2048
    want = 2 * 48 * layer * prompt + 2 * 4096 * 64000 \
        + 48 * 4 * 32 * 128 * (2048 * 2049 // 2)
    assert arith.prefill_flops(YI, prompt) == want
    tick = arith.decode_flops(YI, 64, 64 * 3000)
    assert tick == 64 * 2 * (48 * layer + 4096 * 64000) + 48 * 4 * 32 * 128 * 64 * 3000


@pytest.mark.parametrize("config", [OLMOE, YI], ids=["olmoe", "yi"])
def test_active_parameters_follow_the_ports_convention(config):
    cfg = program.model_config(config)
    assert arith.body_active_params(config) == flops.param_counts(cfg)[1]


def test_flash_bounds_by_hand():
    # olmoe's training call [1, 16, 4096, 128]: bound by the products
    pairs = 4096 * 4097 // 2
    assert arith.flash_backward_bound_s(1, 16, 16, 4096, 128) == \
        10 * 16 * 128 * pairs / 989e12
    assert arith.flash_forward_bound_s(1, 32, 4, 2048, 128) == \
        4 * 32 * 128 * (2048 * 2049 // 2) / 989e12
    # a short call is bound by its bytes
    assert arith.flash_forward_bound_s(1, 32, 4, 16, 128) == \
        2 * 128 * (2 * 32 * 16 + 2 * 4 * 16) / 3.35e12
    assert arith.visible_pairs(10, 4) == 4 * 5 // 2 + 6 * 4
