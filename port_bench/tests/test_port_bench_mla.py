"""The latent-attention cell (``dsv2-lite-serve-docs8k-c64``) at smoke size
on the CPU: served through ``serve_closed``, the program agrees with the
plain reference ``reference/mla.py`` in float32; each planted fault comes
out not correct under the cell's limits; the reference's loss equals the
program's; ``arith_mla`` counts by hand; the new readers read the program's
spans and read nothing without them."""

import json

import pytest
import torch

from port_bench import arith_mla, cell as cell_mod, program, trace, weights
from port_bench.reference import mla as ref
from port_bench.tests.small import ROOT, small_run
from port_bench.tests.test_port_bench_reference import F32, _f32
from port_bench.tests.test_port_bench_spans import _launched, _span, _trace
from repro_torch.models import lm
from repro_torch.models.common import count_params

CELL = "dsv2-lite-serve-docs8k-c64"
CONFIG = json.loads((ROOT / "port_bench/configs/deepseek-v2-lite.json").read_text())
# latent 32, RoPE 8, no-RoPE 16, value 16; 4 experts top-2 and 2 shared; a
# dense layer and two MoE layers
SMOKE = dict(num_layers=3, num_kv_heads=4, head_dim=24, d_ff=128, num_experts=4,
             experts_per_token=2, moe_d_ff=32, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=8, v_head_dim=16)
WINDOW = 8.0  # requests of the smoke mix (up to 16 tokens) finish on a loaded CPU
NEW = ("mfu.serve_mla", "mla_prefill_roofline", "mla.absorb_ms", "moe.serve_dispatch_ms")


def test_the_configuration_is_the_published_one():
    cfg = program.model_config(CONFIG)
    assert cfg.pattern_for_layers == ("mla",) + ("mla_moe",) * 26
    assert CONFIG["reduced"] == [] and CONFIG["family"] == "mla"
    assert (cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim) \
        == (CONFIG["kv_lora_rank"], 128, 64, 128)
    assert cfg.rope_scaling == CONFIG["rope_scaling"] and not cfg.norm_topk_prob
    assert cfg.moe_dispatch == "dropless" and not cfg.scale_embeddings
    mix = cell_mod.resolve(ROOT, CELL).mix
    assert (mix["clients"], mix["slots"], mix["max_seq"]) == (64, 64, 8192)


def test_one_served_run_agrees_with_the_reference():
    run = _f32(small_run(CELL, seconds=WINDOW, **F32, **SMOKE))
    out = run.cell.driver.run(run)
    numbers = {k: v["value"] for k, v in out["checks"].items()}
    assert numbers["served_mismatch"] == 0
    assert numbers["served_gap"] < 1e-4, numbers
    assert numbers["decode_logit_err"] < 1e-4, numbers
    samples = out["readings"]["samples"]
    assert len(samples) == 3
    for s in samples:  # every served token after the first was decoded and kept
        assert s["decoded_at"] == list(range(1, len(s["served"])))
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault,number", [("state_unchanged", "decode_logit_err"),
                                          ("token_altered", "served_gap")])
def test_a_planted_fault_is_not_correct(fault, number):
    run = small_run(CELL, seconds=WINDOW, fault=fault, **SMOKE)
    out = run.cell.driver.run(run)
    assert out["correct"] is False, out["checks"]
    caught = out["checks"][number]
    assert caught["value"] > caught["limit"], out["checks"]
    assert out["readings"]["samples"]


def _smoke_tree(seed=5):
    config = dict(CONFIG, **SMOKE, d_model=64, num_heads=4, vocab_size=256,
                  compute_dtype="float32", param_dtype="float32")
    specs = program.param_specs(program.model_config(config))
    return config, specs, weights.make_tree(specs, seed, torch.float32, "cpu")


def test_the_reference_loss_and_training_follow_the_program():
    config, _specs, params = _smoke_tree()
    cfg = program.model_config(config)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 256, (2, 32), generator=gen)
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    want, _m = lm.lm_loss(cfg, params, batch)
    assert ref.loss(config, params, batch, "f32").item() == pytest.approx(want.item(), rel=1e-5)
    out = ref.train(config, params, [batch, batch], dict(
        peak_lr=1e-3, warmup_steps=1, total_steps=10, b1=0.9, b2=0.95, eps=1e-8,
        weight_decay=0.1, clip_norm=1.0), "f32")
    assert len(out["loss"]) == 2 and out["loss"][1] < out["loss"][0]
    assert set(out["grad"]) == {p for p, _t in weights.spec_leaves(_specs)}


def test_arith_counts_by_hand():
    d, h = 2048, 16
    attn = d * h * 192 + d * 576 + 512 * h * 256 + h * 128 * d
    assert arith_mla.attention_params(CONFIG) == attn
    dense = attn + 3 * d * 10944
    moe = attn + d * 64 + (6 + 2) * 3 * d * 1408
    body = dense + 26 * moe
    assert arith_mla.body_active_params(CONFIG) == body
    assert 2.0e9 < body + d * 102400 < 2.7e9  # "2.4 B active"
    # the active parameters are the program's leaves less the unrouted experts
    total = count_params(program.param_specs(program.model_config(CONFIG)))
    idle = 26 * (64 - 6) * 3 * d * 1408 + 102400 * d  # and the embedding table
    norms = 27 * (2 * d + 512) + d
    assert total - idle - norms == body + d * 102400
    n = 3000
    assert arith_mla.prefill_flops(CONFIG, n) == \
        2 * body * n + 2 * d * 102400 + 27 * 2 * h * 320 * (n * (n + 1) // 2)
    assert arith_mla.decode_flops(CONFIG, 64, 64 * 3000) == \
        2 * (body + d * 102400) * 64 + 27 * 2 * h * 1088 * 64 * 3000
    pairs = 4096 * 4097 // 2
    assert arith_mla.flash_forward_bound_s(CONFIG, 4096) == 2 * h * 320 * pairs / 989e12
    assert arith_mla.flash_forward_bound_s(CONFIG, 16) == 2 * h * 16 * (2 * 192 + 2 * 128) / 3.35e12


def _serving_events():
    return [
        _span(trace.WINDOW_SPAN, 0, 100),
        _span("model.prefill", 10, 40), _span("moe_ffn", 12, 30), _span("moe_experts", 15, 20),
        _span("model.decode", 50, 90), _span("attention.decode", 52, 70),
        _span("mla.absorb", 53, 55), _span("mla.absorb", 60, 62),
        _span("moe_ffn", 75, 85),  # a decode's MoE: not a prefill's
        *_launched(1, 13, 13, 16),  # routing and dispatch in the prefill
        *_launched(2, 16, 16, 22, "void flash_kernel_wgmma<256>(x)"),  # in moe_experts
        *_launched(3, 25, 25, 26),
        *_launched(4, 35, 35, 38, "void flash_kernel_wgmma<256>(x)"),
        *_launched(5, 54, 54, 57), *_launched(6, 61, 61, 62),
        *_launched(7, 76, 76, 80),
    ]


def _read(tr, counts, config):
    cell = cell_mod.resolve(ROOT, CELL)
    return {m["name"]: r.read(tr, counts, config) for m, r in cell.per_layer}


def test_the_new_readers():
    got = _read(_trace(_serving_events()),
                {"window_s": 0.1, "prefill_lens": [4096], "decodes": [(64, 64 * 3000)],
                 "flash_forward_calls": 27}, CONFIG)
    assert set(NEW) <= set(got)
    assert got["mla.absorb_ms"] == pytest.approx(3 + 1)  # one decode
    assert got["moe.serve_dispatch_ms"] == pytest.approx(3 + 1)  # one prefill
    bound = 27 * arith_mla.flash_forward_bound_s(CONFIG, 4096)
    assert got["mla_prefill_roofline"] == pytest.approx(100 * bound / 9e-3)
    flops = arith_mla.prefill_flops(CONFIG, 4096) + arith_mla.decode_flops(CONFIG, 64, 64 * 3000)
    assert got["mfu.serve_mla"] == pytest.approx(100 * flops / (0.1 * 989e12))


def test_the_new_readers_read_nothing_without_the_spans():
    """A program without the spans and kernels (the parent of this cell)
    leaves the new metrics out and raises nothing."""
    tr = _trace([_span(trace.WINDOW_SPAN, 0, 100), *_launched(1, 5, 5, 15)])
    got = _read(tr, {"window_s": 0.1}, CONFIG)
    assert all(got[name] is None for name in NEW)
