"""DeepSeek-V2's latent attention (MLA) and dropless MoE in the port, against
the plain float32 reference ``tests/mla_reference.py`` on the CPU.

At smoke widths (latent 32, RoPE 8, no-RoPE 16, value 16, 4 experts top-2
and 2 shared) in float32: the forward, the loss and every leaf's gradient
agree with the reference to round-off; a prefill and decode through the
serving engine's latent cache give the reference's full-forward logits;
the absorbed decode equals the un-absorbed attention; YaRN's frequencies
and scale follow their formula; the dropless dispatch equals a loop over
the experts and drops nothing.  At the published sizes: layer 0 dense, the
rest MoE, 15.71 B parameters and 31,104 cache bytes a token.
"""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs.registry import get_config
from repro_torch.models import attention as attn
from repro_torch.models import lm, moe
from repro_torch.models.common import count_params, init_params
from repro_torch.runtime.serving import Request, ServingEngine

sys.path.insert(0, str(Path(__file__).resolve().parent))
import mla_reference as ref  # noqa: E402

TOL = 2e-5  # float32 round-off of sums over a few hundred terms, taken apart


def _cfg(**kw):
    return dataclasses.replace(get_config("deepseek-v2-lite-smoke"),
                               compute_dtype="float32", **kw)


def _params(cfg, seed=0):
    params = init_params(lm.lm_param_specs(cfg), seed=seed, device="cpu")
    # norm scales away from zero, so that every (1 + scale) counts
    for kind in params["blocks"]:
        for name in ("ln1", "ln2", "kv_norm"):
            params["blocks"][kind][name].normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed))
    return params


def _close(got, want, tol=TOL):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= tol * max(scale, 1.0), (err, scale)


def test_the_smoke_config_has_smoke_widths():
    cfg = _cfg()
    assert (cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim,
            cfg.v_head_dim) == (32, 8, 16, 16)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.num_shared_experts) == (4, 2, 2)
    assert cfg.pattern_for_layers == ("mla", "mla_moe", "mla_moe")


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_loss_and_gradients_equal_the_reference(seed):
    cfg = _cfg()
    params = _params(cfg, seed)
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    targets = torch.randint(0, cfg.vocab_size, (1, 32), generator=gen)
    want_logits = ref.logits(dataclasses.asdict(cfg), params, tokens[0])
    with torch.no_grad():
        x, _aux = lm.forward_hidden(cfg, params, tokens)
        got_logits = lm.logits_from_hidden(cfg, params, x)[0, :, :cfg.vocab_size]
    _close(got_logits, want_logits)

    leaves = [(path, t) for path, t in _leaves(params)]
    for _p, t in leaves:
        t.requires_grad_(True)
    loss, _m = lm.lm_loss(cfg, params, {"tokens": tokens, "targets": targets})
    grads = torch.autograd.grad(loss, [t for _p, t in leaves])
    want = ref.loss(dataclasses.asdict(cfg), params, tokens[0], targets[0])
    want_grads = torch.autograd.grad(want, [t for _p, t in leaves])
    assert abs(loss.item() - want.item()) <= TOL * abs(want.item())
    for (path, _t), g, w in zip(leaves, grads, want_grads):
        assert w.abs().max() > 0, path  # every leaf takes part
        _close(g, w, 1e-4)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


def test_serving_through_the_latent_cache_gives_the_full_forward_logits(monkeypatch):
    """Prefill then decode in the engine, two slots turned over by three
    requests: every decode logit equals the reference's at its position."""
    cfg = _cfg()
    params = _params(cfg, 3)
    engine = ServingEngine(cfg, params, max_slots=2, max_seq=40)
    assert set(engine.cache["mla_moe"]) == {"c", "k_pe"}
    seen = []
    decode = lm.decode_step

    def kept(*args, **kwargs):
        logits, cache = decode(*args, **kwargs)
        seen.append((engine.slot_rid.copy(), engine.lens.copy(), logits[:, 0].clone()))
        return logits, cache

    monkeypatch.setattr(lm, "decode_step", kept)
    gen = torch.Generator().manual_seed(5)
    prompts = {rid: torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for rid, n in ((0, 9), (1, 17), (2, 5))}
    for rid, prompt in prompts.items():
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=6))
    done = {c.rid: c for c in engine.run_until_drained()}
    assert sorted(done) == [0, 1, 2]
    checked = 0
    for rid, c in done.items():
        want = ref.logits(dataclasses.asdict(cfg), params, torch.tensor(c.tokens[:-1]))
        assert c.tokens[len(prompts[rid])] == int(want[len(prompts[rid]) - 1].argmax())
        for rids, lens, logits in seen:
            for slot in np.flatnonzero(rids == rid):
                _close(logits[slot, :cfg.vocab_size], want[lens[slot]])
                checked += 1
    assert checked == 3 * 5  # every decoded token of every request


def test_absorbed_decode_equals_the_unabsorbed_attention():
    cfg = _cfg()
    params = _params(cfg, 4)
    p = {k: v[0] for k, v in params["blocks"]["mla"].items() if not isinstance(v, dict)}
    x = torch.randn(2, 11, cfg.d_model, generator=torch.Generator().manual_seed(1))
    full, state = lm._mla_part(cfg, p, x, torch.arange(11), return_state=True)
    cache = {name: torch.zeros(2, 16, t.shape[-1]) for name, t in state.items()}
    for name, t in state.items():
        cache[name][:, :10] = t[:, :10]
    lens = torch.tensor([10, 10])
    last, _ = lm._mla_part(cfg, p, x[:, 10:], lens[:, None], cache=cache, cache_len=lens)
    _close(last[:, 0], full[:, 10], 1e-5)
    _close(cache["c"][:, 10], state["c"][:, 10], 1e-6)  # the decode wrote its latent


def test_yarn_frequencies_and_scale_follow_the_formula():
    rs = get_config("deepseek-v2-lite").rope_scaling
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m * m == pytest.approx(1.5896, abs=1e-4)
    assert attn.yarn_softmax_scale(192, rs) == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert attn.yarn_softmax_scale(192, None) == 192 ** -0.5
    dim, base = 64, 10000.0
    # the dimensions that turn 32 and 1 times over the 4096 trained positions
    lo = dim * math.log(4096 / (32 * 2 * math.pi)) / (2 * math.log(base))
    hi = dim * math.log(4096 / (1 * 2 * math.pi)) / (2 * math.log(base))
    lo, hi = math.floor(lo), math.ceil(hi)
    assert (lo, hi) == (10, 23)
    plain = base ** -(np.arange(0, dim, 2) / dim)
    ramp = np.clip((np.arange(dim // 2) - lo) / (hi - lo), 0, 1)
    want = plain / 40 * ramp + plain * (1 - ramp)
    got = attn.yarn_inv_freq(dim, base, rs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == pytest.approx(1.0) and got[-1] == pytest.approx(plain[-1] / 40, rel=1e-6)
    np.testing.assert_allclose(attn.yarn_inv_freq(8, base, rs).numpy(),
                               ref.yarn_inv_freq(8, base, rs).numpy(), rtol=1e-6)


def test_rope_pairs_rotate_consecutive_pairs():
    x = torch.randn(1, 5, 2, 8)
    out = attn.apply_rope_pairs(x, attn.rope_pairs_turns(8, 10000.0, None, torch.arange(5)))
    z = torch.view_as_complex(x.reshape(1, 5, 2, 4, 2))
    turn = torch.polar(torch.ones(5, 4), torch.arange(5.0)[:, None]
                       * 10000.0 ** -(torch.arange(0, 8, 2) / 8))
    _close(out, torch.view_as_real(z * turn[None, :, None]).flatten(-2), 1e-6)
    _close(out, ref.rope(x[0], {"rope_theta": 10000.0})[None], 1e-6)


def _moe_params(E, D, Fw, seed):
    g = torch.Generator().manual_seed(seed)
    return {"router": torch.randn(D, E, generator=g),
            "w_gate": torch.randn(E, D, Fw, generator=g) * D ** -0.5,
            "w_up": torch.randn(E, D, Fw, generator=g) * D ** -0.5,
            "w_down": torch.randn(E, Fw, D, generator=g) * Fw ** -0.5}


@pytest.mark.parametrize("tokens", [1, 7, 64, 300])
@pytest.mark.parametrize("norm", [False, True])
def test_dropless_moe_equals_a_loop_and_drops_nothing(tokens, norm):
    E, k, D, Fw = 8, 3, 16, 24
    p = _moe_params(E, D, Fw, tokens)
    x = torch.randn(2, tokens, D, generator=torch.Generator().manual_seed(9))
    out, aux = moe.moe_ffn(x, p, num_experts=E, top_k=k, compute_dtype=torch.float32,
                           dispatch="dropless", norm_topk_prob=norm)
    assert float(aux["moe_drop_fraction"]) == 0.0
    probs = torch.softmax(x @ p["router"], -1)
    top_p, top_e = moe.top_k_lowest_index_first(probs, k)
    if norm:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    want = torch.zeros_like(x)
    for b in range(2):
        for t in range(tokens):
            for j in range(k):
                e = int(top_e[b, t, j])
                h = x[b, t]
                y = (F.silu(h @ p["w_gate"][e]) * (h @ p["w_up"][e])) @ p["w_down"][e]
                want[b, t] += top_p[b, t, j] * y
    _close(out, want, 1e-5)


def test_a_dropless_row_does_not_depend_on_the_rest_of_the_batch():
    """No capacity: a row's tokens compete with no other row's, so a batch
    of rows, one of them routed wholly to one expert, gives each row what
    it gives alone."""
    E, D = 4, 8
    p = _moe_params(E, D, 8, 0)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(3, 10, D, generator=g)
    x[1] = torch.rand(10, D, generator=g) + 0.1
    p["router"][:, 1] += 10.0  # x > 0: expert 1 is every token's first choice in row 1
    kw = dict(num_experts=E, top_k=2, compute_dtype=torch.float32, dispatch="dropless")
    out, aux = moe.moe_ffn(x, p, **kw)
    assert float(aux["moe_drop_fraction"]) == 0.0
    for b in range(3):
        _close(out[b:b + 1], moe.moe_ffn(x[b:b + 1], p, aux=False, **kw)[0], 1e-6)


def test_two_shared_experts_equal_one_of_twice_the_width():
    """The shared expert's width is num_shared_experts x moe_d_ff: two
    SwiGLUs of width f sum to one of width 2f with their weights
    concatenated."""
    cfg = get_config("deepseek-v2-lite")
    specs = lm.lm_param_specs(dataclasses.replace(cfg, num_layers=2))["blocks"]["mla_moe"]
    assert specs["moe"]["shared_w_gate"].shape == (1, 2048, 2 * 1408)
    maverick = get_config("llama4-maverick-400b-a17b").smoke()
    mspecs = lm.lm_param_specs(maverick)["blocks"]["moe"]["moe"]
    assert mspecs["shared_w_gate"].shape[-1] == maverick.moe_d_ff  # one shared: as before
    E, D, Fw = 4, 16, 12
    p = _moe_params(E, D, Fw, 2)
    g = torch.Generator().manual_seed(3)
    halves = [{n: torch.randn(*shape, generator=g) * 0.2 for n, shape in
               (("w_gate", (D, Fw)), ("w_up", (D, Fw)), ("w_down", (Fw, D)))}
              for _ in range(2)]
    shared = {"shared_w_gate": torch.cat([h["w_gate"] for h in halves], 1),
              "shared_w_up": torch.cat([h["w_up"] for h in halves], 1),
              "shared_w_down": torch.cat([h["w_down"] for h in halves], 0)}
    x = torch.randn(1, 5, D, generator=g)
    kw = dict(num_experts=E, top_k=2, compute_dtype=torch.float32, dispatch="dropless")
    with_shared, _ = moe.moe_ffn(x, {**p, **shared}, **kw)
    routed, _ = moe.moe_ffn(x, p, **kw)
    two = sum((F.silu(x @ h["w_gate"]) * (x @ h["w_up"])) @ h["w_down"] for h in halves)
    _close(with_shared, routed + two, 1e-5)


def test_the_published_model_layers_size_and_cache():
    cfg = get_config("deepseek-v2-lite")
    assert cfg.pattern_for_layers == ("mla",) + ("mla_moe",) * 26
    # the checkpoint hash (the repr) holds the fields only the port has
    # where they are set, and leaves them out where not
    assert "kv_lora_rank=512" in repr(cfg) and "layer_prefix=('mla',)" in repr(cfg)
    assert "kv_lora_rank" not in repr(get_config("yi-9b"))
    specs = lm.lm_param_specs(cfg)
    assert {k: v["ln1"].shape[0] for k, v in specs["blocks"].items()} == {"mla": 1, "mla_moe": 26}
    assert "mlp" in specs["blocks"]["mla"] and "moe" in specs["blocks"]["mla_moe"]
    assert specs["blocks"]["mla"]["mlp"]["w_gate"].shape == (1, 2048, 10944)
    assert specs["blocks"]["mla_moe"]["wkv_b"].shape == (26, 512, 16 * 256)
    n = count_params(specs)
    assert 15.70e9 < n < 15.72e9  # 31.4 GB in bf16
    spec = lm.cache_spec(cfg, 1, 1)
    per_token = sum(math.prod(s[0]) * torch.empty((), dtype=s[1]).element_size()
                    for leaves in spec.values() for s in leaves.values())
    assert per_token == 27 * (512 + 64) * 2 == 31_104
    # per-head K and V would take 8.9 times as much
    assert 27 * 16 * (192 + 128) * 2 == 276_480


def test_the_embedding_is_not_scaled():
    cfg = _cfg()
    params = _params(cfg)
    tokens = torch.tensor([[3, 7]])
    assert torch.equal(lm._embed(cfg, params, tokens), params["embed"][tokens])
    scaled = dataclasses.replace(cfg, scale_embeddings=True)
    _close(lm._embed(scaled, params, tokens), params["embed"][tokens] * 8.0, 1e-7)
