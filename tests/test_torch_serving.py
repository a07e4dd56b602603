"""The port's serving engine against the JAX package's, on the CPU.

Both engines get the same parameters (the JAX package's ``init_params`` with
random RMS-norm scales, carried across as numpy) and the same requests, and
run with ``compute_dtype="float32"``, as the JAX package's own serving tests
do: greedy tokens must then be equal, token for token.  The port's engine
must also equal its own offline greedy decode (``prefill`` +
``decode_step``), and the entry points must refuse to run without a card
unless asked for the CPU.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import lm as jax_lm
from repro.models.common import init_params as jax_init_params
from repro.runtime.serving import Request as JaxRequest
from repro.runtime.serving import ServingEngine as JaxServingEngine
from repro_torch import serve_pipeline
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import lm
from repro_torch.models.common import init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import serving
from repro_torch.runtime.serving import Request, ServingEngine

MAX_SEQ = 48


def _shared(name, seed=0):
    jcfg = dataclasses.replace(jax_get_config(name).smoke(), compute_dtype="float32")
    cfg = dataclasses.replace(get_config(name).smoke(), compute_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_lm.lm_param_specs(jcfg, 1), jax.random.PRNGKey(seed), jnp.float32))
    rng = np.random.default_rng(seed)
    for block in tree["blocks"].values():
        for key in ("ln1", "ln2", "q_norm", "k_norm"):
            if key in block:
                block[key] = (0.2 * rng.standard_normal(block[key].shape)
                              ).astype(np.float32)
        if "core" in block:  # nonzero xLSTM group-norm scales
            block["core"]["norm"] = (0.2 * rng.standard_normal(
                block["core"]["norm"].shape)).astype(np.float32)
        if "rec" in block:  # nonzero RG-LRU gate biases
            gates = block["rec"]["rglru"]
            for key in ("b_a", "b_x"):
                gates[key] = (0.2 * rng.standard_normal(gates[key].shape)
                              ).astype(np.float32)
    tree["final_norm"] = (0.2 * rng.standard_normal(tree["final_norm"].shape)
                          ).astype(np.float32)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _requests(vocab, n=7, seed=1):
    rng = np.random.default_rng(seed)
    return [(rid, list(map(int, rng.integers(0, vocab, int(rng.integers(3, 12))))),
             int(rng.integers(2, 7))) for rid in range(n)]


@pytest.mark.parametrize("name", ["yi-9b", "gemma3-4b", "recurrentgemma-2b",
                                  "olmoe-1b-7b", "xlstm-350m"])
def test_engine_tokens_equal_the_jax_engine(name):
    jcfg, cfg, jp, tp = _shared(name)
    reqs = _requests(cfg.vocab_size)
    jeng = JaxServingEngine(jcfg, jp, max_slots=3, max_seq=MAX_SEQ)
    teng = ServingEngine(cfg, tp, max_slots=3, max_seq=MAX_SEQ)
    for rid, prompt, n_new in reqs:
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n_new))
        teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
    jdone = sorted(jeng.shutdown(), key=lambda c: c.rid)
    tdone = sorted(teng.shutdown(), key=lambda c: c.rid)
    assert [(c.rid, c.prompt_len, c.tokens) for c in tdone] == \
           [(c.rid, c.prompt_len, c.tokens) for c in jdone]
    # the demand-driven schedule is the same: each slot served as many
    assert ({t.node_id: t.items for t in teng.timing.nodes} ==
            {t.node_id: t.items for t in jeng.timing.nodes})


@pytest.mark.parametrize("name", ["yi-9b", "recurrentgemma-2b"])
def test_run_until_drained_equals_the_jax_engine(name):
    """Both engines drain a first batch of requests, take a second batch
    while still open, and drain again: the completions are equal token for
    token, in order, after each drain."""
    jcfg, cfg, jp, tp = _shared(name, seed=5)
    reqs = _requests(cfg.vocab_size, n=8, seed=6)
    jeng = JaxServingEngine(jcfg, jp, max_slots=3, max_seq=MAX_SEQ)
    teng = ServingEngine(cfg, tp, max_slots=3, max_seq=MAX_SEQ)
    for batch in (reqs[:5], reqs[5:]):
        for rid, prompt, n_new in batch:
            jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n_new))
            teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
        jdone, tdone = jeng.run_until_drained(), teng.run_until_drained()
        assert [(c.rid, c.prompt_len, c.tokens) for c in tdone] == \
               [(c.rid, c.prompt_len, c.tokens) for c in jdone]
        assert not teng.queue and not (teng.slot_rid >= 0).any()
    assert sorted(c.rid for c in tdone) == list(range(8))


@pytest.mark.parametrize("name", ["yi-9b", "recurrentgemma-2b"])
def test_completions_time_the_queue_the_first_token_and_the_whole(name, monkeypatch):
    """On a fake clock (a millisecond a read, a second between steps):
    requests submitted while every slot is busy wait in the queue, every
    completion has ``queued_s`` <= ``ttft_s`` <= ``latency_s``, all from
    its submission, and the tokens still equal the JAX engine's."""
    now = [0.0]

    def perf_counter():
        now[0] += 1e-3
        return now[0]

    monkeypatch.setattr(serving, "time", SimpleNamespace(perf_counter=perf_counter))
    jcfg, cfg, jp, tp = _shared(name, seed=7)
    reqs = _requests(cfg.vocab_size, n=7, seed=8)
    reqs[:3] = [(rid, prompt, 6) for rid, prompt, _n in reqs[:3]]  # busy 5 ticks
    jeng = JaxServingEngine(jcfg, jp, max_slots=3, max_seq=MAX_SEQ)
    teng = ServingEngine(cfg, tp, max_slots=3, max_seq=MAX_SEQ)
    for rid, prompt, n_new in reqs:
        jeng.submit(JaxRequest(rid=rid, prompt=prompt, max_new_tokens=n_new))
    for rid, prompt, n_new in reqs[:3]:
        teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
    teng.step()
    assert (teng.slot_rid >= 0).all()
    for rid, prompt, n_new in reqs[3:]:  # every slot busy
        teng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
    while teng.queue or (teng.slot_rid >= 0).any():
        now[0] += 1.0
        teng.step()
    done = sorted(teng.completions, key=lambda c: c.rid)
    assert [(c.rid, c.prompt_len, c.tokens) for c in done] == \
           [(c.rid, c.prompt_len, c.tokens)
            for c in sorted(jeng.shutdown(), key=lambda c: c.rid)]
    assert all(c.queued_s < 0.5 for c in done[:3])  # admitted at once
    assert all(c.queued_s > 0.5 for c in done[3:])  # waited a step or more
    assert all(0 < c.queued_s < c.ttft_s < c.latency_s for c in done)
    assert all(c.ttft_s - c.queued_s < 0.5 for c in done)  # in the same step
    # the step that admits a request gives its first two tokens (the
    # prefill's, then its tick's), each later step (a second) one more
    assert all(round(c.latency_s - c.ttft_s) == len(c.tokens) - c.prompt_len - 2
               for c in done)


@pytest.mark.parametrize("name", ["yi-9b", "recurrentgemma-2b", "olmoe-1b-7b",
                                  "llama4-maverick-400b-a17b", "xlstm-350m"])
def test_engine_equals_offline_greedy_decode(name):
    """Slots are spliced in place (K/V; h/conv for rec; the xLSTM states)
    and decoded together; each completion equals its own batch-1 decode."""
    _, cfg, _, tp = _shared(name, seed=3)
    eng = ServingEngine(cfg, tp, max_slots=2, max_seq=MAX_SEQ)
    for rid, prompt, n_new in _requests(cfg.vocab_size, n=5, seed=4):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n_new))
    done = eng.shutdown()
    assert len(done) == 5
    for c in done:
        prompt, gen = c.tokens[: c.prompt_len], c.tokens[c.prompt_len:]
        assert gen == serve_pipeline.offline_greedy(cfg, tp, prompt, len(gen),
                                                    MAX_SEQ), f"rid {c.rid}"


def test_serving_engine_demand_driven_idle_slots():
    """More requests than slots: every slot processes some work (the onrl
    server answers whichever slot requests next)."""
    cfg = dataclasses.replace(get_config("yi-9b").smoke(), compute_dtype="float32")
    params = init_params(lm.lm_param_specs(cfg), 0, "cpu")
    eng = ServingEngine(cfg, params, max_slots=3, max_seq=MAX_SEQ)
    for rid in range(9):
        eng.submit(Request(rid=rid, prompt=[1, 2, 3], max_new_tokens=3))
    done = eng.shutdown()
    assert sorted(c.rid for c in done) == list(range(9))
    items = {t.node_id: t.items for t in eng.timing.nodes
             if t.node_id.startswith("slot")}
    assert all(v > 0 for v in items.values())
    assert sum(items.values()) == 9
    with pytest.raises(RuntimeError, match="shut down"):
        eng.submit(Request(rid=9, prompt=[1], max_new_tokens=1))


@pytest.mark.parametrize("arch", ["yi-9b", "recurrentgemma-2b", "olmoe-1b-7b",
                                  "xlstm-350m"])
def test_cli_and_pipeline_run_on_the_cpu_when_asked(capsys, arch):
    done = serve_cli.main(["--arch", arch, "--device", "cpu",
                           "--requests", "5", "--max-new", "4"])
    assert sorted(c.rid for c in done) == list(range(5))
    assert all(len(c.tokens) - c.prompt_len == 4 for c in done)
    assert len(serve_pipeline.main(["--device", "cpu"])) == 10
    out = capsys.readouterr().out
    assert "served 5 requests" in out and "engine output == offline greedy" in out


@pytest.mark.parametrize("call", [
    lambda: serve_cli.main(["--arch", "yi-9b"]),
    lambda: serve_pipeline.main([]),
    lambda: init_params(lm.lm_param_specs(get_config("yi-9b-smoke"))),
    lambda: params_from_numpy({"embed": np.zeros((2, 2), np.float32)}),
    lambda: lm.init_cache(get_config("yi-9b-smoke"), 1, 8),
], ids=["serve_cli", "serve_pipeline", "init_params", "params_from_numpy",
        "init_cache"])
def test_entry_points_need_the_card_unless_asked_for_the_cpu(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


def test_engine_refuses_an_encoder_decoder_model():
    """As the JAX engine does: the decoder-only engine has no frames."""
    cfg = get_config("seamless-m4t-large-v2").smoke()
    with pytest.raises(NotImplementedError, match="decoder-only"):
        ServingEngine(cfg, {"embed": torch.zeros(2, 2)})
