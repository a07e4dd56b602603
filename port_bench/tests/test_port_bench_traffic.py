"""The traffic generator: the same seed gives the same inputs, two seeds
send the same work in another order, and every request fits the cache."""

import json

import numpy as np
import pytest

from port_bench import traffic
from port_bench.tests.small import ROOT
from repro_torch.data.pipeline import SyntheticLM

MIX = json.loads((ROOT / "port_bench" / "traffic" / "docs-closed-c64.json").read_text())
SEEDS = (0, 7, 2**31 + 11, 2**33 + 5)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_are_the_ports_philox_stream(seed):
    source = SyntheticLM(vocab_size=50304, seq_len=64, global_batch=2, seed=seed)
    for step in (0, 1, 5):
        ours = traffic.train_batch(seed, step, 2, 64, 50304)
        theirs = source.batch(step)
        assert np.array_equal(ours["tokens"], theirs["tokens"])
        assert np.array_equal(ours["targets"], theirs["targets"])


def test_length_quantiles_follow_the_mix():
    prompts = traffic.length_quantiles(MIX["prompt"], 64)
    assert min(prompts) >= 512 and max(prompts) == 3584
    assert sorted(prompts) == prompts and prompts[31] <= 2048 <= prompts[32]
    outs = traffic.length_quantiles(MIX["output"], 64)
    assert min(outs) == 16 and max(outs) == 64 and abs(np.mean(outs) - 40) < 0.5


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_are_deterministic_and_fit_the_cache(seed):
    a = traffic.RequestStream(MIX, seed, 64000)
    b = traffic.RequestStream(MIX, seed, 64000)
    for j in (0, 63, 64, 200):
        ra, rb = a.request(j), b.request(j)
        assert ra == rb
        assert len(ra.prompt) + ra.max_new_tokens + 1 <= MIX["max_seq"]
        assert 0 <= min(ra.prompt) and max(ra.prompt) < 64000


def test_every_round_sends_the_same_lengths_under_every_seed():
    a = traffic.RequestStream(MIX, 1, 64000)
    b = traffic.RequestStream(MIX, 2, 64000)
    for r in range(3):
        la = [a.lengths(r * 64 + i) for i in range(64)]
        lb = [b.lengths(r * 64 + i) for i in range(64)]
        assert sorted(p for p, _ in la) == a.prompt_lens
        for k in (0, 1):  # another order of the same prompt and output lengths
            assert sorted(x[k] for x in lb) == sorted(x[k] for x in la)
        assert lb != la
    assert a.request(5).prompt != b.request(5).prompt
