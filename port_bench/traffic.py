"""The one generator of traffic: a mix file's parameters and ``--seed``
in, the cell's inputs out.

Training batches are the port's ``SyntheticLM`` stream, copied so that the
yardstick does not move with the program: ``tokens[step]`` drawn by numpy's
Philox keyed ``seed + (step << 20)``, targets the tokens shifted by one.

Served requests come in rounds of ``round`` requests.  Every round holds
the same multiset of prompt and output lengths (the quantiles of the
mix's distributions), so every seed sends the same work; the seed draws
each round's order of those lengths and the token ids, uniform over the
vocabulary, from Philox streams keyed by the seed and the round or the
request's index.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np


def train_batch(seed: int, step: int, batch: int, seq_len: int,
                vocab_size: int) -> dict[str, np.ndarray]:
    """Step ``step``'s batch: {"tokens", "targets"} int32 [batch, seq_len]."""
    gen = np.random.Generator(np.random.Philox(key=seed + (step << 20)))
    tokens = gen.integers(0, vocab_size, size=(batch, seq_len + 1),
                          dtype=np.int32)
    return {"tokens": tokens[:, :seq_len], "targets": tokens[:, 1:]}


def length_quantiles(spec: dict, n: int) -> list[int]:
    """``n`` lengths at the mid-quantiles (i + 1/2) / n of the mix's
    distribution, clipped to [min, max]: the multiset every round sends."""
    qs = [(i + 0.5) / n for i in range(n)]
    if spec["dist"] == "lognormal":
        normal = NormalDist()
        raw = [spec["median"] * math.exp(spec["sigma"] * normal.inv_cdf(q))
               for q in qs]
    elif spec["dist"] == "uniform":
        lo, hi = spec["min"], spec["max"]
        raw = [lo + q * (hi + 1 - lo) for q in qs]
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return [int(min(max(math.floor(x), spec["min"]), spec["max"])) for x in raw]


def _key(seed: int, index: int, stream: int) -> int:
    """A 128-bit Philox key: the seed in the high word, the index and the
    stream (1: a round's order, 2: a request's ids) in the low one."""
    return ((seed % 2**64) << 64) | (index << 8) | stream


@dataclass(frozen=True)
class Request:
    index: int
    prompt: list[int]
    max_new_tokens: int


class RequestStream:
    """Request ``j`` of a served mix under ``seed``: deterministic, and the
    same whatever order the requests are asked for; its lengths the same
    under every seed."""

    def __init__(self, mix: dict, seed: int, vocab_size: int):
        self.mix, self.seed, self.vocab_size = mix, seed, vocab_size
        self.round = mix["round"]
        self.prompt_lens = length_quantiles(mix["prompt"], self.round)
        self.output_lens = length_quantiles(mix["output"], self.round)
        self._orders: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _order(self, r: int) -> tuple[np.ndarray, np.ndarray]:
        if r not in self._orders:
            gen = np.random.Generator(np.random.Philox(
                key=_key(self.seed, r, 1)))
            self._orders[r] = (gen.permutation(self.round),
                               gen.permutation(self.round))
        return self._orders[r]

    def lengths(self, j: int) -> tuple[int, int]:
        r, i = divmod(j, self.round)
        p_order, o_order = self._order(r)
        return self.prompt_lens[p_order[i]], self.output_lens[o_order[i]]

    def request(self, j: int) -> Request:
        n_prompt, n_out = self.lengths(j)
        gen = np.random.Generator(np.random.Philox(key=_key(self.seed, j, 2)))
        ids = gen.integers(0, self.vocab_size, size=n_prompt, dtype=np.int64)
        return Request(j, ids.tolist(), n_out)
