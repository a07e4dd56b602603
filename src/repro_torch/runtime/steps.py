"""Step-function factories for decoder-only LMs (the serving half of the
JAX package's ``runtime/steps.py``).

* ``make_prefill_step`` — full-sequence forward to last-token logits;
* ``make_decode_step``  — one token against the KV cache.

PyTorch runs eagerly, so a factory returns a plain closure; there is no
``jit`` and no sharding.  Training, encoder-decoder models and the dry-run
structs are not ported yet (ROADMAP queue 1).
"""

from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as lm_mod


def _decoder_only(cfg: ModelConfig) -> None:
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            f"(ROADMAP queue 1, 'the other block families')")


def model_param_specs(cfg: ModelConfig):
    _decoder_only(cfg)
    return lm_mod.lm_param_specs(cfg)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    _decoder_only(cfg)

    def prefill_step(params, batch):
        x = lm_mod.forward_hidden(cfg, params, batch["tokens"])
        return lm_mod.logits_from_hidden(cfg, params, x[:, -1:])[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    _decoder_only(cfg)

    def decode_step(params, cache, tokens, cache_len):
        return lm_mod.decode_step(cfg, params, cache, tokens, cache_len)

    return decode_step
