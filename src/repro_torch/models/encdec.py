"""Encoder-decoder transformer backbone (seamless-m4t style), the JAX
package's ``models/encdec.py`` at ``tp=1``.

The audio modality frontend is a stub: the caller supplies precomputed
frame embeddings [B, S_enc, D].  The backbone is real: a bidirectional
encoder stack and a causal decoder with cross-attention, sharing the layer
machinery of ``models.lm``.  A whole sequence's attention goes through the
flash-attention entry point: the encoder's non-causal, the decoder's
self-attention causal, and the cross-attention non-causal over the
encoder's S_enc keys; each block's RMS norms through the fused kernel's.
A decode step's attention stays plain, as in the JAX package.

Decode state = per-layer self-attention KV cache + the (static) per-layer
cross-attention K/V computed once from the encoder output.  A decode step
writes the new token's K/V into the cache in place and returns the same
cache.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import ParamSpec, fan_in_normal
from repro_torch.models.layers import (
    chunked_cross_entropy,
    embed_tokens,
    lm_logits,
    mlp_specs,
    rms_norm,
    swiglu,
)
from repro_torch.models.lm import _dtype, _remat, _unstack, head_plan


def _proj_specs(cfg: ModelConfig, n: int):
    hp = head_plan(cfg, 1)
    D, hd = cfg.d_model, cfg.head_dim
    return {
        "wq": ParamSpec((n, D, hp["Hp"] * hd), ("layers", "d_model_fsdp", "d_attn"),
                        stddev=fan_in_normal((D, 0))),
        "wk": ParamSpec((n, D, hp["Kp"] * hd), ("layers", "d_model_fsdp", "d_kv_attn"),
                        stddev=fan_in_normal((D, 0))),
        "wv": ParamSpec((n, D, hp["Kp"] * hd), ("layers", "d_model_fsdp", "d_kv_attn"),
                        stddev=fan_in_normal((D, 0))),
        "wo": ParamSpec((n, hp["Hp"] * hd, D), ("layers", "d_attn", "d_model_fsdp"),
                        stddev=fan_in_normal((hp["Hp"] * hd, 0), fan_axis=0)),
    }


def encdec_param_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    ne, nd = cfg.encoder_layers, cfg.num_layers
    Vp = cfg.padded_vocab(1)
    enc_block = {
        "ln1": ParamSpec((ne, D), ("layers", "d_model"), init="zeros"),
        "self": _proj_specs(cfg, ne),
        "ln2": ParamSpec((ne, D), ("layers", "d_model"), init="zeros"),
        "mlp": mlp_specs(D, cfg.d_ff, ne),
    }
    dec_block = {
        "ln1": ParamSpec((nd, D), ("layers", "d_model"), init="zeros"),
        "self": _proj_specs(cfg, nd),
        "ln_x": ParamSpec((nd, D), ("layers", "d_model"), init="zeros"),
        "cross": _proj_specs(cfg, nd),
        "ln2": ParamSpec((nd, D), ("layers", "d_model"), init="zeros"),
        "mlp": mlp_specs(D, cfg.d_ff, nd),
    }
    return {
        "embed": ParamSpec((Vp, D), ("vocab", "d_model_fsdp"), stddev=0.02),
        "encoder": {"blocks": enc_block,
                    "final_norm": ParamSpec((D,), ("d_model",), init="zeros")},
        "decoder": {"blocks": dec_block,
                    "final_norm": ParamSpec((D,), ("d_model",), init="zeros")},
        "lm_head": ParamSpec((D, Vp), ("d_model_fsdp", "vocab"),
                             stddev=fan_in_normal((D, Vp))),
    }


def _mha(cfg, p, xq, xkv, positions_q, positions_kv, *, causal,
         cache=None, cache_len=None, rope=True):
    """Attention for the encoder and the decoder, optionally against a cache.

    ``cache`` with ``k_static`` (cross-attention decode): the encoder's K/V,
    all of them visible.  ``cache`` with ``k``/``v`` (self-attention
    decode): the new token's K/V are written into these views at
    ``cache_len`` (an int) in place.  Returns (out [B, Sq, H * hd], state).
    """
    hp = head_plan(cfg, 1)
    H, KV, hd = hp["Hp"], hp["Kp"], cfg.head_dim
    B, Sq, _ = xq.shape
    cdt = _dtype(cfg.compute_dtype)
    q = (xq @ p["wq"].to(cdt)).reshape(B, Sq, H, hd)
    if rope:
        q = attn_mod.apply_rope(q, positions_q, cfg.rope_theta)
    if cache is not None and "k_static" in cache:  # cross-attention decode
        out = attn_mod.decode_attention(q, cache["k_static"], cache["v_static"],
                                        cache["k_static"].shape[1])
        return out.reshape(B, Sq, H * hd), None
    k = (xkv @ p["wk"].to(cdt)).reshape(B, -1, KV, hd)
    v = (xkv @ p["wv"].to(cdt)).reshape(B, -1, KV, hd)
    if rope:
        k = attn_mod.apply_rope(k, positions_kv, cfg.rope_theta)
    if cache is not None:  # self-attention decode
        ck, cv = cache["k"], cache["v"]
        ck[:, cache_len:cache_len + Sq] = k.to(ck.dtype)
        cv[:, cache_len:cache_len + Sq] = v.to(cv.dtype)
        out = attn_mod.decode_attention(q, ck, cv, cache_len + Sq)
        return out.reshape(B, Sq, H * hd), cache
    out = attn_mod.attention(q, k, v, causal=causal)
    return out.reshape(B, Sq, H * hd), {"k": k, "v": v}


def _enc_block(cfg, p, x, positions):
    cdt = _dtype(cfg.compute_dtype)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, _ = _mha(cfg, p["self"], h, h, positions, positions, causal=False)
    x = x + (a @ p["self"]["wo"].to(cdt)).to(x.dtype)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"],
                      cdt).to(x.dtype)


def _dec_block(cfg, p, x, enc_out, pos_q, pos_enc, cache=None, cache_len=None):
    """One decoder block; with ``cache`` ({"k", "v", "xk", "xv"} views of
    one layer) a decode step against it."""
    cdt = _dtype(cfg.compute_dtype)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    self_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    a, _kv = _mha(cfg, p["self"], h, h, pos_q, pos_q, causal=True,
                  cache=self_cache, cache_len=cache_len)
    x = x + (a @ p["self"]["wo"].to(cdt)).to(x.dtype)
    h = rms_norm(x, p["ln_x"], cfg.norm_eps)
    if cache is not None:
        xc = {"k_static": cache["xk"], "v_static": cache["xv"]}
        a, _ = _mha(cfg, p["cross"], h, None, pos_q, None, causal=False,
                    cache=xc, rope=False)
    else:
        a, _ = _mha(cfg, p["cross"], h, enc_out, pos_q, pos_enc, causal=False,
                    rope=False)
    x = x + (a @ p["cross"]["wo"].to(cdt)).to(x.dtype)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"],
                      cdt).to(x.dtype)


def _run_blocks(cfg, params, blocks, n, x, block):
    """``block(x, p)`` over the ``n`` stacked layers of ``blocks`` in order,
    each recomputed in the backward under ``cfg.remat`` (as ``lm``)."""
    remat = _remat(cfg, params)
    for p in _unstack(blocks, n):
        x = checkpoint(block, x, p, use_reentrant=False) if remat else block(x, p)
    return x


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: [B, S_enc, D] stub embeddings -> encoder output."""
    x = frames.to(_dtype(cfg.compute_dtype))
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_blocks(cfg, params, params["encoder"]["blocks"], cfg.encoder_layers, x,
                    lambda x, p: _enc_block(cfg, p, x, positions))
    return rms_norm(x, params["encoder"]["final_norm"], cfg.norm_eps)


def _embed(cfg, params, tokens):
    return embed_tokens(params["embed"], tokens,
                        _dtype(cfg.compute_dtype)) * math.sqrt(cfg.d_model)


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder over a whole target sequence: final hidden states."""
    x = _embed(cfg, params, tokens)
    pos_q = torch.arange(tokens.shape[1], device=tokens.device)
    pos_enc = torch.arange(enc_out.shape[1], device=tokens.device)
    x = _run_blocks(cfg, params, params["decoder"]["blocks"], cfg.num_layers, x,
                    lambda x, p: _dec_block(cfg, p, x, enc_out, pos_q, pos_enc))
    return rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)


def encdec_loss(cfg: ModelConfig, params, batch):
    """batch: frames [B, S_enc, D], tokens/targets [B, S_dec]."""
    enc_out = encode(cfg, params, batch["frames"])
    x = decode_train(cfg, params, batch["tokens"], enc_out)
    ce = chunked_cross_entropy(
        x, params["lm_head"], batch["targets"],
        vocab_size=cfg.vocab_size, seq_chunk=cfg.loss_seq_chunk,
        compute_dtype=_dtype(cfg.compute_dtype),
    )
    return ce, {"ce_loss": ce, "loss": ce}


def init_encdec_cache(cfg: ModelConfig, params, enc_out: torch.Tensor,
                      max_seq: int) -> dict:
    """Self-attn cache + per-layer static cross K/V from encoder output."""
    hp = head_plan(cfg, 1)
    B = enc_out.shape[0]
    cdt = _dtype(cfg.compute_dtype)
    nd = cfg.num_layers
    xk, xv = [], []
    for p in _unstack(params["decoder"]["blocks"], nd):
        xk.append((enc_out @ p["cross"]["wk"].to(cdt)).reshape(
            B, -1, hp["Kp"], cfg.head_dim))
        xv.append((enc_out @ p["cross"]["wv"].to(cdt)).reshape(
            B, -1, hp["Kp"], cfg.head_dim))
    shape = (nd, B, max_seq, hp["Kp"], cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cdt, device=enc_out.device),
        "v": torch.zeros(shape, dtype=cdt, device=enc_out.device),
        "xk": torch.stack(xk),
        "xv": torch.stack(xv),
    }


def encdec_decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                       cache_len: int):
    """One decoder step against the cross/self caches.  tokens: [B, 1];
    cache_len: the tokens already in the cache (an int).  Returns (logits
    [B, 1, Vp], cache), the cache updated in place."""
    if cache_len + tokens.shape[1] > cache["k"].shape[2]:
        raise ValueError(f"cache of {cache['k'].shape[2]} positions is full")
    x = _embed(cfg, params, tokens)
    pos_q = torch.tensor([cache_len], device=tokens.device)
    for i, p in enumerate(_unstack(params["decoder"]["blocks"], cfg.num_layers)):
        layer_cache = {name: leaf[i] for name, leaf in cache.items()}
        x = _dec_block(cfg, p, x, None, pos_q, None, cache=layer_cache,
                       cache_len=cache_len)
    x = rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)
    return lm_logits(x, params["lm_head"], _dtype(cfg.compute_dtype)), cache
