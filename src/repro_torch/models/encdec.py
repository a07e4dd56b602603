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
from repro_torch.models.lm import (
    _constrain,
    _dtype,
    _expand_kv,
    _heads,
    _remat,
    _residual,
    _seq_whole,
    _unstack,
    _write_kv,
    head_plan,
    run_block,
    spmd,
)


def _proj_specs(cfg: ModelConfig, n: int, tp: int):
    hp = head_plan(cfg, tp)
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


def encdec_param_specs(cfg: ModelConfig, tp: int = 1) -> dict:
    D = cfg.d_model
    ne, nd = cfg.encoder_layers, cfg.num_layers
    Vp = cfg.padded_vocab(tp)
    enc_block = {
        "ln1": ParamSpec((ne, D), ("layers", "d_model"), init="zeros"),
        "self": _proj_specs(cfg, ne, tp),
        "ln2": ParamSpec((ne, D), ("layers", "d_model"), init="zeros"),
        "mlp": mlp_specs(D, cfg.d_ff, ne),
    }
    dec_block = {
        "ln1": ParamSpec((nd, D), ("layers", "d_model"), init="zeros"),
        "self": _proj_specs(cfg, nd, tp),
        "ln_x": ParamSpec((nd, D), ("layers", "d_model"), init="zeros"),
        "cross": _proj_specs(cfg, nd, tp),
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


def _mha(cfg, p, xq, xkv, positions_q, positions_kv, *, causal, tp=1,
         rules=None, cache=None, cache_len=None, rope=True):
    """Attention for the encoder and the decoder, optionally against a cache.

    ``cache`` with ``k_static`` (cross-attention decode): the encoder's K/V,
    all of them visible.  ``cache`` with ``k``/``v`` (self-attention
    decode): the new token's K/V are written into these views at
    ``cache_len`` (an int) in place.  Returns (out [B, Sq, H * hd], state).
    """
    hp = head_plan(cfg, tp)
    H, KV, hd = hp["Hp"], hp["Kp"], cfg.head_dim
    B, Sq, _ = xq.shape
    cdt = _dtype(cfg.compute_dtype)
    q = _heads(rules, xq @ p["wq"].to(cdt), H, hd)
    if rope:
        q = attn_mod.apply_rope(q, positions_q, cfg.rope_theta)
    if cache is not None and "k_static" in cache:  # cross-attention decode
        out = attn_mod.decode_attention(q, cache["k_static"], cache["v_static"],
                                        cache["k_static"].shape[1])
        return out.reshape(B, Sq, H * hd), None
    k = _heads(rules, xkv @ p["wk"].to(cdt), KV, hd)
    v = _heads(rules, xkv @ p["wv"].to(cdt), KV, hd)
    if rope:
        k = attn_mod.apply_rope(k, positions_kv, cfg.rope_theta)
    if cache is not None:  # self-attention decode
        ck = _write_kv(cache["k"], k, cache_len, cache_len)
        cv = _write_kv(cache["v"], v, cache_len, cache_len)
        out = attn_mod.decode_attention(q, ck, cv, cache_len + Sq)
        return out.reshape(B, Sq, H * hd), {"k": ck, "v": cv}
    k_att, v_att = _expand_kv(cfg, hp, k, v, rules)
    out = attn_mod.attention(q, k_att, v_att, causal=causal)
    return out.reshape(B, Sq, H * hd), {"k": k, "v": v}


def _norm(cfg, rules, x, scale):
    return _seq_whole(rules, rms_norm(x, scale, cfg.norm_eps))


def _out(cdt, rules, x, a, w):
    """The residual plus an attention output's projection."""
    return x + _residual(rules, a @ w.to(cdt)).to(x.dtype)


def _mlp(cfg, cdt, rules, x, p):
    h = _norm(cfg, rules, x, p["ln2"])
    out = swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"], cdt)
    x = x + _residual(rules, out).to(x.dtype)
    return _constrain(rules, x, ("batch", "seq_sp", "d_model"))


def _enc_block(cfg, p, x, positions, tp=1, rules=None):
    cdt = _dtype(cfg.compute_dtype)
    h = _norm(cfg, rules, x, p["ln1"])
    a, _ = _mha(cfg, p["self"], h, h, positions, positions, causal=False,
                tp=tp, rules=rules)
    x = _out(cdt, rules, x, a, p["self"]["wo"])
    return _mlp(cfg, cdt, rules, x, p)


def _dec_block(cfg, p, x, enc_out, pos_q, pos_enc, tp=1, rules=None,
               cache=None, cache_len=None):
    """One decoder block; with ``cache`` ({"k", "v", "xk", "xv"} views of
    one layer) a decode step against it.  Returns (x, the self-attention
    K/V it wrote)."""
    cdt = _dtype(cfg.compute_dtype)
    h = _norm(cfg, rules, x, p["ln1"])
    self_cache = None if cache is None else {"k": cache["k"], "v": cache["v"]}
    a, kv = _mha(cfg, p["self"], h, h, pos_q, pos_q, causal=True, tp=tp,
                 rules=rules, cache=self_cache, cache_len=cache_len)
    x = _out(cdt, rules, x, a, p["self"]["wo"])
    h = _norm(cfg, rules, x, p["ln_x"])
    if cache is not None:
        xc = {"k_static": cache["xk"], "v_static": cache["xv"]}
        a, _ = _mha(cfg, p["cross"], h, None, pos_q, None, causal=False,
                    tp=tp, rules=rules, cache=xc, rope=False)
    else:
        a, _ = _mha(cfg, p["cross"], h, enc_out, pos_q, pos_enc, causal=False,
                    tp=tp, rules=rules, rope=False)
    x = _out(cdt, rules, x, a, p["cross"]["wo"])
    return _mlp(cfg, cdt, rules, x, p), kv


def _run_blocks(cfg, params, blocks, n, x, block):
    """``block(x, p)`` over the ``n`` stacked layers of ``blocks`` in order,
    each recomputed in the backward under ``cfg.remat`` and
    ``cfg.remat_policy`` (as ``lm``)."""
    remat = _remat(cfg, params)
    for p in _unstack(blocks, n):
        x = run_block(remat, block, x, p)
    return x


def encode(cfg: ModelConfig, params, frames: torch.Tensor, *, tp: int = 1,
           rules=None) -> torch.Tensor:
    """frames: [B, S_enc, D] stub embeddings -> encoder output."""
    with spmd(rules):
        x = frames.to(_dtype(cfg.compute_dtype))
        x = _constrain(rules, x, ("batch", "seq_sp", "d_model"))
        positions = torch.arange(x.shape[1], device=x.device)
        x = _run_blocks(cfg, params, params["encoder"]["blocks"],
                        cfg.encoder_layers, x,
                        lambda x, p: _enc_block(cfg, p, x, positions, tp, rules))
        return _norm(cfg, rules, x, params["encoder"]["final_norm"])


def _embed(cfg, params, tokens):
    return embed_tokens(params["embed"], tokens,
                        _dtype(cfg.compute_dtype)) * math.sqrt(cfg.d_model)


def decode_train(cfg: ModelConfig, params, tokens: torch.Tensor,
                 enc_out: torch.Tensor, *, tp: int = 1,
                 rules=None) -> torch.Tensor:
    """The decoder over a whole target sequence: final hidden states."""
    with spmd(rules):
        x = _embed(cfg, params, tokens)
        x = _constrain(rules, x, ("batch", "seq_sp", "d_model"))
        pos_q = torch.arange(tokens.shape[1], device=tokens.device)
        pos_enc = torch.arange(enc_out.shape[1], device=tokens.device)
        x = _run_blocks(
            cfg, params, params["decoder"]["blocks"], cfg.num_layers, x,
            lambda x, p: _dec_block(cfg, p, x, enc_out, pos_q, pos_enc, tp,
                                    rules)[0])
        return _norm(cfg, rules, x, params["decoder"]["final_norm"])


def encdec_loss(cfg: ModelConfig, params, batch, *, tp: int = 1, rules=None):
    """batch: frames [B, S_enc, D], tokens/targets [B, S_dec]."""
    with spmd(rules):
        enc_out = encode(cfg, params, batch["frames"], tp=tp, rules=rules)
        x = decode_train(cfg, params, batch["tokens"], enc_out, tp=tp,
                         rules=rules)
        ce = chunked_cross_entropy(
            x, params["lm_head"], batch["targets"],
            vocab_size=cfg.vocab_size, seq_chunk=cfg.loss_seq_chunk,
            compute_dtype=_dtype(cfg.compute_dtype),
        )
    return ce, {"ce_loss": ce, "loss": ce}


def init_encdec_cache(cfg: ModelConfig, params, enc_out: torch.Tensor,
                      max_seq: int, tp: int = 1) -> dict:
    """Self-attn cache + per-layer static cross K/V from encoder output."""
    hp = head_plan(cfg, tp)
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
                       cache_len: int, *, tp: int = 1, rules=None):
    """One decoder step against the cross/self caches.  tokens: [B, 1];
    cache_len: the tokens already in the cache (an int).  Returns (logits
    [B, 1, Vp], cache), the cache updated in place."""
    if cache_len + tokens.shape[1] > cache["k"].shape[2]:
        raise ValueError(f"cache of {cache['k'].shape[2]} positions is full")
    with spmd(rules):
        x = _embed(cfg, params, tokens)
        x = _constrain(rules, x, ("batch", "seq_sp", "d_model"))
        pos_q = torch.tensor([cache_len], device=tokens.device)
        blocks = _unstack(params["decoder"]["blocks"], cfg.num_layers)
        for i, p in enumerate(blocks):
            layer_cache = {name: leaf[i] for name, leaf in cache.items()}
            x, kv = _dec_block(cfg, p, x, None, pos_q, None, tp, rules,
                               cache=layer_cache, cache_len=cache_len)
            for name in ("k", "v"):
                if kv[name] is not layer_cache[name]:
                    cache[name][i] = kv[name]
        x = rms_norm(x, params["decoder"]["final_norm"], cfg.norm_eps)
        return lm_logits(x, params["lm_head"], _dtype(cfg.compute_dtype)), cache
