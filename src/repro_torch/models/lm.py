"""Decoder-only language model: the dense and recurrent paths of the JAX
package's ``models/lm.py`` at ``tp=1``.

The layer pattern of the config decides which blocks exist and in which
order.  This port runs the attention kinds ``attn`` (full causal),
``local`` (sliding window, ring-buffer cache) and ``global``, and the
Griffin recurrent kind ``rec`` (``models/recurrent.py``), each with a
SwiGLU MLP.  The other kinds (``moe``, ``mlstm``, ``slstm``) raise
``NotImplementedError``; ROADMAP queue 1 names the slice that ports them.

Parameters are the JAX package's tree: per block kind, each leaf is stacked
``[count, ...]`` over that kind's layers.  Layers run as a plain Python
loop (no scan).  Under autograd with ``cfg.remat`` (the default), each
block is recomputed in the backward (``torch.utils.checkpoint``): the JAX
package's ``remat_policy="nothing"``; its ``"dots"`` policy is not ported.  Every block calls the fused RMS norm twice
(``ln1``, ``ln2``) and the forward ends in ``final_norm``; the prompt's
attention goes through the flash-attention entry point and a ``rec``
block's recurrence through the RG-LRU scan's, in prefill and decode alike.
Decode writes the new token's K/V, and a ``rec`` layer's state (``h`` and
``conv``), into the cache in place and returns the same cache.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_size
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models.common import ParamSpec, fan_in_normal
from repro_torch.models.layers import (
    chunked_cross_entropy,
    embed_tokens,
    lm_logits,
    mlp_specs,
    rms_norm,
    swiglu,
)

ATTN_KINDS = ("attn", "local", "global")
_NOT_PORTED = {  # kind -> (blocks, the ROADMAP queue 1 item that ports them)
    "moe": ("MoE blocks", "the other block families"),
    "mlstm": ("xLSTM blocks", "the other block families"),
    "slstm": ("xLSTM blocks", "the other block families"),
}


def _check_kind(kind: str) -> None:
    if kind in ATTN_KINDS or kind == "rec":
        return
    if kind in _NOT_PORTED:
        blocks, item = _NOT_PORTED[kind]
        raise NotImplementedError(
            f"layer kind {kind!r}: {blocks} are not ported yet "
            f"(ROADMAP queue 1, '{item}')")
    raise ValueError(f"unknown layer kind {kind!r}")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Head-padding policy
# ---------------------------------------------------------------------------


def head_plan(cfg: ModelConfig, tp: int) -> dict:
    """Resolve the TP attention plan: padded head counts + grouping mode."""
    H, KV, g = cfg.num_heads, cfg.num_kv_heads, cfg.q_per_kv
    Hp = padded_size(H, tp) if tp > 1 else H
    if KV == 1:
        return {"Hp": Hp, "Kp": 1, "mode": "grouped"}
    if Hp % g == 0 and Hp // g >= KV:
        return {"Hp": Hp, "Kp": Hp // g, "mode": "grouped"}
    return {"Hp": Hp, "Kp": KV, "mode": "expand_kv"}


# ---------------------------------------------------------------------------
# Parameter specs (the JAX package's trees at tp=1)
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, n: int) -> dict:
    hp = head_plan(cfg, 1)
    D, hd = cfg.d_model, cfg.head_dim
    specs = {
        "ln1": ParamSpec((n, D), ("layers", "d_model"), init="zeros"),
        "wq": ParamSpec((n, D, hp["Hp"] * hd),
                        ("layers", "d_model_fsdp", "d_attn"),
                        stddev=fan_in_normal((D, 0))),
        "wk": ParamSpec((n, D, hp["Kp"] * hd),
                        ("layers", "d_model_fsdp", "d_kv_attn"),
                        stddev=fan_in_normal((D, 0))),
        "wv": ParamSpec((n, D, hp["Kp"] * hd),
                        ("layers", "d_model_fsdp", "d_kv_attn"),
                        stddev=fan_in_normal((D, 0))),
        "wo": ParamSpec((n, hp["Hp"] * hd, D),
                        ("layers", "d_attn", "d_model_fsdp"),
                        stddev=fan_in_normal((hp["Hp"] * hd, 0), fan_axis=0)),
    }
    if cfg.use_qk_norm:
        specs["q_norm"] = ParamSpec((n, hd), ("layers", None), init="zeros")
        specs["k_norm"] = ParamSpec((n, hd), ("layers", None), init="zeros")
    return specs


def _block_specs(cfg: ModelConfig, kind: str, n: int) -> dict:
    _check_kind(kind)
    if kind == "rec":
        specs = {
            "ln1": ParamSpec((n, cfg.d_model), ("layers", "d_model"),
                             init="zeros"),
            "rec": rec_mod.recurrent_block_specs(
                n, cfg.d_model, cfg.rnn_width or cfg.d_model,
                cfg.conv1d_width),
        }
    else:
        specs = _attn_specs(cfg, n)
    if cfg.d_ff > 0:
        specs["ln2"] = ParamSpec((n, cfg.d_model), ("layers", "d_model"),
                                 init="zeros")
        specs["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff, n)
    return specs


def lm_param_specs(cfg: ModelConfig) -> dict:
    Vp = cfg.padded_vocab(1)
    specs: dict[str, Any] = {
        "embed": ParamSpec((Vp, cfg.d_model), ("vocab", "d_model_fsdp"),
                           stddev=0.02),
        "final_norm": ParamSpec((cfg.d_model,), ("d_model",), init="zeros"),
        "blocks": {
            kind: _block_specs(cfg, kind, n)
            for kind, n in cfg.layer_counts().items()
        },
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec(
            (cfg.d_model, Vp), ("d_model_fsdp", "vocab"),
            stddev=fan_in_normal((cfg.d_model, Vp)),
        )
    return specs


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _attention_part(cfg, p, x, positions, *, kind, cache=None, cache_len=None,
                    return_state=False):
    """Shared attention sub-block. Returns (attn_out, state).

    ``cache`` (decode): {"k","v"} [B, Scache, KV, hd] views into the stacked
    cache; the new token's K/V are written into them in place.  ``cache_len``
    is an int (every row at the same length) or a [B] tensor (a length per
    serving slot).  ``local`` layers use a ring buffer of exactly the window
    size: keys carry RoPE for their true positions, so slot order does not
    matter and no window mask is needed.  ``return_state`` (prefill):
    returns this segment's fresh {"k","v"}.
    """
    hp = head_plan(cfg, 1)
    H, KV, hd = hp["Hp"], hp["Kp"], cfg.head_dim
    B, S, _D = x.shape
    cdt = _dtype(cfg.compute_dtype)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = (h @ p["wq"].to(cdt)).reshape(B, S, H, hd)
    k = (h @ p["wk"].to(cdt)).reshape(B, S, KV, hd)
    v = (h @ p["wv"].to(cdt)).reshape(B, S, KV, hd)
    if cfg.use_qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = attn_mod.apply_rope(q, positions, cfg.rope_theta)
    k = attn_mod.apply_rope(k, positions, cfg.rope_theta)

    state = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        size = ck.shape[1]
        if isinstance(cache_len, int):
            slot = cache_len % size if kind == "local" else cache_len
            ck[:, slot:slot + S] = k.to(ck.dtype)
            cv[:, slot:slot + S] = v.to(cv.dtype)
            valid = min(cache_len + S, size)
        else:
            slot = cache_len % size if kind == "local" else cache_len
            bidx = torch.arange(B, device=x.device)
            ck[bidx, slot] = k[:, 0].to(ck.dtype)
            cv[bidx, slot] = v[:, 0].to(cv.dtype)
            valid = torch.clamp(cache_len + S, max=size)
        out = attn_mod.decode_attention(q, ck, cv, valid)
        state = cache
    else:
        window = cfg.window_size if kind == "local" else 0
        out = attn_mod.attention(q, k, v, causal=True, window=window)
        if return_state:
            state = {"k": k, "v": v}
    out = out.reshape(B, S, H * hd) @ p["wo"].to(cdt)
    return out.to(x.dtype), state


def _recurrent_part(cfg, p, x, *, cache=None):
    """Recurrent sub-block.  Returns (rec_out, state).

    ``cache`` (decode): {"h", "conv"} views into the stacked cache; the new
    state is written into them in place.  Without it (a whole prompt), the
    state is the one the prompt leaves behind.
    """
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    out, state = rec_mod.recurrent_block(
        p["rec"], h, compute_dtype=_dtype(cfg.compute_dtype), state=cache)
    if cache is not None:
        for name, leaf in state.items():
            cache[name].copy_(leaf)
        state = cache
    return out, state


def apply_block(cfg, kind, p, x, positions, *, cache=None, cache_len=None,
                return_state=False):
    """One residual block of the given kind.  Returns (x, new_cache)."""
    _check_kind(kind)
    cdt = _dtype(cfg.compute_dtype)
    if kind == "rec":
        mix_out, state = _recurrent_part(cfg, p, x, cache=cache)
    else:
        mix_out, state = _attention_part(
            cfg, p, x, positions, kind=kind, cache=cache, cache_len=cache_len,
            return_state=return_state,
        )
    x = x + mix_out
    if cfg.d_ff > 0:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                       p["mlp"]["w_down"], cdt).to(x.dtype)
    return x, state


def _layer(tree, i: int):
    """Layer ``i`` of a stacked cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(cfg: ModelConfig, params, tokens):
    x = embed_tokens(params["embed"], tokens, _dtype(cfg.compute_dtype))
    return x * math.sqrt(cfg.d_model)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked parameter tree, as views: one unbind a
    leaf, whose gradient is one stack of the layers' gradients (indexing a
    layer instead would give each layer's gradient a zero-filled copy of
    the whole stack, summed over the layers)."""
    if isinstance(tree, dict):
        subs = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return tree.unbind(0)


def _layers(cfg: ModelConfig, params):
    """(kind, layer parameters, index within the kind) in model order."""
    stacks = {kind: _unstack(params["blocks"][kind], n)
              for kind, n in cfg.layer_counts().items()}
    counters = {k: 0 for k in stacks}
    for kind in cfg.pattern_for_layers:
        i = counters[kind]
        counters[kind] += 1
        yield kind, stacks[kind][i], i


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


def _remat(cfg: ModelConfig, params) -> bool:
    """Whether blocks are recomputed in the backward: under autograd only."""
    if not (cfg.remat and torch.is_grad_enabled() and _requires_grad(params)):
        return False
    if cfg.remat_policy != "nothing":
        raise NotImplementedError(
            f"remat_policy {cfg.remat_policy!r} is not ported; the port "
            f"recomputes whole blocks (\"nothing\")")
    return True


def forward_hidden(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward to the final hidden states [B, S, D]."""
    x = _embed(cfg, params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = _remat(cfg, params)
    for kind, p, _i in _layers(cfg, params):
        def block(x, p, kind=kind):
            return apply_block(cfg, kind, p, x, positions)[0]
        x = checkpoint(block, x, p, use_reentrant=False) if remat else block(x, p)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_head_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def lm_loss(cfg: ModelConfig, params, batch):
    """Mean next-token CE: (loss, {"ce_loss", "loss"}).  The MoE aux losses
    and the frontend stubs' ``extra_embeds`` wait for their block families
    (ROADMAP queue 1)."""
    if "extra_embeds" in batch:
        raise NotImplementedError(
            "extra_embeds (frontend stubs) are not ported yet "
            "(ROADMAP queue 1, 'the other block families')")
    x = forward_hidden(cfg, params, batch["tokens"])
    ce = chunked_cross_entropy(
        x, lm_head_weight(cfg, params), batch["targets"],
        vocab_size=cfg.vocab_size, seq_chunk=cfg.loss_seq_chunk,
        softcap=cfg.logit_softcap, compute_dtype=_dtype(cfg.compute_dtype),
    )
    return ce, {"ce_loss": ce, "loss": ce}


def logits_from_hidden(cfg, params, x):
    return lm_logits(x, lm_head_weight(cfg, params),
                     _dtype(cfg.compute_dtype), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# KV cache / decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int, dtype=None) -> dict:
    """Allocation-free cache description: leaf -> (shape, dtype, logical
    axes, fill value)."""
    if dtype is None:
        dtype = _dtype(cfg.compute_dtype)
    hp = head_plan(cfg, 1)
    width = cfg.rnn_width or cfg.d_model
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    spec: dict[str, Any] = {}
    for kind, n in cfg.layer_counts().items():
        _check_kind(kind)
        if kind == "rec":
            # The carried state h is float32 whatever the compute dtype.
            spec[kind] = {
                "h": ((n, batch, width), torch.float32,
                      ("layers", "batch", "rnn_state"), 0.0),
                "conv": ((n, batch, cfg.conv1d_width - 1, width), dtype,
                         ("layers", "batch", None, "rnn_state"), 0.0),
            }
            continue
        # ``local`` layers ring-buffer exactly ``window`` slots: every
        # resident token is then within the window of the current query.
        # The prompt's flash window keeps key k where k > q - window: the
        # same last ``window`` positions, so prefill and decode agree.
        seq = max_seq if kind != "local" else min(max_seq, cfg.window_size)
        shp = (n, batch, seq, hp["Kp"], cfg.head_dim)
        spec[kind] = {"k": (shp, dtype, kv_axes, 0.0),
                      "v": (shp, dtype, kv_axes, 0.0)}
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """K/V per attention kind and h/conv for ``rec``, stacked over that
    kind's layer count."""
    dev = resolve_device(device)
    return {
        kind: {name: torch.full(shp, fill, dtype=dt, device=dev)
               for name, (shp, dt, _axes, fill) in leaves.items()}
        for kind, leaves in cache_spec(cfg, batch, max_seq, dtype).items()
    }


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                cache_len):
    """One decode step.  tokens: [B, 1]; cache_len: int, or a [B] tensor of
    the tokens already in each row's cache.  Returns (logits [B, 1, Vp],
    cache), the cache updated in place."""
    x = _embed(cfg, params, tokens)
    if isinstance(cache_len, int):
        positions = torch.tensor([cache_len], device=tokens.device)
    else:
        positions = cache_len[:, None]  # [B, 1] per-slot positions
    for kind, p, i in _layers(cfg, params):
        x, _state = apply_block(cfg, kind, p, x, positions,
                                cache=_layer(cache[kind], i),
                                cache_len=cache_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(cfg, params, x), cache


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int):
    """Run the full prompt, returning (last-token logits, filled cache).

    Only ``attn`` and ``global`` layers cache ``max_seq`` positions, so
    only they refuse a longer prompt: ``local`` layers keep the last
    ``window`` positions of a ring and ``rec`` layers a fixed-size state.
    """
    B, S = tokens.shape
    if S > max_seq and {"attn", "global"} & set(cfg.layer_counts()):
        raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
    cache = init_cache(cfg, B, max_seq, device=tokens.device)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)
    for kind, p, i in _layers(cfg, params):
        x, st = apply_block(cfg, kind, p, x, positions, return_state=True)
        if kind == "rec":
            for name, leaf in st.items():
                cache[kind][name][i].copy_(leaf)
            continue
        for name in ("k", "v"):
            dst = cache[kind][name][i]  # [B, size, KV, hd]
            size = dst.shape[1]
            if kind == "local":
                nfit = min(S, size)
                slots = torch.arange(S - nfit, S, device=tokens.device) % size
                dst.index_copy_(1, slots, st[name][:, S - nfit:].to(dst.dtype))
            else:
                dst[:, :S] = st[name].to(dst.dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(cfg, params, x[:, -1:]), cache
