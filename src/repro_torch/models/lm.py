"""Decoder-only language model: every block family of the JAX package's
``models/lm.py`` at ``tp=1``.

The layer pattern of the config decides which blocks exist and in which
order: the attention kinds ``attn`` (full causal), ``local`` (sliding
window, ring-buffer cache), ``global`` and ``moe`` (attention with a
mixture-of-experts FFN, ``models/moe.py``), each but ``moe`` with a SwiGLU
MLP where ``d_ff > 0``; the Griffin recurrent kind ``rec``
(``models/recurrent.py``) with its MLP; and the xLSTM kinds ``mlstm`` and
``slstm`` (``models/xlstm.py``), one RMS norm and no MLP.

Parameters are the JAX package's tree: per block kind, each leaf is stacked
``[count, ...]`` over that kind's layers.  Layers run as a plain Python
loop (no scan).  Under autograd with ``cfg.remat`` (the default), each
block is recomputed in the backward (``torch.utils.checkpoint``): the JAX
package's ``remat_policy="nothing"``; its ``"dots"`` policy is not ported.
Every block calls the fused RMS norm for ``ln1`` (and ``ln2`` where it has
one) and the forward ends in ``final_norm``; the prompt's attention goes
through the flash-attention entry point and a ``rec`` block's recurrence
through the RG-LRU scan's, in prefill and decode alike.  Decode writes the
new token's K/V, and a recurrent layer's state, into the cache in place
and returns the same cache.  ``forward_hidden`` returns the MoE blocks'
aux losses summed in layer order; ``lm_loss`` weighs them in.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_size
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.common import ParamSpec, fan_in_normal
from repro_torch.models.layers import (
    chunked_cross_entropy,
    embed_tokens,
    lm_logits,
    mlp_specs,
    rms_norm,
    swiglu,
)

ATTN_KINDS = ("attn", "local", "global", "moe")
STATE_KINDS = ("rec", "mlstm", "slstm")
MOE_AUX = ("moe_lb_loss", "moe_z_loss", "moe_drop_fraction")


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
    D = cfg.d_model
    if kind in ("mlstm", "slstm"):
        core = (xlstm_mod.mlstm_block_specs if kind == "mlstm"
                else xlstm_mod.slstm_block_specs)
        return {"ln1": ParamSpec((n, D), ("layers", "d_model"), init="zeros"),
                "core": core(n, D, cfg.num_heads, cfg.head_dim)}
    if kind == "rec":
        specs = {
            "ln1": ParamSpec((n, D), ("layers", "d_model"), init="zeros"),
            "rec": rec_mod.recurrent_block_specs(
                n, D, cfg.rnn_width or D, cfg.conv1d_width),
        }
    elif kind in ATTN_KINDS:
        specs = _attn_specs(cfg, n)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind == "moe":
        specs["ln2"] = ParamSpec((n, D), ("layers", "d_model"), init="zeros")
        specs["moe"] = moe_mod.moe_param_specs(
            n, D, cfg.moe_d_ff, cfg.num_experts, cfg.num_shared_experts,
            cfg.moe_d_ff)
    elif cfg.d_ff > 0:
        specs["ln2"] = ParamSpec((n, D), ("layers", "d_model"), init="zeros")
        specs["mlp"] = mlp_specs(D, cfg.d_ff, n)
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
    returns this segment's fresh {"k","v"}.  Everything after ``ln1`` is
    the profiler span ``attention``.
    """
    hp = head_plan(cfg, 1)
    H, KV, hd = hp["Hp"], hp["Kp"], cfg.head_dim
    B, S, _D = x.shape
    cdt = _dtype(cfg.compute_dtype)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    with record_function("attention"):
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
            slot = cache_len % size if kind == "local" else cache_len
            if isinstance(cache_len, int):
                ck[:, slot:slot + S] = k.to(ck.dtype)
                cv[:, slot:slot + S] = v.to(cv.dtype)
                valid = min(cache_len + S, size)
            else:
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


def _cache_kind_state(cache_slice, kind):
    """A recurrent layer's cache leaves as its block takes them."""
    if cache_slice is None or kind == "rec":
        return cache_slice
    if kind == "mlstm":
        return (cache_slice["conv"],
                (cache_slice["C"], cache_slice["n"], cache_slice["m"]))
    return tuple(cache_slice[name] for name in ("c", "n", "m", "h"))


def _state_to_cache(state, kind) -> dict:
    """A recurrent block's new state as its cache leaves."""
    if kind == "rec":
        return state
    if kind == "mlstm":
        conv, (C, n, m) = state
        return {"conv": conv, "C": C, "n": n, "m": m}
    return dict(zip(("c", "n", "m", "h"), state))


def _state_part(cfg, kind, p, x, *, cache=None):
    """Recurrent sub-block (``rec``, ``mlstm`` or ``slstm``).  Returns
    (out, state as cache leaves).

    ``cache`` (decode): that layer's cache leaves (views into the stacked
    cache); the new state is written into them in place.  Without it (a
    whole prompt), the state is the one the prompt leaves behind.
    """
    cdt = _dtype(cfg.compute_dtype)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    state = _cache_kind_state(cache, kind)
    if kind == "rec":
        out, new = rec_mod.recurrent_block(p["rec"], h, compute_dtype=cdt,
                                           state=state)
    elif kind == "mlstm":
        out, new = xlstm_mod.mlstm_block(p["core"], h, heads=cfg.num_heads,
                                         compute_dtype=cdt, state=state)
    else:
        out, new = xlstm_mod.slstm_block(p["core"], h, heads=cfg.num_heads,
                                         compute_dtype=cdt, state=state)
    new = _state_to_cache(new, kind)
    if cache is not None:
        for name, leaf in new.items():
            cache[name].copy_(leaf)
        new = cache
    return out, new


def apply_block(cfg, kind, p, x, positions, *, cache=None, cache_len=None,
                return_state=False):
    """One residual block of the given kind.  Returns (x, new_cache, aux):
    ``aux`` holds a ``moe`` block's aux losses, else it is empty."""
    cdt = _dtype(cfg.compute_dtype)
    if kind in ATTN_KINDS:
        mix_out, state = _attention_part(
            cfg, p, x, positions, kind=kind, cache=cache, cache_len=cache_len,
            return_state=return_state,
        )
    elif kind in STATE_KINDS:
        mix_out, state = _state_part(cfg, kind, p, x, cache=cache)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    x = x + mix_out
    aux: dict[str, torch.Tensor] = {}
    if kind == "moe":
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        moe_out, aux = moe_mod.moe_ffn(
            h, p["moe"], num_experts=cfg.num_experts,
            top_k=cfg.experts_per_token, capacity_factor=cfg.capacity_factor,
            compute_dtype=cdt, dispatch=cfg.moe_dispatch)
        x = x + moe_out
    elif "mlp" in p:
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                       p["mlp"]["w_down"], cdt).to(x.dtype)
    return x, state, aux


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


def forward_hidden(cfg: ModelConfig, params, tokens: torch.Tensor,
                   extra_embeds: torch.Tensor | None = None):
    """Full-sequence forward to (final hidden states [B, S, D], aux).

    ``extra_embeds`` ([B, F, D]) replace the first F token positions (the
    VLM patch / audio frame stub inputs), unscaled.  ``aux`` sums the MoE
    blocks' aux losses in layer order (empty without ``moe`` layers).
    """
    x = _embed(cfg, params, tokens)
    if extra_embeds is not None:
        F = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(x.dtype), x[:, F:]], dim=1)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = _remat(cfg, params)
    aux_total = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
                  for k in MOE_AUX} if "moe" in cfg.layer_counts() else {})
    for kind, p, _i in _layers(cfg, params):
        def block(x, p, kind=kind):
            x, _state, aux = apply_block(cfg, kind, p, x, positions)
            return x, aux
        x, aux = (checkpoint(block, x, p, use_reentrant=False) if remat
                  else block(x, p))
        for k, v in aux.items():
            aux_total[k] = aux_total[k] + v
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux_total


def lm_head_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def lm_loss(cfg: ModelConfig, params, batch):
    """Mean CE over next-token targets + MoE aux losses: (loss, metrics)
    with ``ce_loss``, ``loss`` and, for MoE models, the three aux values.
    ``batch["extra_embeds"]``, where present, is the frontend stub's
    prefix."""
    x, aux = forward_hidden(cfg, params, batch["tokens"],
                            extra_embeds=batch.get("extra_embeds"))
    ce = chunked_cross_entropy(
        x, lm_head_weight(cfg, params), batch["targets"],
        vocab_size=cfg.vocab_size, seq_chunk=cfg.loss_seq_chunk,
        softcap=cfg.logit_softcap, compute_dtype=_dtype(cfg.compute_dtype),
    )
    loss = ce
    metrics = {"ce_loss": ce}
    if "moe_lb_loss" in aux:
        loss = loss + 0.01 * aux["moe_lb_loss"] + 0.001 * aux["moe_z_loss"]
        metrics.update(aux)
    metrics["loss"] = loss
    return loss, metrics


def logits_from_hidden(cfg, params, x):
    return lm_logits(x, lm_head_weight(cfg, params),
                     _dtype(cfg.compute_dtype), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# KV cache / state decode
# ---------------------------------------------------------------------------


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int, dtype=None) -> dict:
    """Allocation-free cache description: leaf -> (shape, dtype, logical
    axes, fill value)."""
    if dtype is None:
        dtype = _dtype(cfg.compute_dtype)
    hp = head_plan(cfg, 1)
    width = cfg.rnn_width or cfg.d_model
    hd = cfg.head_dim
    xw = cfg.num_heads * hd  # xlstm inner width
    kv_axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    spec: dict[str, Any] = {}
    for kind, n in cfg.layer_counts().items():
        if kind in ATTN_KINDS:
            # ``local`` layers ring-buffer exactly ``window`` slots: every
            # resident token is then within the window of the current
            # query.  The prompt's flash window keeps key k where
            # k > q - window: the same last ``window`` positions, so prefill
            # and decode agree.
            seq = max_seq if kind != "local" else min(max_seq, cfg.window_size)
            shp = (n, batch, seq, hp["Kp"], cfg.head_dim)
            spec[kind] = {"k": (shp, dtype, kv_axes, 0.0),
                          "v": (shp, dtype, kv_axes, 0.0)}
        elif kind == "rec":
            # The carried state h is float32 whatever the compute dtype.
            spec[kind] = {
                "h": ((n, batch, width), torch.float32,
                      ("layers", "batch", "rnn_state"), 0.0),
                "conv": ((n, batch, cfg.conv1d_width - 1, width), dtype,
                         ("layers", "batch", None, "rnn_state"), 0.0),
            }
        elif kind == "mlstm":
            spec[kind] = {
                "conv": ((n, batch, 3, xw), dtype,
                         ("layers", "batch", None, "rnn_state"), 0.0),
                "C": ((n, batch, cfg.num_heads, hd, hd), torch.float32,
                      ("layers", "batch", "heads", None, None), 0.0),
                "n": ((n, batch, cfg.num_heads, hd), torch.float32,
                      ("layers", "batch", "heads", None), 0.0),
                "m": ((n, batch, cfg.num_heads), torch.float32,
                      ("layers", "batch", "heads"), -1e30),
            }
        elif kind == "slstm":
            st = ((n, batch, cfg.num_heads, hd), torch.float32,
                  ("layers", "batch", "heads", None))
            spec[kind] = {"c": st + (0.0,), "n": st + (1.0,),
                          "m": st + (0.0,), "h": st + (0.0,)}
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
    return spec


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """Decode state per layer kind (K/V for the attention kinds, the
    recurrent state for the others), stacked over that kind's layer count."""
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
        x, _state, _aux = apply_block(cfg, kind, p, x, positions,
                                      cache=_layer(cache[kind], i),
                                      cache_len=cache_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(cfg, params, x), cache


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int):
    """Run the full prompt, returning (last-token logits, filled cache).

    Only the layers that cache ``max_seq`` positions (``attn``, ``global``
    and ``moe``) refuse a longer prompt: ``local`` layers keep the last
    ``window`` positions of a ring and recurrent layers a fixed-size state.
    """
    B, S = tokens.shape
    if S > max_seq and {"attn", "global", "moe"} & set(cfg.layer_counts()):
        raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
    cache = init_cache(cfg, B, max_seq, device=tokens.device)
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)
    for kind, p, i in _layers(cfg, params):
        x, st, _aux = apply_block(cfg, kind, p, x, positions, return_state=True)
        if kind in STATE_KINDS:
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
