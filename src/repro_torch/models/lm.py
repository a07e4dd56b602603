"""Decoder-only language model: every block family of the JAX package's
``models/lm.py``, at any tensor-parallel degree ``tp``.

The layer pattern of the config decides which blocks exist and in which
order: the attention kinds ``attn`` (full causal), ``local`` (sliding
window, ring-buffer cache), ``global`` and ``moe`` (attention with a
mixture-of-experts FFN, ``models/moe.py``), each but ``moe`` with a SwiGLU
MLP where ``d_ff > 0``; the latent-attention kinds ``mla`` (with the MLP)
and ``mla_moe`` (with the MoE FFN), DeepSeek-V2's MLA (``_mla_part``),
which cache each position's normed latent and RoPE key and no per-head
K/V; the Griffin recurrent kind ``rec``
(``models/recurrent.py``) with its MLP; and the xLSTM kinds ``mlstm`` and
``slstm`` (``models/xlstm.py``), one RMS norm and no MLP.

Parameters are the JAX package's tree: per block kind, each leaf is stacked
``[count, ...]`` over that kind's layers.  Layers run as a plain Python
loop (no scan).  Under autograd with ``cfg.remat`` (the default), each
block is recomputed in the backward (``torch.utils.checkpoint``) under the
JAX package's ``cfg.remat_policy``: ``"nothing"`` keeps only the block's
inputs; ``"dots"`` (selective checkpointing, ``dots_policy``) also keeps
the output of every product of an activation with a weight and recomputes
the rest, the kernels included.
Every block calls the fused RMS norm for ``ln1`` (and ``ln2`` where it has
one) and the forward ends in ``final_norm``; the prompt's attention goes
through the flash-attention entry point and a ``rec`` block's recurrence
through the RG-LRU scan's, in prefill and decode alike.  Decode writes the
new token's K/V, and a recurrent layer's state, into the cache in place
and returns the same cache.  ``forward_hidden`` returns the MoE blocks'
aux losses summed in layer order; ``lm_loss`` weighs them in.

TP head policy (the JAX package's): q heads are padded to
``padded_size(H, tp)``; zero extra heads feed zero ``wo`` rows, so outputs
are exact.  KV heads are padded to ``Hp / q_per_kv`` when that keeps the
GQA grouping (``grouped``); otherwise (llama4's g = 5) the ``expand_kv``
plan gathers K/V per q head (``_kv_index``).  The vocab is padded to the TP
degree and the padded logits are masked at the loss.

With ``rules`` (``core/channels.ShardingRules``), the parameters are
DTensors placed by the rules and the activations are constrained at the
JAX package's sites (``_constrain``); plain tensors made inside (positions,
masks) join as replicated (``spmd``).  The kernels run on local shards
(``kernels/_shard.py``).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Any

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig, padded_size
from repro_torch.device import resolve_device
from repro_torch.kernels import _shard
from repro_torch.kernels._shard import is_dtensor
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
MLA_KINDS = ("mla", "mla_moe")
MOE_KINDS = ("moe", "mla_moe")
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


def _kv_index(cfg: ModelConfig, Hp: int, device=None) -> torch.Tensor:
    """Static per-(padded)-q-head KV head assignment (``expand_kv`` plan)."""
    idx = [min(h // cfg.q_per_kv, cfg.num_kv_heads - 1)
           for h in range(cfg.num_heads)]
    idx += [0] * (Hp - cfg.num_heads)
    return torch.tensor(idx, dtype=torch.long, device=device)


# ---------------------------------------------------------------------------
# Parameter specs (the JAX package's trees)
# ---------------------------------------------------------------------------


def _attn_specs(cfg: ModelConfig, n: int, tp: int) -> dict:
    hp = head_plan(cfg, tp)
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


def _mla_specs(cfg: ModelConfig, n: int) -> dict:
    """Latent attention without a query latent (``q_lora_rank`` null):
    ``wq`` [D, H (nope + rope)], ``wkv_a`` [D, latent + rope] (the latent
    and the one RoPE key), ``kv_norm`` the latent's RMS norm, ``wkv_b``
    [latent, H (nope + v)] (each head's no-RoPE key and value), ``wo``."""
    D, H, r = cfg.d_model, cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "ln1": ParamSpec((n, D), ("layers", "d_model"), init="zeros"),
        "wq": ParamSpec((n, D, H * (dn + dr)), ("layers", "d_model_fsdp", "d_attn"),
                        stddev=fan_in_normal((D, 0))),
        "wkv_a": ParamSpec((n, D, r + dr), ("layers", "d_model_fsdp", None),
                           stddev=fan_in_normal((D, 0))),
        "kv_norm": ParamSpec((n, r), ("layers", None), init="zeros"),
        "wkv_b": ParamSpec((n, r, H * (dn + dv)), ("layers", None, "d_attn"),
                           stddev=fan_in_normal((r, 0))),
        "wo": ParamSpec((n, H * dv, D), ("layers", "d_attn", "d_model_fsdp"),
                        stddev=fan_in_normal((H * dv, 0), fan_axis=0)),
    }


def _block_specs(cfg: ModelConfig, kind: str, n: int, tp: int) -> dict:
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
        specs = _attn_specs(cfg, n, tp)
    elif kind in MLA_KINDS:
        specs = _mla_specs(cfg, n)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if kind in MOE_KINDS:
        specs["ln2"] = ParamSpec((n, D), ("layers", "d_model"), init="zeros")
        specs["moe"] = moe_mod.moe_param_specs(
            n, D, cfg.moe_d_ff, cfg.num_experts, cfg.num_shared_experts,
            cfg.num_shared_experts * cfg.moe_d_ff)
    elif cfg.d_ff > 0:
        specs["ln2"] = ParamSpec((n, D), ("layers", "d_model"), init="zeros")
        specs["mlp"] = mlp_specs(D, cfg.d_ff, n)
    return specs


def lm_param_specs(cfg: ModelConfig, tp: int = 1) -> dict:
    Vp = cfg.padded_vocab(tp)
    specs: dict[str, Any] = {
        "embed": ParamSpec((Vp, cfg.d_model), ("vocab", "d_model_fsdp"),
                           stddev=0.02),
        "final_norm": ParamSpec((cfg.d_model,), ("d_model",), init="zeros"),
        "blocks": {
            kind: _block_specs(cfg, kind, n, tp)
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


def _constrain(rules, x, axes):
    if rules is None:
        return x
    return rules.constraint(x, axes)


def spmd(rules):
    """The context a sharded forward (and its backward) runs in: plain
    tensors made inside the model (positions, masks, RoPE tables) take part
    as replicated.  A no-op without rules."""
    if rules is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if DTensor._op_dispatcher._allow_implicit_replication:
        return contextlib.nullcontext()  # its exit would end the outer one
    return implicit_replication()


def _seq_whole(rules, h):
    """A block's normed input with its sequence whole (Megatron-style
    sequence parallelism: the residual stream is sharded over ``seq_sp``,
    the products take every position)."""
    return _constrain(rules, h, ("batch", "seq", "d_model"))


def _residual(rules, t):
    """A block's output product back on the residual stream's placements
    (a reduce-scatter over ``seq_sp`` where the product is partial).  In
    the backward the same constraint gathers the gradient's sequence before
    it reaches the product, whose gradient then never flattens a batch
    sharded on one mesh axis with a sequence sharded on another."""
    return _constrain(rules, t, ("batch", "seq_sp", "d_model"))


def _heads(rules, t, n: int, hd: int):
    """A projection [B, S, n * hd] viewed as n heads.  Where the model axis
    does not divide n, the projection is gathered first: a shard of the
    flat columns is not a whole number of heads."""
    B, S, _ = t.shape
    if n % _model_axis(rules):
        t = _constrain(rules, t, ("batch", "seq", None))
    return t.reshape(B, S, n, hd)


def _model_axis(rules) -> int:
    return 1 if rules is None else rules.axis_sizes.get("model", 1)


def _expand_kv(cfg, hp, k, v, rules):
    """K/V [B, S, Kp, hd] as the attention takes them.  The ``expand_kv``
    plan gathers each q head's KV head (``_kv_index``).  Under rules whose
    model axis does not divide Kp, the grouped KV heads are repeated to the
    Hp query heads, so heads shard over any model axis (the JAX package
    always expands for the whole-sequence attention, for the same reason).
    """
    Hp, Kp = hp["Hp"], hp["Kp"]
    if hp["mode"] == "expand_kv":
        idx = _kv_index(cfg, Hp, k.device)
        return k.index_select(2, idx), v.index_select(2, idx)
    if Kp != Hp and Kp % _model_axis(rules):
        return (k.repeat_interleave(Hp // Kp, dim=2),
                v.repeat_interleave(Hp // Kp, dim=2))
    return k, v


def _write_kv(c, new, slot, cache_len):
    """Write ``new`` [B, S, K, hd] into the layer cache ``c`` [B, Sc, K, hd]
    at ``slot`` (an int, or a [B] tensor of one slot per row) and return the
    cache.  A plain cache, or a DTensor whose sequence is whole, is written
    in place on its local shard (the rows of this shard); a cache sharded
    over its sequence (the dry-run's FlashDecoding layout) is rewritten as a
    whole by a masked select, which DTensor shards like any pointwise op."""
    S = new.shape[1]
    if is_dtensor(c):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset,
        )

        if any(p.is_shard() and p.dim == 1 for p in c.placements):
            if S != 1:
                raise ValueError("a sequence-sharded cache takes one token a step")
            pos = torch.arange(c.shape[1], device=new.device)
            hit = (pos[None, :] == slot if isinstance(cache_len, int)
                   else pos[None, :] == slot[:, None])  # [1 or B, Sc]
            return torch.where(hit[:, :, None, None], new.to(c.dtype), c)
        local_shape, offset = compute_local_shape_and_global_offset(
            c.shape, c.device_mesh, c.placements)
        lo, nb = offset[0], local_shape[0]
        cl = c.to_local()
        newl = new.redistribute(c.device_mesh, c.placements).to_local() \
            if is_dtensor(new) else new[lo:lo + nb]
        if not isinstance(cache_len, int):
            slot = slot[lo:lo + nb]
        _write_kv(cl, newl, slot, cache_len)
        return c
    if isinstance(cache_len, int):
        c[:, slot:slot + S] = new.to(c.dtype)
    else:
        rows = torch.arange(c.shape[0], device=c.device)
        c[rows, slot] = new[:, 0].to(c.dtype)
    return c


def _attention_part(cfg, p, x, positions, *, kind, tp=1, rules=None,
                    cache=None, cache_len=None, return_state=False):
    """Shared attention sub-block. Returns (attn_out, state).

    ``cache`` (decode): {"k","v"} [B, Scache, KV, hd] views into the stacked
    cache; the new token's K/V are written into them in place.  ``cache_len``
    is an int (every row at the same length) or a [B] tensor (a length per
    serving slot).  ``local`` layers use a ring buffer of exactly the window
    size: keys carry RoPE for their true positions, so slot order does not
    matter and no window mask is needed.  ``return_state`` (prefill):
    returns this segment's fresh {"k","v"}.  Everything after ``ln1`` is
    the profiler span ``attention``; decode's attention over the cache is
    ``attention.decode`` inside it.
    """
    hp = head_plan(cfg, tp)
    H, KV, hd = hp["Hp"], hp["Kp"], cfg.head_dim
    B, S, _D = x.shape
    cdt = _dtype(cfg.compute_dtype)
    h = _seq_whole(rules, rms_norm(x, p["ln1"], cfg.norm_eps))
    with record_function("attention"):
        q = _heads(rules, h @ p["wq"].to(cdt), H, hd)
        k = _heads(rules, h @ p["wk"].to(cdt), KV, hd)
        v = _heads(rules, h @ p["wv"].to(cdt), KV, hd)
        if cfg.use_qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        q = attn_mod.apply_rope(q, positions, cfg.rope_theta)
        k = attn_mod.apply_rope(k, positions, cfg.rope_theta)
        if cfg.constrain_attn:
            q = _constrain(rules, q, ("batch", "seq", "heads", "head_dim"))

        state = None
        if cache is not None:
            size = cache["k"].shape[1]
            slot = cache_len % size if kind == "local" else cache_len
            ck = _write_kv(cache["k"], k, slot, cache_len)
            cv = _write_kv(cache["v"], v, slot, cache_len)
            if isinstance(cache_len, int):
                valid = min(cache_len + S, size)
            else:
                valid = torch.clamp(cache_len + S, max=size)
            with record_function("attention.decode"):
                if hp["mode"] == "expand_kv":
                    ck_att, cv_att = _expand_kv(cfg, hp, ck, cv, None)
                else:
                    ck_att, cv_att = ck, cv
                out = attn_mod.decode_attention(q, ck_att, cv_att, valid)
            state = cache if ck is cache["k"] and cv is cache["v"] \
                else {"k": ck, "v": cv}
        else:
            window = cfg.window_size if kind == "local" else 0
            k_att, v_att = _expand_kv(cfg, hp, k, v, rules)
            if cfg.constrain_attn:
                k_att = _constrain(rules, k_att,
                                   ("batch", "seq", "heads", "head_dim"))
                v_att = _constrain(rules, v_att,
                                   ("batch", "seq", "heads", "head_dim"))
            out = attn_mod.attention(q, k_att, v_att, causal=True,
                                     window=window)
            if return_state:
                state = {"k": k, "v": v}
        if cfg.constrain_attn:
            out = _constrain(rules, out, ("batch", "seq", "heads", "head_dim"))
        out = _residual(rules, out.reshape(B, S, H * hd) @ p["wo"].to(cdt))
    return out.to(x.dtype), state


def _mla_part(cfg, p, x, positions, *, cache=None, cache_len=None,
              return_state=False):
    """Latent attention (DeepSeek-V2's MLA).  Returns (attn_out, state).

    h = RMSNorm(x); q = h Wq per head [nope | rope]; [c~ | k~] = h Wkv_a;
    the latent c = RMSNorm(c~) with its own scale and the RoPE key k_pe =
    RoPE(k~), one for every head; YaRN's RoPE rotates consecutive pairs.
    A prompt (``cache`` None) runs un-absorbed: [k_nope | v] = c Wkv_b per
    head (the span ``mla.expand``), keys [k_nope | k_pe], and the flash
    kernel at the scale ``yarn_softmax_scale``, q, k and v zero-padded to
    one head dim.  ``return_state``: its {"c", "k_pe"}.  Decode writes c
    and k_pe into the cache (``_write_kv``) and runs absorbed: each head's
    no-RoPE query times its key up-projection scores the latents directly,
    and the softmax-weighted latents times the value up-projection give
    its output (those two products are the span ``mla.absorb``), all of it
    the span ``attention.decode`` in f32.  Everything after ``ln1`` is the
    span ``attention``.
    """
    H, r = cfg.num_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    B, S, _D = x.shape
    cdt = _dtype(cfg.compute_dtype)
    scale = attn_mod.yarn_softmax_scale(dn + dr, cfg.rope_scaling)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    with record_function("attention"):
        q = (h @ p["wq"].to(cdt)).reshape(B, S, H, dn + dr)
        kv = h @ p["wkv_a"].to(cdt)
        c = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
        turn = attn_mod.rope_pairs_turns(dr, cfg.rope_theta, cfg.rope_scaling, positions)
        q_pe = attn_mod.apply_rope_pairs(q[..., dn:], turn)
        k_pe = attn_mod.apply_rope_pairs(kv[..., None, r:], turn)[:, :, 0]
        state = None
        if cache is None:
            with record_function("mla.expand"):
                kvb = (c @ p["wkv_b"].to(cdt)).reshape(B, S, H, dn + dv)
            k = torch.cat([kvb[..., :dn], k_pe[:, :, None].expand(B, S, H, dr)], -1)
            out = attn_mod.padded_attention(torch.cat([q[..., :dn], q_pe], -1), k,
                                            kvb[..., dn:], scale=scale)
            if return_state:
                state = {"c": c, "k_pe": k_pe}
        else:
            cc = _write_kv(cache["c"], c, cache_len, cache_len)
            cpe = _write_kv(cache["k_pe"], k_pe, cache_len, cache_len)
            size = cc.shape[1]
            valid = (min(cache_len + S, size) if isinstance(cache_len, int)
                     else torch.clamp(cache_len + S, max=size))
            with record_function("attention.decode"):
                with record_function("mla.absorb"):
                    w = p["wkv_b"].float().reshape(r, H, dn + dv)
                    q_lat = torch.einsum("bshn,rhn->bshr", q[..., :dn].float(),
                                         w[..., :dn])
                lat = attn_mod.latent_decode_attention(q_lat, q_pe, cc, cpe, valid,
                                                       scale)
                with record_function("mla.absorb"):
                    out = torch.einsum("bshr,rhv->bshv", lat, w[..., dn:]).to(cdt)
            state = cache if cc is cache["c"] and cpe is cache["k_pe"] \
                else {"c": cc, "k_pe": cpe}
        out = out.reshape(B, S, H * dv) @ p["wo"].to(cdt)
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


def _state_part(cfg, kind, p, x, *, rules=None, cache=None):
    """Recurrent sub-block (``rec``, ``mlstm`` or ``slstm``).  Returns
    (out, state as cache leaves).

    ``cache`` (decode): that layer's cache leaves (views into the stacked
    cache); the new state is written into them in place.  Without it (a
    whole prompt), the state is the one the prompt leaves behind.
    """
    cdt = _dtype(cfg.compute_dtype)
    h = _seq_whole(rules, rms_norm(x, p["ln1"], cfg.norm_eps))
    state = _cache_kind_state(cache, kind)
    if kind == "rec":
        out, new = rec_mod.recurrent_block(p["rec"], h, compute_dtype=cdt,
                                           state=state)
    else:
        block = (xlstm_mod.mlstm_block if kind == "mlstm"
                 else xlstm_mod.slstm_block)

        def core(hl, pl, *st):
            return block(pl, hl, heads=cfg.num_heads, compute_dtype=cdt,
                         state=st[0] if st else None)

        if is_dtensor(h):  # the cells are independent per batch row
            out, new = _shard.run_over_rows(
                core, h, p["core"], *(() if state is None else (state,)))
        else:
            out, new = core(h, p["core"], *(() if state is None else (state,)))
    out = _residual(rules, out)
    new = _state_to_cache(new, kind)
    if cache is not None:
        for name, leaf in new.items():
            cache[name].copy_(leaf)
        new = cache
    return out, new


def apply_block(cfg, kind, p, x, positions, *, tp=1, rules=None, cache=None,
                cache_len=None, return_state=False):
    """One residual block of the given kind.  Returns (x, new_cache, aux):
    ``aux`` holds a ``moe`` block's aux losses, else it is empty."""
    cdt = _dtype(cfg.compute_dtype)
    if kind in ATTN_KINDS:
        mix_out, state = _attention_part(
            cfg, p, x, positions, kind=kind, tp=tp, rules=rules, cache=cache,
            cache_len=cache_len, return_state=return_state,
        )
    elif kind in MLA_KINDS:
        if tp > 1 or rules is not None:
            raise NotImplementedError("latent attention runs on one device")
        mix_out, state = _mla_part(cfg, p, x, positions, cache=cache,
                                   cache_len=cache_len, return_state=return_state)
    elif kind in STATE_KINDS:
        mix_out, state = _state_part(cfg, kind, p, x, rules=rules, cache=cache)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    x = x + mix_out
    aux: dict[str, torch.Tensor] = {}
    if kind in MOE_KINDS:
        h = _seq_whole(rules, rms_norm(x, p["ln2"], cfg.norm_eps))
        moe_out, aux = moe_mod.moe_ffn(
            h, p["moe"], num_experts=cfg.num_experts,
            top_k=cfg.experts_per_token, capacity_factor=cfg.capacity_factor,
            compute_dtype=cdt, dispatch=cfg.moe_dispatch,
            norm_topk_prob=cfg.norm_topk_prob,
            # the aux losses only where they are summed: a whole-sequence
            # forward, not a prefill or a decode step
            aux=cache is None and not return_state)
        x = x + _residual(rules, moe_out)
    elif "mlp" in p:
        h = _seq_whole(rules, rms_norm(x, p["ln2"], cfg.norm_eps))
        x = x + _residual(rules, swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                                       p["mlp"]["w_down"], cdt)).to(x.dtype)
    x = _constrain(rules, x, ("batch", "seq_sp", "d_model"))
    return x, state, aux


def _layer(tree, i: int):
    """Layer ``i`` of a stacked cache tree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _embed(cfg: ModelConfig, params, tokens):
    x = embed_tokens(params["embed"], tokens, _dtype(cfg.compute_dtype))
    return x * math.sqrt(cfg.d_model) if cfg.scale_embeddings else x


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


# The weight products: every one of the port is written ``activation @
# weight``, which dispatches ``aten.mm`` (``addmm`` with a bias).  A product
# with batch dims (an einsum, ``bmm``) dispatches neither.
DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_policy(ctx, op, *args, **kwargs):
    """The JAX package's ``dots_with_no_batch_dims_saveable``: keep the
    output of every product with no batch dims, recompute everything else
    (batched products, elementwise ops, the kernels' ops)."""
    return (CheckpointPolicy.MUST_SAVE if op in DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_policy(cfg: ModelConfig) -> dict:
    """``checkpoint``'s arguments for ``cfg.remat_policy`` (the JAX
    package's ``_remat_policy``, which takes any other name for
    ``"nothing"``; here it is an error)."""
    if cfg.remat_policy == "nothing":
        return {}
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, dots_policy)}
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}: "
                     f"\"nothing\" or \"dots\"")


def _remat(cfg: ModelConfig, params) -> dict | None:
    """The ``checkpoint`` arguments the blocks are recomputed under in the
    backward (``_remat_policy``), or None where no block is: outside
    autograd, or without ``cfg.remat``."""
    policy = _remat_policy(cfg)
    if not (cfg.remat and torch.is_grad_enabled() and _requires_grad(params)):
        return None
    return policy


def run_block(remat: dict | None, block, *args):
    """``block(*args)``, recomputed in the backward under ``remat`` (what
    ``_remat`` returned) where it is not None."""
    if remat is None:
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False, **remat)


def forward_hidden(cfg: ModelConfig, params, tokens: torch.Tensor,
                   extra_embeds: torch.Tensor | None = None, *, tp: int = 1,
                   rules=None):
    """Full-sequence forward to (final hidden states [B, S, D], aux).

    ``extra_embeds`` ([B, F, D]) replace the first F token positions (the
    VLM patch / audio frame stub inputs), unscaled.  ``aux`` sums the MoE
    blocks' aux losses in layer order (empty without ``moe`` layers).
    """
    with spmd(rules):
        return _forward_hidden(cfg, params, tokens, extra_embeds, tp, rules)


def _forward_hidden(cfg, params, tokens, extra_embeds, tp, rules):
    x = _embed(cfg, params, tokens)
    if extra_embeds is not None:
        F = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(x.dtype), x[:, F:]], dim=1)
    x = _constrain(rules, x, ("batch", "seq_sp", "d_model"))
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = _remat(cfg, params)
    aux_total = ({k: torch.zeros((), dtype=torch.float32, device=x.device)
                  for k in MOE_AUX} if set(MOE_KINDS) & set(cfg.layer_counts()) else {})
    for kind, p, _i in _layers(cfg, params):
        def block(x, p, kind=kind):
            x, _state, aux = apply_block(cfg, kind, p, x, positions, tp=tp,
                                         rules=rules)
            return x, aux
        x, aux = run_block(remat, block, x, p)
        for k, v in aux.items():
            aux_total[k] = aux_total[k] + v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _seq_whole(rules, x), aux_total


def lm_head_weight(cfg: ModelConfig, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def lm_loss(cfg: ModelConfig, params, batch, *, tp: int = 1, rules=None):
    """Mean CE over next-token targets + MoE aux losses: (loss, metrics)
    with ``ce_loss``, ``loss`` and, for MoE models, the three aux values.
    ``batch["extra_embeds"]``, where present, is the frontend stub's
    prefix."""
    x, aux = forward_hidden(cfg, params, batch["tokens"],
                            extra_embeds=batch.get("extra_embeds"), tp=tp,
                            rules=rules)
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


def cache_spec(cfg: ModelConfig, batch: int, max_seq: int, tp: int = 1,
               dtype=None) -> dict:
    """Allocation-free cache description: leaf -> (shape, dtype, logical
    axes, fill value): the one source of ``init_cache`` and the dry-run's
    structs (which must never allocate a multi-TB cache)."""
    if dtype is None:
        dtype = _dtype(cfg.compute_dtype)
    hp = head_plan(cfg, tp)
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
        elif kind in MLA_KINDS:
            # the latent and the RoPE key of every position, no per-head K/V
            axes = ("layers", "batch", "kv_seq", None)
            spec[kind] = {
                "c": ((n, batch, max_seq, cfg.kv_lora_rank), dtype, axes, 0.0),
                "k_pe": ((n, batch, max_seq, cfg.qk_rope_head_dim), dtype, axes, 0.0),
            }
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


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, tp: int = 1,
               dtype=None, device=None, rules=None) -> dict:
    """Decode state per layer kind (K/V for the attention kinds, the
    recurrent state for the others), stacked over that kind's layer count;
    with ``rules``, each leaf a DTensor placed by them."""
    dev = resolve_device(device)

    def leaf(shp, dt, axes, fill):
        t = torch.full(shp, fill, dtype=dt, device=dev)
        return t if rules is None else rules.distribute(t, axes)

    return {
        kind: {name: leaf(*spec) for name, spec in leaves.items()}
        for kind, leaves in cache_spec(cfg, batch, max_seq, tp, dtype).items()
    }


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                cache_len, *, tp: int = 1, rules=None):
    """One decode step.  tokens: [B, 1]; cache_len: int, or a [B] tensor of
    the tokens already in each row's cache.  Returns (logits [B, 1, Vp],
    cache), the cache updated in place (a sequence-sharded DTensor cache:
    its new layers written back into the stacks).  The profiler span
    ``model.decode``."""
    with record_function("model.decode"), spmd(rules):
        x = _embed(cfg, params, tokens)
        x = _constrain(rules, x, ("batch", "seq_sp", "d_model"))
        if isinstance(cache_len, int):
            positions = torch.tensor([cache_len], device=tokens.device)
        else:
            positions = cache_len[:, None]  # [B, 1] per-slot positions
        for kind, p, i in _layers(cfg, params):
            layer = _layer(cache[kind], i)
            x, state, _aux = apply_block(cfg, kind, p, x, positions, tp=tp,
                                         rules=rules, cache=layer,
                                         cache_len=cache_len)
            for name, leaf in state.items():
                if leaf is not layer[name]:
                    cache[kind][name][i] = leaf
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return logits_from_hidden(cfg, params, x), cache


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_seq: int, *,
            tp: int = 1, rules=None):
    """Run the full prompt, returning (last-token logits, filled cache).

    Only the layers that cache ``max_seq`` positions (``attn``, ``global``,
    ``moe`` and the latent kinds) refuse a longer prompt: ``local`` layers keep the last
    ``window`` positions of a ring and recurrent layers a fixed-size state.
    The profiler span ``model.prefill``.
    """
    B, S = tokens.shape
    if S > max_seq and {"attn", "global", "moe", *MLA_KINDS} & set(cfg.layer_counts()):
        raise ValueError(f"prompt of {S} tokens exceeds max_seq {max_seq}")
    with record_function("model.prefill"), spmd(rules):
        return _prefill(cfg, params, tokens, max_seq, tp, rules)


def _prefill(cfg, params, tokens, max_seq, tp, rules):
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_seq, tp, device=tokens.device)
    x = _embed(cfg, params, tokens)
    x = _constrain(rules, x, ("batch", "seq_sp", "d_model"))
    positions = torch.arange(S, device=tokens.device)
    for kind, p, i in _layers(cfg, params):
        x, st, _aux = apply_block(cfg, kind, p, x, positions, tp=tp,
                                  rules=rules, return_state=True)
        st = {name: _shard.whole(leaf) for name, leaf in st.items()}
        if kind in STATE_KINDS:
            for name, leaf in st.items():
                cache[kind][name][i].copy_(leaf)
            continue
        for name in st:
            dst = cache[kind][name][i]  # [B, size, ...]
            size = dst.shape[1]
            if kind == "local":
                nfit = min(S, size)
                slots = torch.arange(S - nfit, S, device=tokens.device) % size
                dst.index_copy_(1, slots, st[name][:, S - nfit:].to(dst.dtype))
            else:
                dst[:, :S] = st[name].to(dst.dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(cfg, params, x[:, -1:]), cache
