"""Plain float32 reference of DeepSeek-V2's architecture (latent attention
and a dropless fine-grained MoE), for the port's tests.

Written from the published equations (arXiv:2405.04434 and DeepSeek's
``modeling_deepseek.py``), with no kernel, no cache and no batching: one
sequence at a time, attention un-absorbed, every expert a loop over the
tokens routed to it.  It reads the port's parameter tree by name (per layer
kind, each leaf stacked over that kind's layers) and its configuration as
a plain dict of sizes, and imports nothing of the port.  The RMS norm's
scale is stored as (1 + scale), as in the port's trees.

Per layer: h = RMSNorm(x); q = h Wq, per head [nope | rope]; [c~ | k~] =
h Wkv_a; c = RMSNorm(c~); k_pe = RoPE(k~) shared by the heads; [k_nope |
v] = c Wkv_b per head; scores (q_nope k_nope + RoPE(q_pe) k_pe) times
(nope + rope)^-1/2 m^2; causal softmax; x += (P v) Wo; then x +=
FFN(RMSNorm(x)): a SwiGLU, or the sum over the top-k experts of p_e
SwiGLU_e(h) (p the f32 softmax of h Wr, ties to the lower index,
renormalised only where ``norm_topk_prob``) plus the shared SwiGLU.  RoPE
rotates consecutive pairs at YaRN's frequencies.  The loss is the mean
next-token cross entropy plus 0.01 times the Switch load-balance loss and
0.001 times the router z-loss, summed over the MoE layers.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def setup_precision() -> None:
    """float32 products stay float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + scale)


def yarn_mscale(factor, mscale):
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim, theta, rs):
    """YaRN: frequencies below the beta_slow boundary divided by the
    factor, those above beta_fast kept, a linear ramp between."""
    def boundary(turns):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(boundary(rs["beta_fast"])), 0)
    high = min(math.ceil(boundary(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    plain = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return (plain / rs["factor"]) * ramp + plain * (1 - ramp)


def softmax_scale(cfg):
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs:
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale *= m * m
    return scale


def rope(x, cfg):
    """x [S, ..., P]: consecutive pairs (x[2i], x[2i+1]) turned by position
    times frequency i, cos and sin times YaRN's attention factor."""
    P, rs = x.shape[-1], cfg.get("rope_scaling")
    if rs:
        inv = yarn_inv_freq(P, cfg["rope_theta"], rs).to(x.device)
        att = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"],
                                                                    rs["mscale_all_dim"])
    else:
        inv = 1.0 / cfg["rope_theta"] ** (torch.arange(0, P, 2, dtype=torch.float32,
                                                       device=x.device) / P)
        att = 1.0
    ang = torch.arange(x.shape[0], dtype=torch.float32, device=x.device)[:, None] * inv
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (P // 2,)
    cos, sin = (torch.cos(ang) * att).reshape(shape), (torch.sin(ang) * att).reshape(shape)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], -1).flatten(-2)


def mla(cfg, p, x):
    """x [S, D] -> the attention's output [S, D]."""
    S = x.shape[0]
    H, r = cfg["num_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    h = rms_norm(x, p["ln1"], cfg["norm_eps"])
    q = (h @ p["wq"]).view(S, H, dn + dr)
    kv = h @ p["wkv_a"]
    c = rms_norm(kv[:, :r], p["kv_norm"], cfg["norm_eps"])
    k_pe = rope(kv[:, r:], cfg)  # [S, dr], one for every head
    kvb = (c @ p["wkv_b"]).view(S, H, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe[:, None].expand(S, H, dr)], -1)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cfg)], -1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * softmax_scale(cfg)
    future = torch.ones(S, S, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), -1)
    out = torch.einsum("hqk,khd->qhd", probs, kvb[..., dn:])
    return out.reshape(S, H * dv) @ p["wo"]


def swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate) * (h @ w_up)) @ w_down


def moe(cfg, p, h):
    """h [S, D] -> (out [S, D], aux losses), every routed slot computed."""
    E, k = cfg["num_experts"], cfg["experts_per_token"]
    logits = h @ p["router"]
    probs = torch.softmax(logits, -1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    if cfg.get("norm_topk_prob", True):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, rank = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e])
            out = out.index_add(0, tok, y * top_p[tok, rank, None])
    if "shared_w_gate" in p:
        out = out + swiglu(h, p["shared_w_gate"], p["shared_w_up"], p["shared_w_down"])
    first = F.one_hot(top_e[:, 0], E).float()
    aux = {"moe_lb_loss": E * torch.sum(first.mean(0) * probs.mean(0)),
           "moe_z_loss": torch.mean(torch.logsumexp(logits, -1) ** 2)}
    return out, aux


def layer_kinds(cfg):
    lead, period = list(cfg["layer_prefix"]), list(cfg["layer_pattern"])
    return lead + [period[i % len(period)] for i in range(cfg["num_layers"] - len(lead))]


def hidden(cfg, params, tokens):
    """tokens [S] -> (final normed hidden states [S, D], aux losses summed)."""
    x = params["embed"][tokens].float()
    if cfg.get("scale_embeddings", True):
        x = x * math.sqrt(cfg["d_model"])
    seen, aux_total = {}, {"moe_lb_loss": 0.0, "moe_z_loss": 0.0}
    for kind in layer_kinds(cfg):
        i = seen[kind] = seen.get(kind, -1) + 1
        p = _layer(params["blocks"][kind], i)
        x = x + mla(cfg, p, x)
        h = rms_norm(x, p["ln2"], cfg["norm_eps"])
        if kind == "mla_moe":
            out, aux = moe(cfg, p["moe"], h)
            aux_total = {n: aux_total[n] + aux[n] for n in aux_total}
        else:
            out = swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])
        x = x + out
    return rms_norm(x, params["final_norm"], cfg["norm_eps"]), aux_total


def _layer(tree, i):
    return {k: _layer(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def logits(cfg, params, tokens):
    """tokens [S] -> logits [S, vocab]."""
    setup_precision()
    x, _aux = hidden(cfg, params, tokens)
    return (x @ params["lm_head"])[:, :cfg["vocab_size"]]


def loss(cfg, params, tokens, targets):
    """One sequence's mean next-token cross entropy (``tokens``,
    ``targets`` [S]) plus the weighted aux losses."""
    setup_precision()
    x, aux = hidden(cfg, params, tokens)
    lg = (x @ params["lm_head"])[:, :cfg["vocab_size"]]
    return F.cross_entropy(lg, targets) + 0.01 * aux["moe_lb_loss"] \
        + 0.001 * aux["moe_z_loss"]
