"""Plain reference of the latent-attention decoder (the ``mla`` family:
DeepSeek-V2-Lite).

Written from the published equations (arXiv:2405.04434 and DeepSeek's
``modeling_deepseek.py``) in plain PyTorch, with no kernel and nothing of
the program; it reads the program's parameter tree by name and reuses the
dense family's products, norms, SwiGLU and precisions (``dense``):

* latent attention, un-absorbed and with no cache: h = RMSNorm(x); q = h Wq
  per head [nope | rope]; [c~ | k~] = h Wkv_a; c = RMSNorm(c~); k_pe =
  RoPE(k~) shared by the heads; [k_nope | v] = c Wkv_b per head; scores
  (q_nope k_nope + RoPE(q_pe) k_pe) (nope + rope)^-1/2 m^2 with YaRN's m;
  a causal softmax in float32, computed in blocks of queries; x += (P v) Wo;
* RoPE turns consecutive pairs at YaRN's frequencies;
* the FFN: the dense SwiGLU in the leading layers, else every routed slot
  (no capacity): the router in float32, softmax, the top-k with equal
  probabilities to the lower expert index, renormalised only where
  ``norm_topk_prob``, each expert a SwiGLU over its tokens, plus the shared
  SwiGLU of width ``num_shared_experts`` x ``moe_d_ff``;
* no embedding scale where ``scale_embeddings`` is false; the untied head;
  the loss and AdamW as the dense family's.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference import dense

QUERY_BLOCK = 1024  # queries a block of the reference's attention


def _mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, theta: float, rs: dict, device) -> torch.Tensor:
    """YaRN: frequencies below the ``beta_slow`` boundary divided by
    ``factor``, those above ``beta_fast`` kept, a linear ramp between."""
    def boundary(turns):
        return dim * math.log(rs["original_max_position_embeddings"]
                              / (turns * 2 * math.pi)) / (2 * math.log(theta))

    low = max(math.floor(boundary(rs["beta_fast"])), 0)
    high = min(math.ceil(boundary(rs["beta_slow"])), dim - 1)
    high = high + 0.001 if low == high else high
    plain = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    return plain / rs["factor"] * ramp + plain * (1 - ramp)


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs:
        m = _mscale(rs["factor"], rs["mscale_all_dim"])
        scale *= m * m
    return scale


def rope(x, cfg: dict) -> torch.Tensor:
    """x [B, S, H, P]: pair i of each head turned by position times YaRN's
    frequency i, cos and sin times its attention factor."""
    P, rs = x.shape[-1], cfg["rope_scaling"]
    inv = yarn_inv_freq(P, cfg["rope_theta"], rs, x.device)
    att = _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"], rs["mscale_all_dim"])
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = (torch.cos(ang) * att)[None, :, None], (torch.sin(ang) * att)[None, :, None]
    a, b = x[..., 0::2].float(), x[..., 1::2].float()
    return torch.stack([a * cos - b * sin, b * cos + a * sin], -1).flatten(-2).to(x.dtype)


def causal_attention(q, k, v, scale: float, precision: str) -> torch.Tensor:
    """q, k [B, S, H, Dqk]; v [B, S, H, Dv]: causal softmax attention in
    float32, ``QUERY_BLOCK`` queries at a time against the keys they see."""
    dtype, S = q.dtype, q.shape[1]
    q, k, v = (dense.operand(t, precision).float() for t in (q, k, v))
    out = []
    for i in range(0, S, QUERY_BLOCK):
        j = min(i + QUERY_BLOCK, S)
        scores = dense.product(torch.einsum("bqhd,bkhd->bhqk", q[:, i:j], k[:, :j]),
                               precision) * scale
        future = torch.arange(j, device=q.device)[None] > torch.arange(i, j, device=q.device)[:, None]
        probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
        probs = dense.operand(probs, precision).float()
        out.append(dense.product(torch.einsum("bhqk,bkhd->bqhd", probs, v[:, :j]), precision))
    return torch.cat(out, dim=1).to(dtype)


def attention_part(cfg: dict, p: dict, x, precision: str) -> torch.Tensor:
    B, S, _ = x.shape
    H, r = cfg["num_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    h = dense.rms_norm(x, p["ln1"], cfg["norm_eps"])
    q = dense.mm(h, p["wq"], precision).to(x.dtype).view(B, S, H, dn + dr)
    kv = dense.mm(h, p["wkv_a"], precision).to(x.dtype)
    c = dense.rms_norm(kv[..., :r], p["kv_norm"], cfg["norm_eps"])
    k_pe = rope(kv[..., None, r:], cfg)
    kvb = dense.mm(c, p["wkv_b"], precision).to(x.dtype).view(B, S, H, dn + dv)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], cfg)], -1)
    k = torch.cat([kvb[..., :dn], k_pe.expand(B, S, H, dr)], -1)
    o = causal_attention(q, k, kvb[..., dn:], softmax_scale(cfg), precision)
    return x + dense.mm(o.reshape(B, S, H * dv), p["wo"], precision).to(x.dtype)


def routed_ffn(cfg: dict, p: dict, h, precision: str):
    """h [B, S, D] -> (out [B, S, D] in h's dtype, aux losses), every slot
    computed."""
    B, S, D = h.shape
    E, k = cfg["num_experts"], cfg["experts_per_token"]
    logits = h.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    if cfg.get("norm_topk_prob", True):
        top_p = top_p / top_p.sum(-1, keepdim=True)
    rows = []
    for b in range(B):
        out = torch.zeros(S, D, dtype=torch.float32, device=h.device)
        for e in range(E):
            tok, rank = torch.nonzero(top_e[b] == e, as_tuple=True)
            if tok.numel():
                y = dense.swiglu(h[b, tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                                 precision)
                out = out.index_add(0, tok, y.float() * top_p[b, tok, rank, None])
        rows.append(out)
    out = torch.stack(rows)
    if "shared_w_gate" in p:
        out = out + dense.swiglu(h, p["shared_w_gate"], p["shared_w_up"],
                                 p["shared_w_down"], precision).float()
    first = F.one_hot(top_e[..., 0], E).float()
    aux = {
        "moe_lb_loss": E * torch.sum(first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))),
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
    }
    return out.to(h.dtype), aux


def block(cfg: dict, kind: str, p: dict, x, precision: str):
    x = attention_part(cfg, p, x, precision)
    h = dense.rms_norm(x, p["ln2"], cfg["norm_eps"])
    if kind == "mla_moe":
        out, aux = routed_ffn(cfg, p["moe"], h, precision)
        return x + out, aux
    mlp = p["mlp"]
    return x + dense.swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"], precision), {}


def layers(cfg: dict, params: dict) -> list[tuple[str, dict]]:
    """(kind, parameters) of every layer in order: ``layer_prefix``, then
    ``layer_pattern`` cycled."""
    lead, period = list(cfg.get("layer_prefix", ())), list(cfg["layer_pattern"])
    kinds = lead + [period[i % len(period)] for i in range(cfg["num_layers"] - len(lead))]
    stacks = {kind: dense._unbind(params["blocks"][kind], kinds.count(kind))
              for kind in set(kinds)}
    seen: dict[str, int] = {}
    out = []
    for kind in kinds:
        seen[kind] = seen.get(kind, -1) + 1
        out.append((kind, stacks[kind][seen[kind]]))
    return out


def hidden(cfg: dict, params: dict, tokens, precision: str):
    """Final normed hidden states [B, S, D] and the MoE layers' aux losses
    summed; under autograd each block is recomputed in the backward."""
    dtype = torch.float32 if precision == "f32" else getattr(torch, cfg["compute_dtype"])
    x = params["embed"][tokens].to(dtype)
    if cfg.get("scale_embeddings", True):
        x = x * math.sqrt(cfg["d_model"])
    grad = torch.is_grad_enabled()
    aux_total: dict = {}
    for kind, p in layers(cfg, params):
        def run(x, p, kind=kind):
            return block(cfg, kind, p, x, precision)
        x, aux = checkpoint(run, x, p, use_reentrant=False) if grad else run(x, p)
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v
    return dense.rms_norm(x, params["final_norm"], cfg["norm_eps"]), aux_total


def loss(cfg: dict, params: dict, batch: dict, precision: str):
    """Mean next-token cross entropy plus the aux losses at the
    configuration's weights."""
    x, aux = hidden(cfg, params, batch["tokens"], precision)
    logits = dense.mm(x, params["lm_head"], precision).float()[..., :cfg["vocab_size"]]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"][..., None])[..., 0]
    total = (lse - tgt).mean()
    for name, weight in cfg.get("aux_loss_weights", {}).items():
        total = total + weight * aux[name]
    return total


@torch.no_grad()
def logits_at(cfg: dict, params: dict, tokens, positions, precision: str) -> torch.Tensor:
    """Float32 logits [len(positions), vocab] of one sequence ``tokens``
    [1, T] at ``positions``; the head in float32 whatever ``precision``."""
    dense.setup_precision()
    x, _aux = hidden(cfg, params, tokens, precision)
    rows = dense.operand(x[0, positions], precision).float()
    return rows @ dense.operand(params["lm_head"], precision).float()[:, :cfg["vocab_size"]]


def train(cfg: dict, params: dict, batches: list[dict], opt: dict, precision: str,
          sample: dict | None = None) -> dict:
    """AdamW steps on ``batches`` from ``params`` (updated in place), as the
    dense family's ``train``: each step's loss, and per leaf the first
    step's clipped gradient norm and its values at ``sample[path]``."""
    dense.setup_precision()
    named = dense.leaves(params)
    moments = [(torch.zeros_like(t), torch.zeros_like(t)) for _n, t in named]
    losses, first_grad, first_sample = [], {}, {}
    for step, batch in enumerate(batches):
        for _n, t in named:
            t.requires_grad_(True)
        try:
            value = loss(cfg, params, batch, precision)
            grads = torch.autograd.grad(value, [t for _n, t in named])
        finally:
            for _n, t in named:
                t.requires_grad_(False)
        losses.append(float(value.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
            scale = min(opt["clip_norm"] / max(float(norm), 1e-9), 1.0)
            if step == 0:
                first_grad = {n: float(g.float().norm()) * scale
                              for (n, _t), g in zip(named, grads)}
                first_sample = {n: g.flatten()[sample[n]].float() * scale
                                for (n, _t), g in zip(named, grads) if sample}
            lr = dense.learning_rate(step, opt)
            b1c, b2c = 1 - opt["b1"] ** (step + 1), 1 - opt["b2"] ** (step + 1)
            for (_n, p), g, (m, v) in zip(named, grads, moments):
                gi = g.float() * scale
                m.mul_(opt["b1"]).add_(gi, alpha=1 - opt["b1"])
                v.mul_(opt["b2"]).addcmul_(gi, gi, value=1 - opt["b2"])
                upd = (m / b1c) / ((v / b2c).sqrt() + opt["eps"])
                upd += opt["weight_decay"] * p.float()
                p -= (lr * upd).to(p.dtype)
        del grads
    return {"loss": losses, "grad": first_grad, "grad_sample": first_sample}
