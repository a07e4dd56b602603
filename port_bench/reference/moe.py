"""Plain reference of the mixture-of-experts decoder (the ``moe`` family:
olmoe-1b-7b).

Each block is the dense family's attention and, in place of the MLP, a
routed FFN written from its definition:

* router logits in float32 from the normed input; softmax; the
  ``experts_per_token`` largest probabilities, equal ones to the lower
  expert index, renormalised to sum to one;
* capacity ``max(int(capacity_factor * S * k / E), 1)`` slots an expert in
  each batch row; a row's slots are taken in token order (token t's k
  choices in rank order), and a slot beyond its expert's capacity is
  dropped: it adds nothing;
* each expert a SwiGLU over the tokens it kept; the token's output the sum
  over its kept slots of probability times expert output, in float32;
* aux losses: load balance E * sum_e f_e P_e (f_e: the share of tokens
  whose first choice is e; P_e: the mean probability of e) and the mean
  squared log-sum-exp of the router logits.
"""

from __future__ import annotations

import torch

from port_bench.reference import dense


def routed_ffn(cfg: dict, p: dict, h, precision: str):
    """h [B, S, D] -> (out [B, S, D] in h's dtype, aux losses)."""
    B, S, D = h.shape
    E, k = cfg["num_experts"], cfg["experts_per_token"]
    capacity = max(int(cfg["capacity_factor"] * S * k / E), 1)
    logits = h.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True)
    rows = []
    for b in range(B):
        expert = top_e[b].reshape(-1)  # slot s = token s // k, rank s % k
        weight = top_p[b].reshape(-1)
        out = torch.zeros(S, D, dtype=torch.float32, device=h.device)
        for e in range(E):
            slots = torch.nonzero(expert == e)[:capacity, 0]
            if slots.numel() == 0:
                continue
            tok = slots // k
            y = dense.swiglu(h[b, tok], p["w_gate"][e], p["w_up"][e],
                             p["w_down"][e], precision)
            out = out.index_add(0, tok, y.float() * weight[slots, None])
        rows.append(out)
    first = torch.nn.functional.one_hot(top_e[..., 0], E).float()
    aux = {
        "moe_lb_loss": E * torch.sum(first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))),
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
    }
    return torch.stack(rows).to(h.dtype), aux


def block(cfg: dict, p: dict, x, precision: str):
    x = dense.attention_part(cfg, p, x, precision)
    out, aux = routed_ffn(cfg, p["moe"], dense.rms_norm(x, p["ln2"], cfg["norm_eps"]),
                          precision)
    return x + out, aux


def loss(cfg, params, batch, precision):
    return dense.loss(cfg, params, batch, precision, block)


def logits_at(cfg, params, tokens, positions, precision):
    return dense.logits_at(cfg, params, tokens, positions, precision, block)


def train(cfg, params, batches, opt, precision, sample=None):
    return dense.train(cfg, params, batches, opt, precision, sample, block)
