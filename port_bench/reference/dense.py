"""Plain reference of the dense decoder (the ``dense`` family: yi-9b).

Written from the model's equations in plain PyTorch, with no kernel and
nothing of the program: pre-norm blocks of GQA attention with RoPE and a
SwiGLU MLP; the RMS norm x * rsqrt(mean(x^2) + eps) * (1 + scale) in
float32; the embedding scaled by sqrt(d_model); the mean next-token cross
entropy; AdamW with global-norm clipping under a warmup-cosine rate.

``precision`` says how it computes.  "f32", the reference that judges
the program: every activation and product in float32 (no TF32).  "bf16":
activations in the configuration's ``compute_dtype`` and products of
bfloat16 operands with float32 accumulation, as the configurations state;
softmax and norms in float32.  "fp8", the control, computes every
product as fp8 training does: each operand of each product (weights,
activations, the attention's probabilities) rounded to float8_e4m3 with
one scale a tensor, and in the backward the gradient each product receives
rounded to float8_e5m2 the same way; the rounding itself passes the
gradient straight through.

The other families reuse these pieces and bring their own ``block``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}  # largest finite
BF16 = torch.bfloat16
UPDATE_CHUNK = 1 << 26  # elements of a leaf the optimizer updates at a time


def setup_precision() -> None:
    """float32 products stay float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product takes it: in bfloat16 or float32, or rounded to
    fp8 first."""
    if precision == "f32":
        return x.float()
    x = x.to(BF16)
    if precision == "bf16":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    q = fp8_round(x.detach(), torch.float8_e4m3fn).to(BF16)
    return x + (q - x.detach())


def fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (an fp8 type) under one scale, its amax
    at the type's largest finite value; in float32."""
    scale = x.abs().amax().float().clamp(min=1e-30) / FP8_MAX[dtype]
    return (x.float() / scale).to(dtype).float() * scale


class _GradFp8(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8_e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return fp8_round(grad, torch.float8_e5m2).to(grad.dtype)


def product(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's output, through which its gradient arrives."""
    return _GradFp8.apply(y) if precision == "fp8" and y.requires_grad else y


def mm(a, b, precision: str) -> torch.Tensor:
    return product(operand(a, precision) @ operand(b, precision), precision)


def rms_norm(x, scale, eps: float) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x, theta: float) -> torch.Tensor:
    """Rotate the two halves of each head by position p times
    theta^(-i / half), i < half.  x: [B, S, H, hd]."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1).to(x.dtype)


def causal_attention(q, k, v, precision: str) -> torch.Tensor:
    """q [B, S, H, hd]; k, v [B, S, KV, hd]: query head h reads key head
    h // (H / KV).  Scores and softmax in float32."""
    hd, group, dtype = q.shape[-1], q.shape[2] // k.shape[2], q.dtype
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)
    q, k, v = (operand(t, precision).float() for t in (q, k, v))
    scores = product(torch.einsum("bqhd,bkhd->bhqk", q, k), precision) / math.sqrt(hd)
    s = scores.shape[-1]
    future = torch.ones(s, s, dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
    probs = operand(probs, precision).float()
    return product(torch.einsum("bhqk,bkhd->bqhd", probs, v), precision).to(dtype)


def attention_part(cfg: dict, p: dict, x, precision: str) -> torch.Tensor:
    B, S, _ = x.shape
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    h = rms_norm(x, p["ln1"], cfg["norm_eps"])
    q = rope(mm(h, p["wq"], precision).to(x.dtype).view(B, S, H, hd),
             cfg["rope_theta"])
    k = rope(mm(h, p["wk"], precision).to(x.dtype).view(B, S, KV, hd),
             cfg["rope_theta"])
    v = mm(h, p["wv"], precision).to(x.dtype).view(B, S, KV, hd)
    o = causal_attention(q, k, v, precision).reshape(B, S, H * hd)
    return x + mm(o, p["wo"], precision).to(x.dtype)


def swiglu(h, w_gate, w_up, w_down, precision: str) -> torch.Tensor:
    g = mm(h, w_gate, precision).to(h.dtype)
    u = mm(h, w_up, precision).to(h.dtype)
    return mm(F.silu(g) * u, w_down, precision).to(h.dtype)


def block(cfg: dict, p: dict, x, precision: str):
    """One dense block: (x, aux losses) with no aux losses."""
    x = attention_part(cfg, p, x, precision)
    h = rms_norm(x, p["ln2"], cfg["norm_eps"])
    mlp = p["mlp"]
    x = x + swiglu(h, mlp["w_gate"], mlp["w_up"], mlp["w_down"], precision).to(x.dtype)
    return x, {}


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked tree as views (one ``unbind`` a leaf,
    whose gradient is one stack)."""
    if isinstance(tree, dict):
        subs = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: sub[i] for k, sub in subs.items()} for i in range(n)]
    return tree.unbind(0)


def hidden(cfg: dict, params: dict, tokens, precision: str, block_fn=block):
    """Final normed hidden states [B, S, D] and the blocks' aux losses
    summed.  Under autograd each block is recomputed in the backward, so
    that one block's activations are alive at a time."""
    (kind,) = set(cfg["layer_pattern"])
    layers = _unbind(params["blocks"][kind], cfg["num_layers"])
    dtype = torch.float32 if precision == "f32" else getattr(torch, cfg["compute_dtype"])
    x = params["embed"][tokens].to(dtype) * math.sqrt(cfg["d_model"])
    grad = torch.is_grad_enabled()
    aux_total: dict = {}
    for p in layers:
        if grad:
            x, aux = checkpoint(lambda x, p: block_fn(cfg, p, x, precision), x, p,
                                use_reentrant=False)
        else:
            x, aux = block_fn(cfg, p, x, precision)
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v
    return rms_norm(x, params["final_norm"], cfg["norm_eps"]), aux_total


def loss(cfg: dict, params: dict, batch: dict, precision: str, block_fn=block):
    """Mean next-token cross entropy over bf16 logits, plus the aux losses
    at the configuration's weights."""
    x, aux = hidden(cfg, params, batch["tokens"], precision, block_fn)
    logits = mm(x, params["lm_head"], precision).float()[..., :cfg["vocab_size"]]
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, batch["targets"][..., None])[..., 0]
    total = (lse - tgt).mean()
    for name, weight in cfg.get("aux_loss_weights", {}).items():
        total = total + weight * aux[name]
    return total


@torch.no_grad()
def logits_at(cfg: dict, params: dict, tokens, positions, precision: str,
              block_fn=block) -> torch.Tensor:
    """Float32 logits [len(positions), vocab] of one sequence ``tokens``
    [1, T] at ``positions``; the head in float32 whatever ``precision``,
    so that near-equal logits stay apart."""
    setup_precision()
    x, _aux = hidden(cfg, params, tokens, precision, block_fn)
    rows = operand(x[0, positions], precision).float()
    return rows @ operand(params["lm_head"], precision).float()[:, :cfg["vocab_size"]]


def learning_rate(step: int, opt: dict) -> float:
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * min((step + 1) / max(warm, 1), 1.0)
    progress = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * progress)))


def leaves(tree: dict, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) in sorted key order."""
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out += leaves(tree[key], f"{prefix}/{key}")
        else:
            out.append((f"{prefix}/{key}", tree[key]))
    return out


def train(cfg: dict, params: dict, batches: list[dict], opt: dict,
          precision: str, sample: dict | None = None, block_fn=block) -> dict:
    """AdamW steps on ``batches`` from ``params`` (updated in place).
    Returns each step's loss and, per leaf, the first step's gradient after
    clipping (what the optimizer takes): its norm, and its values at the
    flat indices ``sample[path]``."""
    setup_precision()
    named = leaves(params)
    moments = [(torch.zeros_like(t), torch.zeros_like(t)) for _n, t in named]
    losses, first_grad = [], {}
    for step, batch in enumerate(batches):
        for _n, t in named:
            t.requires_grad_(True)
        try:
            value = loss(cfg, params, batch, precision, block_fn)
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
            lr = learning_rate(step, opt)
            b1c, b2c = 1 - opt["b1"] ** (step + 1), 1 - opt["b2"] ** (step + 1)
            for (_n, p), g, (m, v) in zip(named, grads, moments):
                rows = max(1, UPDATE_CHUNK // max(p[0].numel() if p.dim() else 1, 1))
                for i in range(0, p.shape[0] if p.dim() else 1, rows):
                    sl = slice(i, i + rows) if p.dim() else ...
                    gi = g[sl].float() * scale
                    m[sl].mul_(opt["b1"]).add_(gi, alpha=1 - opt["b1"])
                    v[sl].mul_(opt["b2"]).addcmul_(gi, gi, value=1 - opt["b2"])
                    upd = (m[sl] / b1c) / ((v[sl] / b2c).sqrt() + opt["eps"])
                    upd += opt["weight_decay"] * p[sl].float()
                    p[sl] -= (lr * upd).to(p.dtype)
        del grads
    return {"loss": losses, "grad": first_grad, "grad_sample": first_sample}
