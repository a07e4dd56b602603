"""Mixture-of-Experts FFN with capacity-based dispatch (the JAX package's
``models/moe.py`` at one device).

Routing: top-k (llama4: k=1 + shared expert; olmoe: k=8).  Dispatch is the
GShard scatter/gather pattern, grouped over batch rows:

  1. router logits -> top-k (expert id, prob) per token;
  2. position-in-expert via a cumulative sum over the one-hot choice (or a
     stable sort, the same assignment); tokens beyond
     ``capacity = cf * S * k / E`` are dropped to the residual path;
  3. token activations are written into a dense [B, E, C + 1, D] buffer
     whose last slot takes every dropped token and is sliced off;
  4. batched expert SwiGLU over the stacked [E, D, F] weights;
  5. gather back, scale by router prob, sum over the k slots.

Equal router probabilities go to the lower expert index, as
``jax.lax.top_k`` orders them (``torch.topk`` promises no order among
ties).  Every index operation is one that is deterministic on the card
under ``torch.use_deterministic_algorithms``: ``index_put`` without
accumulate, gathers by advanced indexing (whose gradient is an
accumulating ``index_put``), ``argsort(stable=True)`` and ``cumsum`` over
integers.

Expert parallelism (the JAX package's): under sharding rules the expert
weights are split over the ``model`` mesh axis and the activations are
replicated on it.  Each rank routes its batch rows as a lone device would
(the same routing on every ``model`` rank), scatters only the slots of its
own experts, runs its expert shards and gathers their slots back, zeros in
the slots of other ranks' experts; the sum of those tensors over ``model``
is exact, each slot having one owner, and the weighting by router
probability and the sum over k follow in the unsharded order.  No token
moves between ranks (no all-to-all), and no expert weight is gathered over
``model``.

The expert products are batched products, as the JAX package computes
them outside any Pallas kernel.  Two profiler spans, ``moe_ffn`` and
``moe_experts`` (inside it), let a profile split the FFN's device time
into routing and dispatch against the expert products.

Dropless dispatch (``dispatch="dropless"``, DeepSeek's): no capacity and
no dropped slot.  The token-major slots are sorted by expert (a stable
argsort), the tokens gathered in that order, the experts' SwiGLU run as
grouped products over each expert's run of rows (``torch._grouped_mm`` on
CUDA tensors, a loop over the experts on CPU tensors), and the outputs
scattered back to slot order.  The sort, gather and scatter are the span
``moe_dispatch``.  Expert parallelism and the dropless dispatch are not
combined.

Aux losses: Switch load-balance loss + router z-loss, returned to the caller
(weighted into the training objective), and the fraction of dropped slots.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.kernels import _shard
from repro_torch.kernels._shard import is_dtensor

from repro_torch.models.common import ParamSpec, fan_in_normal


def moe_param_specs(layers: int, d: int, f_expert: int, n_experts: int,
                    n_shared: int, d_shared_ff: int) -> dict:
    specs = {
        "router": ParamSpec(
            (layers, d, n_experts), ("layers", "d_model_fsdp", "experts"),
            stddev=fan_in_normal((d, n_experts)),
        ),
        "w_gate": ParamSpec(
            (layers, n_experts, d, f_expert),
            ("layers", "experts", "d_model_fsdp", "d_ff"),
            stddev=fan_in_normal((d, f_expert)),
        ),
        "w_up": ParamSpec(
            (layers, n_experts, d, f_expert),
            ("layers", "experts", "d_model_fsdp", "d_ff"),
            stddev=fan_in_normal((d, f_expert)),
        ),
        "w_down": ParamSpec(
            (layers, n_experts, f_expert, d),
            ("layers", "experts", "d_ff", "d_model_fsdp"),
            stddev=fan_in_normal((f_expert, d)),
        ),
    }
    if n_shared > 0:
        specs["shared_w_gate"] = ParamSpec(
            (layers, d, d_shared_ff), ("layers", "d_model_fsdp", "d_ff"),
            stddev=fan_in_normal((d, d_shared_ff)),
        )
        specs["shared_w_up"] = ParamSpec(
            (layers, d, d_shared_ff), ("layers", "d_model_fsdp", "d_ff"),
            stddev=fan_in_normal((d, d_shared_ff)),
        )
        specs["shared_w_down"] = ParamSpec(
            (layers, d_shared_ff, d), ("layers", "d_ff", "d_model_fsdp"),
            stddev=fan_in_normal((d_shared_ff, d)),
        )
    return specs


def position_in_expert_onehot(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """GShard-literal positions: cumsum over a [..., T*k, E] one-hot.

    ``flat_e``: [..., N] expert ids in token order; returns each slot's
    position among the slots of its expert, in token order."""
    onehot = F.one_hot(flat_e, num_experts)
    pos_in_e = torch.cumsum(onehot, dim=-2) - onehot
    return torch.sum(pos_in_e * onehot, dim=-1)


def position_in_expert_sort(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Sort-based positions: O(T*k) memory, identical assignment.

    A stable argsort groups slots by expert while preserving token order, so
    position-in-expert is the rank within the sorted run; the inverse
    permutation (a second argsort) puts it back in token order."""
    n = flat_e.shape[-1]
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, -1, order)
    experts = torch.arange(num_experts, device=flat_e.device)
    starts = torch.searchsorted(
        sorted_e, experts.expand(*flat_e.shape[:-1], -1).contiguous())
    pos_sorted = torch.arange(n, device=flat_e.device) - torch.gather(starts, -1, sorted_e)
    return torch.gather(pos_sorted, -1, torch.argsort(order, dim=-1))


def top_k_lowest_index_first(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, equal
    values in increasing index order, as ``jax.lax.top_k`` returns them."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_ffn(
    x: torch.Tensor,
    params: dict,
    *,
    num_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    compute_dtype=torch.bfloat16,
    dispatch: str = "onehot",  # "onehot" (GShard) | "sort" (O(S*k)) | "dropless"
    norm_topk_prob: bool = True,
    aux: bool = True,
) -> tuple[torch.Tensor, dict]:
    """x: [B, S, D] -> (out [B, S, D], aux metrics/losses).

    ``aux=False`` (a caller that discards them: prefill and decode) skips
    the aux statistics and returns no aux values; the output is the same.

    **Grouped dispatch**: routing positions, the [E, C, D] scatter and the
    gather-back are computed per batch row, so a row's tokens never compete
    with another row's for capacity.

    ``params`` holds per-layer slices: router [D, E], w_gate/w_up [E, D, F],
    w_down [E, F, D] (+ optional shared_* dense weights).

    A DTensor ``x`` runs shard by shard over its batch rows (routing is per
    row) and over the experts' shards (``_shard.run_split``), the router and
    the shared expert gathered whole; the aux losses are formed from the
    token means of every shard (``_aux``), so they equal the unsharded ones.
    """
    kw = dict(num_experts=num_experts, top_k=top_k,
              capacity_factor=capacity_factor, compute_dtype=compute_dtype,
              dispatch=dispatch, norm_topk_prob=norm_topk_prob)
    if is_dtensor(x):
        if dispatch == "dropless":
            raise NotImplementedError("the dropless dispatch runs on one device")
        out, stats = _shard.run_split(
            lambda xl, pl, part: _moe_core(xl, pl, part=part, **kw), x, params,
            EXPERT_WEIGHTS)
    else:
        out, stats = _moe_core(x, params, stats=aux, **kw)
        if not aux:
            return out, {}
    return out, _aux(stats, num_experts)


def _aux(stats: dict, E: int) -> dict:
    """Switch load-balance E * sum_e f_e * P_e (f = the fraction of tokens
    whose first choice is e, P = the mean router prob for e), the z-loss
    and the fraction of slots dropped, from token means."""
    return {
        "moe_lb_loss": E * torch.sum(stats["dispatch_frac"] * stats["mean_prob"]),
        "moe_z_loss": stats["z_mean"],
        "moe_drop_fraction": 1.0 - stats["keep_mean"],
    }


EXPERT_WEIGHTS = ("w_gate", "w_up", "w_down")  # per layer: [E, ...]


def _moe_core(x, params, *, num_experts, top_k, capacity_factor,
              compute_dtype, dispatch, norm_topk_prob=True, part=None, stats=True):
    """(out, token means, or None without ``stats``) of ``moe_ffn`` on plain
    tensors.  With ``part``
    (a ``_shard.Split``) the expert weights are the slice ``part.offset``
    + ``part.size`` of the experts, and only their slots are computed here;
    ``part.total`` sums the slots over the ranks that hold the others."""
    with record_function("moe_ffn"):
        B, S, D = x.shape
        E = num_experts
        capacity = max(int(capacity_factor * S * top_k / E), 1)

        router_logits = x.float() @ params["router"].float()  # [B, S, E]
        if part is not None:
            router_logits = part.once(router_logits)
        probs = torch.softmax(router_logits, dim=-1)
        top_p, top_e = top_k_lowest_index_first(probs, top_k)  # [B, S, k]
        if norm_topk_prob:
            # Normalise the selected probabilities (Mixtral/OLMoE convention).
            top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
        if dispatch == "dropless":
            out = _with_shared(_dropless(x, params, top_e, top_p, compute_dtype), x,
                               params, compute_dtype, part)
            return out, (_stats(top_e, probs, router_logits,
                                torch.ones((), device=x.device), E) if stats else None)

        flat_e = top_e.reshape(B, S * top_k)
        pos_fn = (position_in_expert_sort if dispatch == "sort"
                  else position_in_expert_onehot)
        pos = pos_fn(flat_e, E)  # [B, S*k]
        keep = pos < capacity
        safe_pos = torch.where(keep, pos, capacity)
        rows = torch.arange(B, device=x.device)[:, None].expand(B, S * top_k)

        # The slots computed here: every slot, or those of this rank's
        # experts (the others write expert 0's overflow slot).
        mine, slot_e, slot_pos, n_e = keep, flat_e, safe_pos, E
        if part is not None:
            local_e = flat_e - part.offset
            here = (local_e >= 0) & (local_e < part.size)
            mine, n_e = keep & here, part.size
            slot_e = torch.where(here, local_e, 0)
            slot_pos = torch.where(mine, pos, capacity)

        # Every dropped slot writes the overflow slot ``capacity``, in any
        # order; that slot is sliced off.
        slots = x.to(compute_dtype).repeat_interleave(top_k, dim=1)  # [B, S*k, D]
        buf = torch.zeros((B, n_e, capacity + 1, D), dtype=compute_dtype,
                          device=x.device)
        buf = buf.index_put((rows, slot_e, slot_pos), slots)[:, :, :capacity]

        with record_function("moe_experts"):
            g = torch.einsum("becd,edf->becf", buf,
                             params["w_gate"].to(compute_dtype))
            u = torch.einsum("becd,edf->becf", buf, params["w_up"].to(compute_dtype))
            out_buf = torch.einsum("becf,efd->becd", F.silu(g) * u,
                                   params["w_down"].to(compute_dtype))

        # Gather back per row and combine over the k slots.
        gathered = out_buf[rows, slot_e, torch.clamp(slot_pos, max=capacity - 1)]
        gathered = torch.where(mine[..., None], gathered, 0.0)
        if part is not None:
            gathered = part.total(gathered)  # each slot from its expert's rank
        weighted = gathered.float() * top_p.reshape(B, S * top_k, 1)
        out = weighted.reshape(B, S, top_k, D).sum(dim=2)
        out = _with_shared(out, x, params, compute_dtype, part)
        return out, (_stats(top_e, probs, router_logits, torch.mean(keep.float()), E)
                     if stats else None)


def _with_shared(out, x, params, compute_dtype, part):
    """The routed output (f32) plus the shared expert's, in x's dtype."""
    if "shared_w_gate" in params:
        xc = x.to(compute_dtype)
        sg = xc @ params["shared_w_gate"].to(compute_dtype)
        su = xc @ params["shared_w_up"].to(compute_dtype)
        shared = (F.silu(sg) * su) @ params["shared_w_down"].to(compute_dtype)
        if part is not None:
            shared = part.once(shared)
        out = out + shared.float()
    return out.to(x.dtype)


def _stats(top_e, probs, router_logits, keep_mean, E: int) -> dict:
    return {
        "dispatch_frac": F.one_hot(top_e[..., 0], E).float().mean(dim=(0, 1)),
        "mean_prob": probs.mean(dim=(0, 1)),
        "z_mean": torch.mean(torch.logsumexp(router_logits, dim=-1) ** 2),
        "keep_mean": keep_mean,
    }


def grouped_swiglu(xs: torch.Tensor, ends: torch.Tensor, w_gate, w_up, w_down,
                   compute_dtype) -> torch.Tensor:
    """Each expert's SwiGLU over its run of rows: ``xs`` [N, D] sorted by
    expert, ``ends`` [E] the end offset of each expert's run; w_gate/w_up
    [E, D, F], w_down [E, F, D].  On CUDA tensors three grouped products
    (``torch._grouped_mm``); on CPU tensors a loop over the experts that
    hold rows."""
    wg, wu, wd = (w.to(compute_dtype) for w in (w_gate, w_up, w_down))
    if xs.device.type == "cuda":
        offs = ends.to(torch.int32)
        g = torch._grouped_mm(xs, wg, offs=offs)
        u = torch._grouped_mm(xs, wu, offs=offs)
        return torch._grouped_mm(F.silu(g) * u, wd, offs=offs)
    runs = torch.split(xs, (ends - F.pad(ends[:-1], (1, 0))).tolist())
    return torch.cat([(F.silu(r @ wg[e]) * (r @ wu[e])) @ wd[e]
                      for e, r in enumerate(runs) if r.shape[0]])


def _dropless(x, params, top_e, top_p, compute_dtype) -> torch.Tensor:
    """Every slot through its expert: [B, S, D] f32, the sum over each
    token's k slots of probability times expert output.  Nothing here reads
    the device from the host (the runs' ends come from a search of the
    sorted experts, not from a count on the host)."""
    B, S, D = x.shape
    k, E = top_e.shape[-1], params["w_gate"].shape[0]
    flat_e = top_e.reshape(-1)  # slot = token * k + rank
    with record_function("moe_dispatch"):
        sorted_e, order = torch.sort(flat_e, stable=True)
        ends = torch.searchsorted(sorted_e, torch.arange(E, device=x.device), right=True)
        xs = x.reshape(B * S, D).to(compute_dtype).index_select(0, order // k)
    with record_function("moe_experts"):
        ys = grouped_swiglu(xs, ends, params["w_gate"], params["w_up"],
                            params["w_down"], compute_dtype)
    with record_function("moe_dispatch"):
        slots = torch.empty_like(ys).index_copy(0, order, ys)
        weighted = slots.float() * top_p.reshape(-1, 1)
        return weighted.reshape(B, S, k, D).sum(dim=2)
