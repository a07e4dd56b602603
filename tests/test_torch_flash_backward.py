"""The flash-attention gradient of the port on the CPU: the two plain
versions the card's kernels are held against, the custom ops around them
and the autograd Function that routes to them.

* ``attention_lse_reference`` (what the forward kernel writes beside its
  output) against ``jax.nn.logsumexp`` of the masked scores as the JAX
  package's ``attention_reference`` forms them;
* ``flash_backward_reference`` (what the backward kernel computes: P from
  that log-sum-exp, Delta from dO . O) against ``jax.grad`` of
  ``repro.models.attention.attention``, within 1e-5 in float32, over
  causal +- window, non-causal, Sq != Skv, G in {1, 2, 5}, ragged S and
  head_dim 16 to 64;
* ``FlashAttentionFunction`` on CPU tensors: the lse op forward, the
  backward op's plain route;
* the ``repro_torch::flash_attention_lse`` and
  ``repro_torch::flash_attention_backward`` ops under ``FakeTensorMode``
  (shapes and dtypes, no arithmetic, no launch), under ``FlopCounterMode``
  (counted as the library counts SDPA and its backward), and with meta
  tensors, which reach the kernels' wrappers and never the plain versions;
* ``backward_split``, the rule, from the shapes alone, that splits a KV
  head's query heads among blocks of the dK/dV pass.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode, sdpa_backward_flop_count

from repro.models import attention as jax_attn
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import FlashAttentionFunction
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_reference,
    attention_lse_reference,
    attention_reference,
    flash_backward_reference,
)
from repro_torch.models import attention as port_attn

TOL = 1e-5  # tests/test_torch_grad.py's tolerance for the gradients

# (b, sq, skv, h, kv, d, causal, window): no case leaves a query row
# without a visible key (there the JAX package attends uniformly, the
# kernels give 0: ROADMAP section 3).
CASES = [
    (2, 24, 24, 4, 2, 16, True, 0),     # GQA, G = 2
    (1, 40, 40, 5, 1, 16, True, 8),     # G = 5, a window shorter than S
    (1, 33, 33, 2, 2, 32, True, 0),     # MHA, ragged S
    (1, 20, 30, 4, 4, 64, False, 0),    # cross: Sq < Skv, no mask
    (1, 30, 20, 4, 2, 32, False, 0),    # Sq > Skv, no mask
    (2, 17, 17, 5, 1, 16, False, 6),    # non-causal window, G = 5
    (1, 64, 64, 2, 1, 64, True, 16),    # D = 64, G = 2, window
    (1, 45, 45, 5, 5, 32, True, 7),     # G = 1, ragged, window
    (1, 50, 40, 2, 1, 16, True, 0),     # causal, Sq > Skv
]
IDS = [f"b{c[0]}-sq{c[1]}-skv{c[2]}-h{c[3]}-kv{c[4]}-d{c[5]}-"
       f"{'causal' if c[6] else 'full'}-w{c[7]}" for c in CASES]


def _inputs(case, seed=0):
    """q, g [B, Sq, H, D]; k, v [B, Skv, KV, D] in float32 (the JAX layout)."""
    b, sq, skv, h, kv, d, _causal, _window = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    g = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, g


def _heads_first(x: np.ndarray) -> torch.Tensor:
    """[B, S, H, D] numpy -> the kernels' [B, H, S, D] torch layout."""
    return torch.from_numpy(x).transpose(1, 2)


def _jax_lse(q, k, causal, window):
    """logsumexp over keys of the scores as the JAX package's
    ``attention_reference`` forms them, masked keys at -inf: [B, H, Sq]."""
    B, Sq, H, D = q.shape
    KV, Skv = k.shape[2], k.shape[1]
    qg = jnp.asarray(q).reshape(B, Sq, KV, H // KV, D)
    scores = jnp.einsum("bqkgd,bskd->bkgqs", qg, jnp.asarray(k)) / math.sqrt(D)
    q_pos, k_pos = jnp.arange(Sq)[:, None], jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    lse = jax.nn.logsumexp(jnp.where(mask, scores, -jnp.inf), axis=-1)
    return np.asarray(lse).reshape(B, H, Sq)


def _plain_forward(q, k, v, causal, window):
    rep = q.shape[1] // k.shape[1]
    return attention_reference(q, k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1),
                               causal=causal, window=window)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_lse_reference_equals_jax_logsumexp(case):
    q, k, _v, _g = _inputs(case)
    causal, window = case[6], case[7]
    got = attention_lse_reference(_heads_first(q), _heads_first(k), causal=causal,
                                  window=window)
    assert got.dtype == torch.float32 and got.shape == (case[0], case[3], case[1])
    np.testing.assert_allclose(got.numpy(), _jax_lse(q, k, causal, window), atol=TOL,
                               rtol=0)


def test_lse_of_a_row_without_keys_is_inf_and_its_gradient_zero():
    """A window without the causal mask can leave a query no key: its lse is
    +inf, so P = 0 on its row, as the forward kernel writes 0 there."""
    rng = np.random.default_rng(4)
    q, d_out = (torch.from_numpy(rng.standard_normal((1, 2, 12, 16)).astype(np.float32))
                for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((1, 1, 5, 16)).astype(np.float32))
            for _ in range(2))
    lse = attention_lse_reference(q, k, causal=True, window=3)
    assert torch.isinf(lse[..., 7:]).all() and (lse[..., 7:] > 0).all()
    assert torch.isfinite(lse[..., :7]).all()
    out = torch.zeros_like(q)
    out[..., :7, :] = _plain_forward(q, k, v, True, 3)[..., :7, :]
    dq, dk, dv = flash_backward_reference(q, k, v, out, d_out, lse, causal=True, window=3)
    assert torch.equal(dq[..., 7:, :], torch.zeros_like(dq[..., 7:, :]))
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flash_backward_reference_equals_jax_grad(case):
    q, k, v, g = _inputs(case, seed=1)
    causal, window = case[6], case[7]

    def f(q, k, v):
        return jnp.sum(jax_attn.attention(q, k, v, causal=causal, window=window) * g)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tg = map(_heads_first, (q, k, v, g))
    out = _plain_forward(tq, tk, tv, causal, window)
    lse = attention_lse_reference(tq, tk, causal=causal, window=window)
    got = flash_backward_reference(tq, tk, tv, out, tg, lse, causal=causal, window=window)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.transpose(1, 2).numpy(), np.asarray(wt), atol=TOL,
                                   rtol=0)
    # and the explicit gradient, the card's oracle, agrees with it
    oracle = attention_backward_reference(tq, tk, tv, out, tg, causal=causal, window=window)
    for gt, ot in zip(got, oracle):
        torch.testing.assert_close(gt, ot, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[4]], ids=[IDS[0], IDS[1], IDS[4]])
def test_function_cpu_route_is_the_lse_op_and_the_plain_backward(case):
    """On CPU tensors the Function's forward saves the plain log-sum-exp and
    its backward returns ``flash_backward_reference``'s gradients, bit for
    bit; the model's entry point takes the Function under autograd."""
    q, k, v, g = _inputs(case, seed=2)
    causal, window = case[6], case[7]
    tq, tk, tv = (_heads_first(x).requires_grad_() for x in (q, k, v))
    tg = _heads_first(g)
    out = FlashAttentionFunction.apply(tq, tk, tv, causal, window)
    assert "FlashAttentionFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    lse = attention_lse_reference(tq.detach(), tk.detach(), causal=causal, window=window)
    want = flash_backward_reference(tq.detach(), tk.detach(), tv.detach(), out.detach(), tg,
                                    lse, causal=causal, window=window)
    for gt, wt in zip(got, want):
        assert torch.equal(gt, wt)
    assert torch.equal(out.detach(), _plain_forward(tq.detach(), tk.detach(), tv.detach(),
                                                    causal, window))
    mq, mk, mv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    model_out = port_attn.attention(mq, mk, mv, causal=causal, window=window)
    fn = model_out.grad_fn
    names = [type(fn).__name__] + [type(f[0]).__name__ for f in fn.next_functions if f[0]]
    assert any("FlashAttentionFunction" in n for n in names), names


def test_cuda_path_never_calls_the_explicit_gradient():
    """``attention_backward_reference`` is the oracle of the tests and the
    card's checks; the ops module, which every model call goes through,
    does not reach it."""
    assert not hasattr(flash_ops, "attention_backward_reference")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_under_fake_tensor_mode_give_shapes_only(dtype, monkeypatch):
    def must_not_run(*_a, **_k):
        raise AssertionError("a plain version ran under FakeTensorMode")

    for name in ("attention_reference", "attention_lse_reference",
                 "flash_backward_reference"):
        monkeypatch.setattr(flash_ops, name, must_not_run)
    before = (flash_kernel.LAUNCHES, flash_kernel.BACKWARD_LAUNCHES)
    with FakeTensorMode():
        q = torch.empty(2, 6, 40, 32, dtype=dtype)
        k = torch.empty(2, 3, 50, 32, dtype=dtype)
        v = torch.empty(2, 3, 50, 32, dtype=dtype)
        out, lse = torch.ops.repro_torch.flash_attention_lse(q, k, v, True, 0)
        dq, dk, dv = torch.ops.repro_torch.flash_attention_backward(
            q, k, v, out, torch.empty_like(out), lse, True, 0)
    assert (out.shape, out.dtype) == (q.shape, dtype)
    assert (lse.shape, lse.dtype) == ((2, 6, 40), torch.float32)
    assert [(t.shape, t.dtype) for t in (dq, dk, dv)] == [
        (q.shape, dtype), (k.shape, dtype), (v.shape, dtype)]
    assert (flash_kernel.LAUNCHES, flash_kernel.BACKWARD_LAUNCHES) == before


@pytest.mark.parametrize("b,h,kv,sq,skv,d", [(2, 6, 3, 40, 40, 32), (1, 5, 1, 17, 30, 16)])
def test_flop_counter_counts_the_ops_as_the_library_counts_sdpa(b, h, kv, sq, skv, d):
    gen = torch.Generator().manual_seed(5)
    q = torch.randn(b, h, sq, d, generator=gen, requires_grad=True)
    k = torch.randn(b, kv, skv, d, generator=gen, requires_grad=True)
    v = torch.randn(b, kv, skv, d, generator=gen, requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        out = FlashAttentionFunction.apply(q, k, v, False, 0)
        out.backward(torch.ones_like(out))
    counts = counter.get_flop_counts()["Global"]
    assert counts[torch.ops.repro_torch.flash_attention_lse] == 4 * b * h * sq * skv * d
    assert counts[torch.ops.repro_torch.flash_attention_backward] == sdpa_backward_flop_count(
        (b, h, sq, d), (b, h, sq, d), (b, kv, skv, d), (b, kv, skv, d))
    # the explicit gradient's five einsums counted the same 10 B H Sq Skv D
    assert counts[torch.ops.repro_torch.flash_attention_backward] == 10 * b * h * sq * skv * d


def test_meta_tensors_reach_the_kernel_wrappers_not_the_plain_versions(monkeypatch):
    """The ops' implementations (what a CUDA tensor runs) hand a non-CPU
    tensor to the kernels' wrappers, which refuse anything but a CUDA
    tensor; through the public ops a meta tensor takes the fake impls."""
    def must_not_run(*_a, **_k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    for name in ("attention_reference", "attention_lse_reference",
                 "flash_backward_reference"):
        monkeypatch.setattr(flash_ops, name, must_not_run)
    before = (flash_kernel.LAUNCHES, flash_kernel.BACKWARD_LAUNCHES,
              dict(flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT))
    for dtype in (torch.float32, torch.bfloat16):  # either variant
        q = torch.zeros(1, 2, 8, 32, device="meta", dtype=dtype)
        k = torch.zeros(1, 1, 8, 32, device="meta", dtype=dtype)
        lse = torch.zeros(1, 2, 8, device="meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            flash_ops._forward_lse_impl(q, k, k, True, 0)
        with pytest.raises(ValueError, match="CUDA tensor"):
            flash_ops._backward_impl(q, k, k, q, q, lse, True, 0)
        out, out_lse = torch.ops.repro_torch.flash_attention_lse(q, k, k, True, 0)
        grads = torch.ops.repro_torch.flash_attention_backward(q, k, k, q, q, lse, True, 0)
        assert all(t.device.type == "meta" for t in (out, out_lse, *grads))
    assert (flash_kernel.LAUNCHES, flash_kernel.BACKWARD_LAUNCHES,
            flash_kernel.BACKWARD_LAUNCHES_BY_VARIANT) == before


def test_backward_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 2, 8, 32)
    k = torch.zeros(1, 1, 8, 32)
    before = flash_kernel.BACKWARD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_kernel.flash_attention_backward_cuda(q, k, k, q, q, torch.zeros(1, 2, 8))
    assert flash_kernel.BACKWARD_LAUNCHES == before


def test_incoming_gradient_is_made_readable_by_the_tma_unit():
    """Autograd picks the incoming gradient's layout: an expanded one (a
    sum's gradient) is made contiguous; one the kernel reads in place, and
    any CPU tensor, pass unchanged."""
    expanded = torch.ones((), device="meta", dtype=torch.bfloat16).expand(1, 2, 8, 32)
    fixed = flash_ops._tma_ready(expanded)
    assert fixed.is_contiguous() and fixed.shape == expanded.shape
    strided = torch.zeros(1, 8, 2, 32, device="meta", dtype=torch.bfloat16).transpose(1, 2)
    assert flash_ops._tma_ready(strided) is strided
    cpu = torch.ones(()).expand(1, 2, 8, 32)
    assert flash_ops._tma_ready(cpu) is cpu


@pytest.mark.parametrize("keys,b,kv,g,skv,want", [
    (64, 1, 1, 10, 2048, 10),   # recurrentgemma-2b (wgmma, D 256): 32 key tiles of one KV head
    (128, 1, 16, 1, 2048, 1),   # MHA at 128 keys a block: nothing to split
    (128, 1, 8, 2, 2304, 2),    # GQA 16 / 8 at 128 keys a block: 144 blocks, split in 2
    (128, 1, 8, 5, 512, 5),     # GQA 40 / 8 at 512, 128 keys a block: 32 blocks
    (128, 4, 8, 4, 4096, 1),    # enough blocks already
    (32, 1, 4, 8, 1000, 4),     # f32, 32 keys a block: 128 blocks, x4
    (64, 1, 16, 1, 2048, 1),    # olmoe (wgmma, D 128, 64 keys a block): MHA, nothing to split
    (64, 1, 8, 2, 2304, 1),     # internvl2-2b (wgmma, D 128): 288 blocks, no split
    (64, 1, 8, 5, 512, 5),      # maverick at 512 (wgmma, D 128): 64 blocks, x5
])
def test_backward_split_fills_the_card_and_divides_the_group(keys, b, kv, g, skv, want):
    """The split is a function of the shapes alone: no card is asked."""
    split = flash_kernel.backward_split(keys, b, kv, g, skv)
    assert split == want and g % split == 0
    target = flash_kernel.BACKWARD_TARGET_BLOCKS
    blocks = b * kv * -(-skv // keys)
    assert split == g or blocks * split >= target
    smaller = [s for s in range(1, split) if g % s == 0]
    assert all(blocks * s < target for s in smaller)
