"""Gradients of the port's three model kernels, of the MoE FFN and the two
xLSTM blocks, of the chunked cross-entropy and of ``lm_loss``, against
``jax.grad`` of the JAX model's own functions, on the CPU and in float32.

Each kernel's ``torch.autograd.Function`` is called on CPU tensors, where
its forward and its backward are the plain versions (the explicit gradient
formulas the card's kernels are held against), and its gradients must be
within 1e-5 of JAX's: ``layers.rms_norm``, ``attention.attention`` and
``recurrent.rglru_scan`` of the JAX package (1e-5 is the tolerance of the
reference's own RG-LRU test).  The RG-LRU backward's flip construction over
``rglru_scan_chunked`` must also agree with the explicit reverse loop, and
``rglru_scan_backward_chunked`` (the backward kernel's order, which the card
equals bit for bit) must equal that construction bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import lm as jax_lm
from repro.models import moe as jax_moe
from repro.models import recurrent as jax_rec
from repro.models import xlstm as jax_xlstm
from repro.models.common import init_params as jax_init_params
from repro_torch.configs.registry import get_config
from repro_torch.kernels.flash_attention.ops import FlashAttentionFunction
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru.ops import RGLRUScanFunction
from repro_torch.kernels.rglru.ref import (
    rglru_scan_backward,
    rglru_scan_backward_chunked,
    rglru_scan_backward_reference,
    rglru_scan_chunked,
    rglru_scan_reference,
)
from repro_torch.kernels.rmsnorm.ops import RMSNormFunction
from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models import lm
from repro_torch.models import moe as port_moe
from repro_torch.models import recurrent as port_rec
from repro_torch.models import xlstm as port_xlstm
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.adamw import tree_leaves

TOL = 1e-5


def _t(x, grad=True):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


# -- RMS norm -----------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 64), (7, 77), (3, 4, 2, 16)])
def test_rms_norm_function_backward_equals_jax_grad(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)

    def f(x, s):
        return jnp.sum(jax_layers.rms_norm(x, s, 1e-6) * g)

    jx, js = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(scale))
    tx, ts = _t(x), _t(scale)
    out = RMSNormFunction.apply(tx, ts, 1e-6)
    _close(out, jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    dx, ds = torch.autograd.grad(out, (tx, ts), torch.from_numpy(g))
    _close(dx, jx)
    _close(ds, js)
    # the model's entry point takes the same Function under autograd
    out2 = port_layers.rms_norm(tx, ts, 1e-6)
    assert out2.grad_fn is not None and "RMSNormFunction" in type(out2.grad_fn).__name__


# -- attention --------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,kv,d,window", [
    (2, 24, 4, 2, 16, 0),   # GQA
    (1, 40, 4, 1, 16, 8),   # MQA, a window shorter than S
    (1, 33, 2, 2, 32, 0),   # MHA, ragged S
])
def test_attention_function_backward_equals_jax_grad(b, s, h, kv, d, window):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(jax_attn.attention(q, k, v, causal=True, window=window) * g)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = port_attn.attention(tq, tk, tv, causal=True, window=window)
    assert "FlashAttentionFunction" in type(out.grad_fn.next_functions[0][0]).__name__ \
        or "FlashAttentionFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for gt, wt in zip(got, want):
        _close(gt, wt)


def test_flash_function_backward_equals_autograd_of_the_plain_forward():
    """In the kernel's [B, H, S, D] layout, with K/V shared by query heads."""
    from repro_torch.kernels.flash_attention.ref import attention_reference

    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 6, 20, 16, generator=gen, requires_grad=True)
    k = torch.randn(2, 3, 20, 16, generator=gen, requires_grad=True)
    v = torch.randn(2, 3, 20, 16, generator=gen, requires_grad=True)
    g = torch.randn(2, 6, 20, 16, generator=gen)
    got = torch.autograd.grad(FlashAttentionFunction.apply(q, k, v, True, 5), (q, k, v), g)
    ref = attention_reference(q, k.repeat_interleave(2, 1), v.repeat_interleave(2, 1),
                              causal=True, window=5)
    want = torch.autograd.grad(ref, (q, k, v), g)
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, atol=TOL, rtol=0)


# -- RG-LRU -------------------------------------------------------------------------------


def _rglru_params(rng, w):
    return {"lambda": rng.uniform(-4.0, 1.0, w).astype(np.float32),
            "w_a": (0.3 * rng.standard_normal(w)).astype(np.float32),
            "b_a": (0.2 * rng.standard_normal(w)).astype(np.float32),
            "w_x": (0.3 * rng.standard_normal(w)).astype(np.float32),
            "b_x": (0.2 * rng.standard_normal(w)).astype(np.float32)}


@pytest.mark.parametrize("b,s,w,with_h0", [(2, 17, 32, False), (1, 40, 24, True),
                                           (3, 1, 16, True)])
def test_rglru_scan_backward_equals_jax_grad(b, s, w, with_h0):
    """The model's RG-LRU (gates in plain autograd, the scan through
    RGLRUScanFunction) against jax.grad of the JAX model's associative scan,
    for x, every gate parameter and h0."""
    rng = np.random.default_rng(2)
    params = _rglru_params(rng, w)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    gy = rng.standard_normal((b, s, w)).astype(np.float32)
    gl = rng.standard_normal((b, w)).astype(np.float32)

    def f(p, x, h0):
        y, last = jax_rec.rglru_scan(p, x, h0)
        return jnp.sum(y * gy) + jnp.sum(last * gl)

    jp = jax.tree.map(jnp.asarray, params)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(jp, jnp.asarray(x),
                                          None if h0 is None else jnp.asarray(h0))
    tp = {k: _t(v) for k, v in params.items()}
    tx, th0 = _t(x), None if h0 is None else _t(h0)
    y, last = port_rec.rglru_scan(tp, tx, th0)
    inputs = [tx] + [tp[k] for k in sorted(tp)] + ([th0] if with_h0 else [])
    got = torch.autograd.grad((y, last), inputs, (torch.from_numpy(gy), torch.from_numpy(gl)))
    _close(got[0], want[1])
    for i, k in enumerate(sorted(tp)):
        _close(got[1 + i], want[0][k])
    if with_h0:
        _close(got[-1], want[2])


@pytest.mark.parametrize("s", [1, 15, 16, 17, 53, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_flip_construction_equals_the_reverse_loop(s, with_h0):
    """The card's backward is the chunked scan on reversed inputs; on the
    CPU the same construction over ``rglru_scan_chunked`` (chunk 16, the
    kernel's length up to S = 1,024) equals the explicit reverse loop within
    1e-5, and bit for bit where S fits one chunk; over the sequential scan
    (the CPU Function's) it is the loop exactly."""
    gen = torch.Generator().manual_seed(s)
    B, W = 2, 24
    a = 0.5 + 0.499 * torch.rand(B, s, W, generator=gen)
    b = torch.randn(B, s, W, generator=gen)
    h0 = torch.randn(B, W, generator=gen) if with_h0 else None
    h, _last = rglru_scan_reference(a, b, h0)
    gh, gl = torch.randn(B, s, W, generator=gen), torch.randn(B, W, generator=gen)
    loop = rglru_scan_backward_reference(a, h, h0, gh, gl)
    chunked = rglru_scan_backward(a, h, h0, gh, gl,
                                  functools.partial(rglru_scan_chunked, chunk=16))
    sequential = rglru_scan_backward(a, h, h0, gh, gl, rglru_scan_reference)
    for c, l_, q in zip(chunked, loop, sequential):
        if l_ is None:
            assert c is None and q is None
            continue
        torch.testing.assert_close(c, l_, atol=TOL, rtol=0)
        assert torch.equal(q, l_)
        if s <= 16:
            assert torch.equal(c, l_)


def _bits(t):
    """``t``'s bits as integers: equality then tells -0 from 0."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w,chunk", [
    *((2, s, 24, 16) for s in (0, 1, 15, 16, 17, 53, 300)),
    (1, 2048, 24, rglru_kernel.chunk_plan(2048, 24).length),
])
def test_rglru_backward_chunked_equals_the_flip_construction(b, s, w, chunk, with_h0,
                                                             dtype):
    """The backward kernel's order (reversed chunks counted from the end of
    S, the carry, the rescan; nothing flipped) is the flip construction over
    ``rglru_scan_chunked`` at the same chunk bit for bit, signed zeros
    included: chunk 16 (the plan's L up to S = 1,024) around one and several
    chunks, and the training path's S = 2,048 at its plan's L (32)."""
    gen = torch.Generator().manual_seed(s)
    a = (0.5 + 0.499 * torch.rand(b, s, w, generator=gen)).to(dtype)
    x = torch.randn(b, s, w, generator=gen).to(dtype)
    h0 = torch.randn(b, w, generator=gen).to(dtype) if with_h0 else None
    h, _last = rglru_scan_chunked(a, x, h0, chunk)
    gh = torch.randn(b, s, w, generator=gen).to(dtype)
    gl = torch.randn(b, w, generator=gen)
    gh[:, -3:, :4] = -0.0  # zeros whose sign the order decides
    gl[:, :2] = -0.0
    want = rglru_scan_backward(a, h, h0, gh, gl,
                               functools.partial(rglru_scan_chunked, chunk=chunk))
    got = rglru_scan_backward_chunked(a, h, h0, gh, gl, chunk)
    for g, w_ in zip(got, want):
        if w_ is None:
            assert g is None
            continue
        assert g.dtype == w_.dtype and g.shape == w_.shape
        assert torch.equal(_bits(g), _bits(w_))


@pytest.mark.parametrize("call", [
    lambda t, b, g: rglru_kernel.rglru_scan_backward_cuda(t, t, None, t, g),
    lambda t, b, g: rglru_kernel.rglru_scan_backward_cuda(t, t, b, t, g),
    lambda t, b, g: rglru_ops._scan_backward_impl(t.to("meta"), t.to("meta"), None,
                                                  t.to("meta"), g.to("meta")),
], ids=["cpu", "cpu_h0", "op_off_cpu"])
def test_rglru_backward_cuda_refuses_non_cuda_tensors_before_building(call, monkeypatch):
    """The backward kernel's wrapper raises ValueError on a tensor that is
    not on a CUDA device before it builds or launches anything, and the
    op's implementation hands a tensor off the CPU to it, never to a plain
    version."""
    def must_not_run(*_a, **_k):
        raise AssertionError("reached past the wrapper's checks")

    monkeypatch.setattr(rglru_kernel, "load_backward", must_not_run)
    monkeypatch.setattr(rglru_kernel, "load_library", must_not_run)
    monkeypatch.setattr(rglru_ops, "rglru_scan_backward", must_not_run)
    before = (rglru_kernel.LAUNCHES, rglru_kernel.BACKWARD_LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.zeros(2, 17, 32, dtype=dtype)
        with pytest.raises(ValueError, match="CUDA tensor"):
            call(t, torch.zeros(2, 32, dtype=dtype), torch.zeros(2, 32))
    assert (rglru_kernel.LAUNCHES, rglru_kernel.BACKWARD_LAUNCHES) == before


def test_rglru_function_gradients_for_a_b_h0():
    """RGLRUScanFunction's (da, db, dh0) against autograd through the plain
    sequential scan."""
    gen = torch.Generator().manual_seed(9)
    a = (0.5 + 0.45 * torch.rand(2, 21, 8, generator=gen)).requires_grad_()
    b = torch.randn(2, 21, 8, generator=gen, requires_grad=True)
    h0 = torch.randn(2, 8, generator=gen, requires_grad=True)
    gh, gl = torch.randn(2, 21, 8, generator=gen), torch.randn(2, 8, generator=gen)
    got = torch.autograd.grad(RGLRUScanFunction.apply(a, b, h0), (a, b, h0), (gh, gl))

    def plain(a, b, h0):  # differentiable sequential scan
        h, hs = h0, []
        for t in range(a.shape[1]):
            h = a[:, t] * h + b[:, t]
            hs.append(h)
        return torch.stack(hs, 1), h

    want = torch.autograd.grad(plain(a, b, h0), (a, b, h0), (gh, gl))
    for gt, wt in zip(got, want):
        torch.testing.assert_close(gt, wt, atol=TOL, rtol=0)


# -- cross-entropy and lm_loss --------------------------------------------------------------


@pytest.mark.parametrize("vocab,vp,softcap,chunk", [(80, 80, 0.0, 8), (72, 80, 30.0, 8),
                                                    (61, 64, 0.0, 32), (50, 64, 5.0, 4)])
def test_chunked_cross_entropy_equals_jax(vocab, vp, softcap, chunk):
    rng = np.random.default_rng(4)
    B, S, D = 2, 32, 16
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (0.3 * rng.standard_normal((D, vp))).astype(np.float32)
    targets = rng.integers(0, vocab, (B, S)).astype(np.int32)
    kw = dict(vocab_size=vocab, seq_chunk=chunk, softcap=softcap)

    def f(x, head):
        return jax_layers.chunked_cross_entropy(
            x, head, jnp.asarray(targets), compute_dtype=jnp.float32, **kw)

    want, (jgx, jgh) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(jnp.asarray(x),
                                                             jnp.asarray(head))
    tx, th = _t(x), _t(head)
    got = port_layers.chunked_cross_entropy(tx, th, torch.from_numpy(targets),
                                            compute_dtype=torch.float32, **kw)
    _close(got, want)
    gx, gh = torch.autograd.grad(got, (tx, th))
    _close(gx, jgx)
    _close(gh, jgh)
    with torch.no_grad():  # no autograd: the same value without recompute
        _close(port_layers.chunked_cross_entropy(tx, th, torch.from_numpy(targets),
                                                 compute_dtype=torch.float32, **kw), want)


# -- MoE and xLSTM ------------------------------------------------------------------------


def _within(got, want, tol=TOL):
    """|got - want| <= tol * max(1, |want|): the mLSTM's gradients reach
    100 (its normaliser divides by |n . q|), where 1e-5 is a float32
    spacing or two."""
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert got.shape == want.shape and err.max() <= tol, err.max()


def _tree_grads(got_leaves, want_tree, keys):
    for g, k in zip(got_leaves, keys):
        _close(g, want_tree[k])


@pytest.mark.parametrize("dispatch,top_k,cf,shared", [
    ("onehot", 2, 8.0, False), ("sort", 2, 1.25, True), ("onehot", 1, 0.5, True),
    ("sort", 4, 1.25, False)])
def test_moe_ffn_gradients_equal_jax_grad(dispatch, top_k, cf, shared):
    """Through the output and the weighted aux losses (as lm_loss weighs
    them), with drops where cf < 8: for x and every weight."""
    rng = np.random.default_rng(6)
    B, S, D, E, F = 2, 16, 16, 4, 24
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    names = ["router", "w_gate", "w_up", "w_down"]
    shapes = [(D, E), (E, D, F), (E, D, F), (E, F, D)]
    if shared:
        names += ["shared_w_gate", "shared_w_up", "shared_w_down"]
        shapes += [(D, F), (D, F), (F, D)]
    params = {n: (0.2 * rng.standard_normal(sh)).astype(np.float32)
              for n, sh in zip(names, shapes)}
    g = rng.standard_normal((B, S, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=top_k, capacity_factor=cf, dispatch=dispatch)

    def f(x, p):
        out, aux = jax_moe.moe_ffn(x, p, compute_dtype=jnp.float32, **kw)
        return jnp.sum(out * g) + 0.01 * aux["moe_lb_loss"] + 0.001 * aux["moe_z_loss"]

    jgx, jgp = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    tx = _t(x)
    tp = {n: _t(v) for n, v in params.items()}
    out, aux = port_moe.moe_ffn(tx, tp, compute_dtype=torch.float32, **kw)
    loss = torch.sum(out * torch.from_numpy(g)) + 0.01 * aux["moe_lb_loss"] \
        + 0.001 * aux["moe_z_loss"]
    got = torch.autograd.grad(loss, [tx] + [tp[n] for n in names])
    _close(got[0], jgx)
    _tree_grads(got[1:], jgp, names)


def _xlstm_params(kind, rng, D=32, H=2, hd=8):
    specs = (jax_xlstm.mlstm_block_specs if kind == "mlstm"
             else jax_xlstm.slstm_block_specs)(1, D, H, hd)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        scale = 0.2 if node.init == "zeros" else node.stddev
        return (rng.standard_normal(node.shape[1:]) * scale).astype(np.float32)

    return draw(specs)


@pytest.mark.parametrize("kind,S", [("mlstm", 16), ("mlstm", 24), ("slstm", 12)])
def test_xlstm_block_gradients_equal_jax_grad(kind, S):
    """Each block over a whole sequence (the mLSTM chunkwise at chunk
    min(64, S)), for x and every weight, within 1e-5 of the value where it
    exceeds 1."""
    rng = np.random.default_rng(7)
    params = _xlstm_params(kind, rng)
    x = rng.standard_normal((2, S, 32)).astype(np.float32)
    g = rng.standard_normal((2, S, 32)).astype(np.float32)
    jfn = jax_xlstm.mlstm_block if kind == "mlstm" else jax_xlstm.slstm_block
    tfn = port_xlstm.mlstm_block if kind == "mlstm" else port_xlstm.slstm_block

    def f(x, p):
        return jnp.sum(jfn(p, x, heads=2, compute_dtype=jnp.float32)[0] * g)

    jgx, jgp = jax.jit(jax.grad(f, argnums=(0, 1)))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params))
    tx = _t(x)
    tp = jax.tree.map(_t, params)
    out, _state = tfn(tp, tx, heads=2, compute_dtype=torch.float32)
    got = torch.autograd.grad(out, [tx] + jax.tree.leaves(tp), torch.from_numpy(g))
    _within(got[0], jgx)
    for gt, wt in zip(got[1:], jax.tree.leaves(jgp)):
        _within(gt, wt)


@pytest.mark.parametrize("name", ["yi-9b", "recurrentgemma-2b", "gemma3-4b",
                                  "olmoe-1b-7b", "xlstm-350m"])
def test_lm_loss_and_its_gradient_equal_jax(name):
    jcfg = dataclasses.replace(jax_get_config(name).smoke(), compute_dtype="float32")
    cfg = dataclasses.replace(get_config(name).smoke(), compute_dtype="float32")
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_lm.lm_param_specs(jcfg, 1), jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "targets": jnp.asarray(toks[:, 1:])}
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm.lm_loss(jcfg, p, jb), has_aux=True))(jax.tree.map(jnp.asarray, tree))

    params = params_from_numpy(tree, "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "targets": torch.from_numpy(toks[:, 1:]).long()}
    loss, metrics = lm.lm_loss(cfg, params, batch)
    assert set(metrics) == set(jm)
    _close(loss, jloss)
    grads = torch.autograd.grad(loss, leaves)
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        _close(g, w)


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    """cfg.remat wraps every block in torch.utils.checkpoint under autograd
    (recomputed in the backward, under either remat_policy), and the
    gradients do not change."""
    from repro_torch.models import lm as lm_mod

    cfg = dataclasses.replace(get_config("recurrentgemma-2b").smoke(),
                              compute_dtype="float32")
    from repro_torch.models.common import init_params

    params = init_params(lm.lm_param_specs(cfg), 0, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 17), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    calls = []
    real = lm_mod.apply_block
    monkeypatch.setattr(lm_mod, "apply_block",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    grads = {}
    for remat, policy in ((True, "nothing"), (True, "dots"), (False, "nothing")):
        c = dataclasses.replace(cfg, remat=remat, remat_policy=policy)
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        calls.clear()
        loss, _m = lm.lm_loss(c, params, batch)
        forward_calls = len(calls)
        grads[remat, policy] = torch.autograd.grad(loss, leaves)
        for leaf in leaves:
            leaf.requires_grad_(False)
        assert forward_calls == cfg.num_layers
        assert len(calls) == cfg.num_layers * (2 if remat else 1)
    for key in ((True, "nothing"), (True, "dots")):
        for a, b in zip(grads[key], grads[False, "nothing"]):
            assert torch.equal(a, b)
