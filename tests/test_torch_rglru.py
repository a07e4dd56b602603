"""The port's RG-LRU scan and recurrent block against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and cast to each dtype by each
framework.  The plain versions, the sequential scan and the chunked one
(the CUDA kernel's order of operations at ``chunk_plan``'s chunk length),
are held against the JAX package's ``rglru_scan_reference`` (its Pallas
kernel does not trace on this jax, ROADMAP queue 3) at the tolerances of
``tests/test_kernels.py``: 1e-5 in float32, 5e-2 in bfloat16.  The model's
parts are held against the JAX model's within 1e-5 (float32; the JAX
model's associative scan and the port's sequential one differ by rounding
only).  The CUDA kernel runs only on the card, where ``chip_smoke.py``
holds it against both plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru.ref import rglru_scan_reference as jax_rglru_ref
from repro.models import recurrent as jax_rec
from repro.models.common import ParamSpec as JaxParamSpec
from repro.models.common import _init_leaf as jax_init_leaf
from repro.models.common import init_params as jax_init_params
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rglru import ops as rglru_ops
from repro_torch.kernels.rglru import ref as rglru_ref
from repro_torch.models import recurrent as port_rec
from repro_torch.models.common import (
    ParamSpec,
    init_params,
    rglru_lambda_from_uniform,
)
from repro_torch.models.convert import params_from_numpy

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SCAN_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
PART_TOL = 1e-5
# (b, s, w): the sweep of tests/test_kernels.py (w = 200 is ragged).
SWEEP = [(2, 64, 128), (1, 128, 200), (3, 32, 64)]


def _both(x: np.ndarray, dtype: str = "float32"):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x.copy()).to(tdt)


def _close(port: torch.Tensor, ref, atol: float) -> None:
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


def _scan_inputs(b, s, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w), dtype=np.float32)
    h0 = rng.standard_normal((b, w), dtype=np.float32)
    return a, x, h0


# -- the scan's plain version ------------------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,w", SWEEP)
def test_rglru_plain_version_matches_jax_reference(b, s, w, dtype, with_h0):
    a, x, h0 = _scan_inputs(b, s, w)
    (ja, ta), (jx, tx), (jh, th) = (_both(v, dtype) for v in (a, x, h0))
    want_h, want_last = jax_rglru_ref(ja, jx, jh if with_h0 else None)
    got_h, got_last = rglru_ops.rglru_scan(ta, tx, th if with_h0 else None)
    assert got_h.dtype == ta.dtype and got_h.shape == ta.shape
    assert got_last.dtype == torch.float32 and got_last.shape == (b, w)
    assert want_last.dtype == jnp.float32  # the reference's dtype choice
    _close(got_h, want_h, SCAN_TOL[dtype])
    _close(got_last, want_last, SCAN_TOL[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rglru_state_chaining(dtype):
    """Scanning two halves with carried state == scanning the whole."""
    a, x, _ = _scan_inputs(1, 64, 128, seed=1)
    _, ta = _both(a, dtype)
    _, tx = _both(x, dtype)
    h_full, last_full = rglru_ops.rglru_scan(ta, tx)
    h1, last1 = rglru_ops.rglru_scan(ta[:, :32], tx[:, :32])
    h2, last2 = rglru_ops.rglru_scan(ta[:, 32:], tx[:, 32:], last1)
    _close(last2, last_full.numpy(), 1e-5)
    _close(torch.cat([h1, h2], dim=1), h_full.float().numpy(), SCAN_TOL[dtype])


def test_rglru_mixed_dtypes_and_empty_sequence():
    """a and b may differ in dtype (h takes a's); S = 0 returns h0."""
    a, x, h0 = _scan_inputs(2, 9, 40, seed=2)
    ta, tx, th = (torch.from_numpy(v) for v in (a, x, h0))
    h, last = rglru_ops.rglru_scan(ta, tx.bfloat16(), th.bfloat16())
    want_h, want_last = jax_rglru_ref(jnp.asarray(a), jnp.asarray(x).astype(
        jnp.bfloat16), jnp.asarray(h0).astype(jnp.bfloat16))
    assert h.dtype == torch.float32 and last.dtype == torch.float32
    _close(h, want_h, SCAN_TOL["float32"])
    _close(last, want_last, SCAN_TOL["float32"])
    h, last = rglru_ops.rglru_scan(ta[:, :0], tx[:, :0], th)
    assert h.shape == (2, 0, 40) and torch.equal(last, th)


def test_rglru_cpu_entry_point_is_the_plain_version():
    a, x, h0 = (torch.from_numpy(v) for v in _scan_inputs(2, 17, 33, seed=3))
    before = rglru_kernel.LAUNCHES
    for h_init in (None, h0):
        got = rglru_ops.rglru_scan(a, x, h_init)
        want = rglru_ref.rglru_scan_reference(a, x, h_init)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rglru_kernel.LAUNCHES == before


# -- the chunked scan, the kernel's order of operations ------------------------------

L = rglru_kernel.TILE  # the chunk length of every S up to 1,024
CHUNK_EDGES = [0, 1, L - 1, L, L + 1, 3 * L + 5]
EDGE_W = 40


def _chunked(ta, tx, th):
    plan = rglru_kernel.chunk_plan(ta.shape[1], ta.shape[2])
    return rglru_ref.rglru_scan_chunked(ta, tx, th, plan.length)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("s", CHUNK_EDGES)
def test_rglru_chunked_matches_jax_reference(s, b, dtype, with_h0):
    a, x, h0 = _scan_inputs(b, s, EDGE_W, seed=s)
    (ja, ta), (jx, tx), (jh, th) = (_both(v, dtype) for v in (a, x, h0))
    if s:
        want_h, want_last = jax_rglru_ref(ja, jx, jh if with_h0 else None)
    else:  # the JAX reference's scan cannot index an empty S: no step, h0 out
        want_h = np.zeros((b, 0, EDGE_W), np.float32)
        want_last = np.asarray(jh, np.float32) if with_h0 else np.zeros((b, EDGE_W))
    got_h, got_last = _chunked(ta, tx, th if with_h0 else None)
    assert got_h.dtype == ta.dtype and got_h.shape == ta.shape
    assert got_last.dtype == torch.float32 and got_last.shape == (b, EDGE_W)
    _close(got_h, want_h, SCAN_TOL[dtype])
    _close(got_last, want_last, SCAN_TOL[dtype])


def _model_gates(s, w, seed):
    """(a, bx) as recurrentgemma's gates make them, from one layer's RG-LRU
    parameters and x ~ N(0, 1)."""
    layer = {k: v[0] for k, v in init_params(
        port_rec.rglru_param_specs(1, w), seed, "cpu").items()}
    x = np.random.default_rng(seed).standard_normal((1, s, w), dtype=np.float32)
    return [t.numpy() for t in port_rec._gates(layer, torch.from_numpy(x))]


def _slow_decay(s, w, seed):
    """a in (0.99, 0.9999) and b = sqrt(1 - a^2) x: a long memory, |h| ~ 1."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.99, 0.9999, (1, s, w)).astype(np.float32)
    x = rng.standard_normal((1, s, w), dtype=np.float32)
    return [a, (np.sqrt(1 - a * a) * x).astype(np.float32)]


@pytest.mark.parametrize("s,w,make", [(3000, 2560, _model_gates),
                                      (3000, 512, _slow_decay)],
                         ids=["model_gates", "slow_decay"])
def test_rglru_chunked_matches_jax_reference_at_the_models_length(s, w, make):
    a, bx = make(s, w, 7)
    assert rglru_kernel.chunk_plan(s, w).chunks > 1
    want_h, want_last = jax_rglru_ref(jnp.asarray(a), jnp.asarray(bx))
    got_h, got_last = _chunked(torch.from_numpy(a), torch.from_numpy(bx), None)
    _close(got_h, want_h, SCAN_TOL["float32"])
    _close(got_last, want_last, SCAN_TOL["float32"])


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [0, 1, L - 1, L])
def test_rglru_chunked_is_the_sequential_scan_within_one_chunk(s, dtype,
                                                               with_h0):
    """S <= L is one chunk: exactly the plain sequential scan, as every
    decode tick (S = 1) needs for ``rglru_step`` to be the JAX step."""
    a, x, h0 = _scan_inputs(3, s, EDGE_W, seed=4)
    _, ta = _both(a, dtype)
    _, tx = _both(x, dtype)
    th = torch.from_numpy(h0) if with_h0 else None
    assert rglru_kernel.chunk_plan(s, EDGE_W).chunks == 1
    got = _chunked(ta, tx, th)
    want = rglru_ref.rglru_scan_reference(ta, tx, th)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_rglru_chunked_rows_do_not_depend_on_the_batch():
    """The plan is S's and W's only, so a row's bits are the same in a
    batch of 3 as alone."""
    a, x, h0 = (torch.from_numpy(v) for v in _scan_inputs(3, 3 * L + 5, EDGE_W, 5))
    h, last = _chunked(a, x, h0)
    for r in range(3):
        hr, lr = _chunked(a[r:r + 1], x[r:r + 1], h0[r:r + 1])
        assert torch.equal(h[r:r + 1], hr) and torch.equal(last[r:r + 1], lr)


@pytest.mark.parametrize("s", [0, 1, L - 1, L, L + 1, 3 * L + 5, 64, 79, 1000,
                               1024, 1025, 2100, 3000, 3460, 100_000])
@pytest.mark.parametrize("w", [1, 40, 200, 2560])
def test_chunk_plan_covers_every_step_once(s, w):
    plan = rglru_kernel.chunk_plan(s, w)
    # chunks of L steps tile [0, S): none empty, none missing
    assert plan.length >= rglru_kernel.TILE
    assert plan.length * plan.chunks >= s
    assert plan.chunks == 1 or plan.length * (plan.chunks - 1) < s
    assert (plan.chunks == 1) == (s <= rglru_kernel.TILE)
    # the chunks fit one cluster, and no CTA of it is idle
    assert plan.chunks <= rglru_kernel.MAX_CHUNKS
    assert plan.per_cta <= rglru_kernel.MAX_CHUNKS_PER_CTA
    assert plan.ctas <= rglru_kernel.MAX_CTAS
    assert plan.per_cta * (plan.ctas - 1) < plan.chunks <= plan.per_cta * plan.ctas
    assert plan.per_cta * plan.stripe <= 256 and plan.stripe % 32 == 0
    # stripes tile W
    assert (plan.stripes - 1) * plan.stripe < w <= plan.stripes * plan.stripe


@pytest.mark.parametrize("s", [64, 79, 1000, 2100, 3460])
def test_chunk_plan_fills_the_card_at_the_models_prefill(s):
    """recurrentgemma-2b's W = 2560: (stripe, chunk) pairs, a warp each,
    at least twice the H100's 132 SMs, over more than the 20 CTAs of a
    channel-parallel grid."""
    plan = rglru_kernel.chunk_plan(s, 2560)
    assert plan.stripes * plan.chunks >= 2 * 132
    assert plan.stripes * plan.ctas > 20


# -- the init of Lambda ------------------------------------------------------------


def test_rglru_lambda_init_is_the_jax_formula():
    """On the same forget rates u, the port's Lambda is the JAX package's."""
    spec = JaxParamSpec((3, 64), ("layers", "rnn_state"), init="rglru_lambda")
    key = jax.random.PRNGKey(5)
    want = jax_init_leaf(spec, key, jnp.float32)
    u = jax.random.uniform(key, spec.shape, jnp.float32, 0.9, 0.999)
    got = rglru_lambda_from_uniform(torch.from_numpy(np.array(u)))
    _close(got, want, 1e-6)


def test_init_params_draws_lambda_in_its_range():
    spec = {"lambda": ParamSpec((2, 2560), ("layers", "rnn_state"),
                                init="rglru_lambda")}
    lam = init_params(spec, 0, "cpu")["lambda"]
    assert torch.equal(lam, init_params(spec, 0, "cpu")["lambda"])
    u = torch.linspace(0.9, 0.999, 5)
    lo, hi = rglru_lambda_from_uniform(u[[-1, 0]]).tolist()
    assert lo < -4.3 and 0.99 < hi < 1.01  # softplus(Lambda) stays below 20
    assert lo <= float(lam.min()) and float(lam.max()) <= hi
    assert float(lam.std()) > 0.5  # spread over the range, not one value
    half = init_params(spec, 0, "cpu", torch.bfloat16)["lambda"]
    assert half.dtype == torch.bfloat16
    _close(half, lam.numpy(), 2e-2)


# -- the recurrent block's parts against the JAX model --------------------------------

B, S, D, W, K = 2, 11, 48, 40, 4


@pytest.fixture(scope="module")
def block_params():
    """One layer of recurrent-block parameters, nonzero biases b_a and b_x."""
    specs = jax_rec.recurrent_block_specs(1, D, W, K)
    tree = jax.tree.map(np.asarray, jax_init_params(
        specs, jax.random.PRNGKey(0), jnp.float32))
    rng = np.random.default_rng(0)
    for key in ("b_a", "b_x"):
        tree["rglru"][key] = (0.5 * rng.standard_normal((1, W))).astype(np.float32)
    tree = jax.tree.map(lambda v: v[0], tree)
    return jax.tree.map(jnp.asarray, tree), params_from_numpy(tree, "cpu")


def _x(shape, seed):
    return _both(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))


def test_gates_match_jax(block_params):
    jp, tp = block_params
    jx, tx = _x((B, S, W), 1)
    for got, want in zip(port_rec._gates(tp["rglru"], tx),
                         jax_rec._gates(jp["rglru"], jx)):
        assert got.dtype == torch.float32
        _close(got, want, PART_TOL)


def test_rglru_scan_and_step_match_jax(block_params):
    jp, tp = block_params
    jx, tx = _x((B, S, W), 2)
    jh, th = _x((B, W), 3)
    for h0 in (None, (jh, th)):
        want_y, want_last = jax_rec.rglru_scan(jp["rglru"], jx,
                                               None if h0 is None else h0[0])
        got_y, got_last = port_rec.rglru_scan(tp["rglru"], tx,
                                              None if h0 is None else h0[1])
        _close(got_y, want_y, PART_TOL)
        _close(got_last, want_last, PART_TOL)
    want_y, want_h = jax_rec.rglru_step(jp["rglru"], jx[:, 0], jh)
    got_y, got_h = port_rec.rglru_step(tp["rglru"], tx[:, 0], th)
    assert got_y.shape == (B, W) and got_h.dtype == torch.float32
    _close(got_y, want_y, PART_TOL)
    _close(got_h, want_h, PART_TOL)


@pytest.mark.parametrize("s", [S, 1, 2], ids=["prompt", "one", "shorter_than_k"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv1d_matches_jax(block_params, s, with_state):
    jp, tp = block_params
    jx, tx = _x((B, s, W), 4)
    js, ts = _x((B, K - 1, W), 5) if with_state else (None, None)
    got, got_state = port_rec.causal_conv1d(tp["conv1d"], tx, ts)
    want, want_state = jax_rec.causal_conv1d(jp["conv1d"], jx, js)
    _close(got, want, PART_TOL)
    assert got_state.shape == (B, K - 1, W)
    _close(got_state, want_state, 0.0)  # rows of [state; x], copied


def test_recurrent_block_prefill_then_decode_matches_jax(block_params):
    jp, tp = block_params
    jx, tx = _x((B, S, D), 6)
    want, jstate = jax_rec.recurrent_block(jp, jx, compute_dtype=jnp.float32)
    got, tstate = port_rec.recurrent_block(tp, tx, compute_dtype=torch.float32)
    _close(got, want, PART_TOL)
    for name in ("h", "conv"):
        _close(tstate[name], jstate[name], PART_TOL)
    assert tstate["h"].dtype == torch.float32
    jx1, tx1 = _x((B, 1, D), 7)
    want, jstate = jax_rec.recurrent_block(jp, jx1, compute_dtype=jnp.float32,
                                           state=jstate)
    got, tstate = port_rec.recurrent_block(tp, tx1, compute_dtype=torch.float32,
                                           state=tstate)
    _close(got, want, PART_TOL)
    for name in ("h", "conv"):
        _close(tstate[name], jstate[name], PART_TOL)
