"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
package's, on the CPU and in float32.

Inputs come from numpy with a seed.  ``moe_ffn``'s output and its three aux
values must agree within 1e-5 (float32 products of a few dozen terms,
summed in another order), over one-hot and sort dispatch, top_k 1, 2 and 8,
with and without the shared expert, at capacity factors 8.0 (dropless),
1.25 (the full configs') and 0.25 (most slots dropped); the drop fraction
must be exactly equal, and so must the routing: the experts chosen, with
equal router probabilities going to the lower index (a zero router ties
every expert).  At these shapes the slot count B·S·k is a power of two, so
XLA's mean (a product with the reciprocal of the count) is exact too.

Then the counterparts of ``tests/test_models.py``'s MoE cases: routing
invariants, drops reported, sort positions equal to one-hot positions, and
dispatch local to each batch row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jax_moe
from repro_torch.models import moe

TOL = 1e-5
B, S, D, E, F = 2, 16, 32, 8, 64


def _params(seed=0, shared=False, e=E, d=D, f=F, router_scale=0.1):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, e)) * router_scale,
         "w_gate": rng.standard_normal((e, d, f)) * 0.05,
         "w_up": rng.standard_normal((e, d, f)) * 0.05,
         "w_down": rng.standard_normal((e, f, d)) * 0.05}
    if shared:
        p |= {"shared_w_gate": rng.standard_normal((d, f)) * 0.05,
              "shared_w_up": rng.standard_normal((d, f)) * 0.05,
              "shared_w_down": rng.standard_normal((f, d)) * 0.05}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _both(x, params, **kw):
    """(jax out, jax aux, port out, port aux) of moe_ffn in float32."""
    jo, ja = jax_moe.moe_ffn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
                             compute_dtype=jnp.float32, **kw)
    to, ta = moe.moe_ffn(torch.from_numpy(x), {k: torch.from_numpy(v)
                                               for k, v in params.items()},
                         compute_dtype=torch.float32, **kw)
    return np.asarray(jo), {k: float(v) for k, v in ja.items()}, to.numpy(), \
        {k: float(v) for k, v in ta.items()}


def _routing(x, params, top_k):
    """Chosen experts of both packages: [B, S, k] each."""
    logits = x @ params["router"]
    _p, je = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), axis=-1), top_k)
    _q, te = moe.top_k_lowest_index_first(
        torch.softmax(torch.from_numpy(logits), dim=-1), top_k)
    return np.asarray(je), te.numpy()


@pytest.mark.parametrize("shared", [False, True], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("top_k", [1, 2, 8])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_ffn_matches_jax(dispatch, top_k, cf, shared):
    x = np.random.default_rng(1).standard_normal((B, S, D)).astype(np.float32)
    params = _params(2, shared)
    jo, ja, to, ta = _both(x, params, num_experts=E, top_k=top_k,
                           capacity_factor=cf, dispatch=dispatch)
    np.testing.assert_allclose(to, jo, atol=TOL)
    for key in ("moe_lb_loss", "moe_z_loss"):
        assert abs(ta[key] - ja[key]) <= TOL, (key, ta, ja)
    assert ta["moe_drop_fraction"] == ja["moe_drop_fraction"]
    if cf < 1.0:
        assert ta["moe_drop_fraction"] > 0.0
    je, te = _routing(x, params, top_k)
    np.testing.assert_array_equal(te, je)


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("top_k", [1, 2, 8])
def test_zero_router_ties_go_to_the_lowest_experts(top_k, cf):
    """A zero router makes every expert equally likely: both packages pick
    experts 0..k-1 for every token, so capacity fills in the same order
    and the same slots drop."""
    x = np.random.default_rng(3).standard_normal((B, S, D)).astype(np.float32)
    params = _params(4)
    params["router"][:] = 0.0
    je, te = _routing(x, params, top_k)
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(te, np.broadcast_to(np.arange(top_k), (B, S, top_k)))
    jo, ja, to, ta = _both(x, params, num_experts=E, top_k=top_k, capacity_factor=cf)
    np.testing.assert_allclose(to, jo, atol=TOL)
    assert ta["moe_drop_fraction"] == ja["moe_drop_fraction"]
    assert abs(ta["moe_lb_loss"] - ja["moe_lb_loss"]) <= TOL


def test_top_k_breaks_every_tie_as_jax_does():
    """Probabilities drawn from a handful of values, so most rows tie."""
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 4, (64, 16)).astype(np.float32) / 4
    for k in (1, 3, 8, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = moe.top_k_lowest_index_first(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("fn", ["position_in_expert_onehot", "position_in_expert_sort"])
def test_positions_match_jax(fn):
    rng = np.random.default_rng(6)
    fe = rng.integers(0, 8, 300)
    want = getattr(jax_moe, fn)(jnp.asarray(fe, jnp.int32), 8)
    got = getattr(moe, fn)(torch.from_numpy(fe), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a batch of rows: each row's positions are its own
    rows = rng.integers(0, 8, (3, 50))
    got = getattr(moe, fn)(torch.from_numpy(rows), 8)
    for r in range(3):
        np.testing.assert_array_equal(
            got[r].numpy(), np.asarray(getattr(jax_moe, fn)(jnp.asarray(rows[r]), 8)))


def test_param_specs_match_jax():
    for args in ((2, 64, 128, 8, 0, 128), (3, 32, 16, 4, 1, 16)):
        assert moe.moe_param_specs(*args).keys() == jax_moe.moe_param_specs(*args).keys()
        for k, spec in moe.moe_param_specs(*args).items():
            want = jax_moe.moe_param_specs(*args)[k]
            assert (spec.shape, spec.logical_axes, spec.init, spec.stddev) == \
                (want.shape, want.logical_axes, want.init, want.stddev)


# -- counterparts of tests/test_models.py -------------------------------------------


def _torch_params(seed, e=E, d=D, f=F):
    return {k: torch.from_numpy(v) for k, v in _params(seed, e=e, d=d, f=f).items()}


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_moe_routing_invariants(top_k, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (2, 16, 32)).astype(np.float32))
    out, aux = moe.moe_ffn(x, _torch_params(seed), num_experts=8, top_k=top_k,
                           capacity_factor=8.0, compute_dtype=torch.float32)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert float(aux["moe_drop_fraction"]) == 0.0  # generous capacity
    assert float(aux["moe_lb_loss"]) >= 0.99  # equality at perfect balance


def test_moe_capacity_drops_are_reported():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 32, 16)).astype(np.float32))
    params = _torch_params(8, e=4, d=16, f=32)
    params["router"] = torch.zeros((16, 4))
    params["router"][:, 0] = 5.0  # one expert overloaded at cf = 0.25
    _out, aux = moe.moe_ffn(x, params, num_experts=4, top_k=1,
                            capacity_factor=0.25, compute_dtype=torch.float32)
    assert float(aux["moe_drop_fraction"]) > 0.5


@pytest.mark.parametrize("e", [2, 8, 64])
@pytest.mark.parametrize("seed", range(10))
def test_moe_sort_dispatch_equals_onehot(seed, e):
    rng = np.random.default_rng(seed)
    fe = torch.from_numpy(rng.integers(0, e, int(rng.integers(2, 400))))
    assert torch.equal(moe.position_in_expert_onehot(fe, e),
                       moe.position_in_expert_sort(fe, e))


def test_moe_grouped_dispatch_is_batch_local():
    """Permuting batch rows permutes the outputs: no row's dispatch sees
    another row, even with drops."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((4, 16, 16)).astype(np.float32))
    params = _torch_params(10, e=4, d=16, f=32)
    for cf in (8.0, 0.5):
        kw = dict(num_experts=4, top_k=2, capacity_factor=cf,
                  compute_dtype=torch.float32)
        out, _ = moe.moe_ffn(x, params, **kw)
        perm = torch.tensor([2, 0, 3, 1])
        out_p, _ = moe.moe_ffn(x[perm], params, **kw)
        np.testing.assert_allclose(out_p.numpy(), out[perm].numpy(), atol=1e-5)
