"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's, on the CPU and in float32.

Each function is held against its own JAX counterpart within 1e-5
(relative to the value where it exceeds 1):
``mlstm_sequential``, ``mlstm_chunkwise`` at chunks of 8, 16 and 64,
``mlstm_step``, ``slstm_scan``, ``mlstm_block`` and ``slstm_block`` (a whole
sequence, and one decode step against a carried state).  The chunkwise form
equals the sequential oracle only within 5e-4 / 1e-3 (the JAX package's own
test), so each is compared with its own counterpart.  Then the
counterparts of ``tests/test_models.py``'s mLSTM and sLSTM cases, at their
tolerances, and the port's chunkwise form at an S that its chunk does not
divide, which the JAX function refuses.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jax_xlstm
from repro_torch.models import xlstm

TOL = 1e-5


def _mlstm_inputs(seed, B=2, S=64, H=2, D=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(3))
    i_raw = rng.standard_normal((B, S, H)).astype(np.float32)
    f_raw = (rng.standard_normal((B, S, H)) + 1.0).astype(np.float32)
    return q, k, v, i_raw, f_raw


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _close(got, want, atol=TOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach().float()), np.asarray(want),
                               atol=atol, rtol=rtol)


def _within(got, want, tol=TOL):
    """|got - want| <= tol * max(1, |want|): float32 outputs reach 20 here,
    where 1e-5 is a few spacings."""
    got, want = np.asarray(got.detach().float()), np.asarray(want, np.float32)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert got.shape == want.shape and err.max() <= tol, err.max()


def _state_close(got, want, atol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w, atol)


def test_mlstm_sequential_matches_jax():
    inp = _mlstm_inputs(0, S=24)
    jh, jst = jax_xlstm.mlstm_sequential(*_j(inp))
    th, tst = xlstm.mlstm_sequential(*_t(inp))
    _close(th, jh)
    _state_close(tst, jst)


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_mlstm_chunkwise_matches_jax(chunk):
    inp = _mlstm_inputs(1)
    jh, jst = jax_xlstm.mlstm_chunkwise(*_j(inp), chunk=chunk)
    th, tst = xlstm.mlstm_chunkwise(*_t(inp), chunk=chunk)
    _within(th, jh)
    _state_close(tst, jst)
    # from a carried state, as a second segment of a sequence would
    jh2, jst2 = jax_xlstm.mlstm_chunkwise(*_j(inp), chunk=chunk, initial=jst)
    th2, tst2 = xlstm.mlstm_chunkwise(*_t(inp), chunk=chunk, initial=tst)
    _within(th2, jh2)
    _state_close(tst2, jst2)


def test_mlstm_step_matches_jax():
    q, k, v, i_raw, f_raw = _mlstm_inputs(2, S=9)
    _, jst = jax_xlstm.mlstm_sequential(*_j((q[:, :8], k[:, :8], v[:, :8],
                                            i_raw[:, :8], f_raw[:, :8])))
    last = [a[:, 8] for a in (q, k, v, i_raw, f_raw)]
    jh, jnew = jax_xlstm.mlstm_step(*_j(last), jst)
    th, tnew = xlstm.mlstm_step(*_t(last), tuple(_t(jst)))
    _close(th, jh)
    _state_close(tnew, jnew)


def _slstm_inputs(seed, B=2, S=20, H=2, D=8):
    rng = np.random.default_rng(seed)
    gates = {g: rng.standard_normal((B, S, H, D)).astype(np.float32)
             for g in ("z", "f", "i", "o")}
    r = {g: (rng.standard_normal((H, D, D)) * 0.2).astype(np.float32)
         for g in ("z", "f", "i", "o")}
    return gates, r


def test_slstm_scan_matches_jax():
    gates, r = _slstm_inputs(3)
    jr = {g: jnp.asarray(w) for g, w in r.items()}
    tr = {g: torch.from_numpy(w) for g, w in r.items()}
    jh, jst = jax_xlstm.slstm_scan({g: jnp.asarray(a) for g, a in gates.items()}, jr)
    th, tst = xlstm.slstm_scan({g: torch.from_numpy(a) for g, a in gates.items()}, tr)
    _close(th, jh)
    _state_close(tst, jst)
    jh2, jst2 = jax_xlstm.slstm_scan({g: jnp.asarray(a) for g, a in gates.items()},
                                     jr, jst)
    th2, tst2 = xlstm.slstm_scan({g: torch.from_numpy(a) for g, a in gates.items()},
                                 tr, tuple(_t(jst)))
    _close(th2, jh2)
    _state_close(tst2, jst2)


def _block_params(kind, seed, D=32, H=2, hd=8):
    specs = (jax_xlstm.mlstm_block_specs if kind == "mlstm"
             else jax_xlstm.slstm_block_specs)(1, D, H, hd)
    rng = np.random.default_rng(seed)

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        scale = 0.2 if node.init == "zeros" else node.stddev
        return (rng.standard_normal(node.shape[1:]) * scale).astype(np.float32)

    return draw(specs)


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.mark.parametrize("S", [1, 16, 40])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_blocks_match_jax(kind, S):
    """A whole sequence (the mLSTM's chunk is min(64, S)), then one decode
    step from the state it leaves."""
    params = _block_params(kind, 4)
    jp, tp = _tree(params, jnp.asarray), _tree(params, torch.from_numpy)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S + 1, 32)).astype(np.float32)
    jfn = jax_xlstm.mlstm_block if kind == "mlstm" else jax_xlstm.slstm_block
    tfn = xlstm.mlstm_block if kind == "mlstm" else xlstm.slstm_block
    kw = dict(heads=2)
    jo, jst = jfn(jp, jnp.asarray(x[:, :S]), compute_dtype=jnp.float32, **kw)
    to, tst = tfn(tp, torch.from_numpy(x[:, :S]), compute_dtype=torch.float32, **kw)
    _close(to, jo)
    jflat, tflat = jax.tree.leaves(jst), jax.tree.leaves(tst)
    _state_close(tflat, jflat)
    jo2, jst2 = jfn(jp, jnp.asarray(x[:, S:]), compute_dtype=jnp.float32,
                    state=jst, **kw)
    to2, tst2 = tfn(tp, torch.from_numpy(x[:, S:]), compute_dtype=torch.float32,
                    state=tst, **kw)
    _close(to2, jo2)
    _state_close(jax.tree.leaves(tst2), jax.tree.leaves(jst2))


def test_block_specs_match_jax():
    for fn in ("mlstm_block_specs", "slstm_block_specs"):
        want = jax.tree.leaves(getattr(jax_xlstm, fn)(3, 64, 4, 16))
        got = jax.tree.leaves(getattr(xlstm, fn)(3, 64, 4, 16))
        assert [(s.shape, s.logical_axes, s.init, s.stddev) for s in got] == \
               [(s.shape, s.logical_axes, s.init, s.stddev) for s in want]


# -- counterparts of tests/test_models.py -------------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_mlstm_chunkwise_property(chunk, seed):
    inp = _t(_mlstm_inputs(10 + seed, B=1))
    h_ref, st_ref = xlstm.mlstm_sequential(*inp)
    h_ck, st_ck = xlstm.mlstm_chunkwise(*inp, chunk=chunk)
    _close(h_ck, h_ref.numpy(), atol=5e-4, rtol=1e-3)
    for a, b in zip(st_ref, st_ck):
        _close(b, a.numpy(), atol=5e-4, rtol=1e-3)


def test_mlstm_decode_continuation():
    q, k, v, i_raw, f_raw = _t(_mlstm_inputs(20, S=32))
    h_full, _ = xlstm.mlstm_sequential(q, k, v, i_raw, f_raw)
    _, st = xlstm.mlstm_sequential(q[:, :-1], k[:, :-1], v[:, :-1],
                                   i_raw[:, :-1], f_raw[:, :-1])
    h_step, _ = xlstm.mlstm_step(q[:, -1], k[:, -1], v[:, -1],
                                 i_raw[:, -1], f_raw[:, -1], st)
    _close(h_step, h_full[:, -1].numpy())


def test_slstm_bounded_and_stateful():
    gates, r = _slstm_inputs(21, B=1, S=48)
    gates = {g: torch.from_numpy(a) for g, a in gates.items()}
    r = {g: torch.from_numpy(w) for g, w in r.items()}
    h, _state = xlstm.slstm_scan(gates, r)
    assert torch.isfinite(h).all()
    assert h.abs().max() < 10.0  # the normalised memory keeps h bounded
    h1, s1 = xlstm.slstm_scan({g: v[:, :24] for g, v in gates.items()}, r)
    h2, _s2 = xlstm.slstm_scan({g: v[:, 24:] for g, v in gates.items()}, r, s1)
    _close(torch.cat([h1, h2], 1), h.numpy())


@pytest.mark.parametrize("S", [70, 100, 129])
def test_chunkwise_takes_an_s_its_chunk_does_not_divide(S):
    """A prompt of 100 tokens at the model's chunk of 64: the JAX function
    raises; the port runs a last, shorter chunk, which agrees with the
    sequential oracle (JAX's) at the property test's tolerance."""
    inp = _mlstm_inputs(30, B=1, S=S)
    with pytest.raises(ValueError, match="not divisible"):
        jax_xlstm.mlstm_chunkwise(*_j(inp), chunk=64)
    h_ref, st_ref = jax_xlstm.mlstm_sequential(*_j(inp))
    h_ck, st_ck = xlstm.mlstm_chunkwise(*_t(inp), chunk=64)
    _close(h_ck, h_ref, atol=5e-4, rtol=1e-3)
    for a, b in zip(st_ref, st_ck):
        _close(b, a, atol=5e-4, rtol=1e-3)
    assert math.isfinite(float(h_ck.abs().max()))
