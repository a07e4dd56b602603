"""The port's wire codecs (``repro_torch.cluster.wire``) against the JAX
package's (``repro.cluster.wire``), on the CPU.

The port mirrors every test of ``tests/test_wire.py`` but one:
``test_jax_array_ships_on_ndarray_codec`` has no counterpart, because the
port's codec has no JAX branch; a ``torch.Tensor`` takes the pickle codec
instead (``test_torch_tensor_takes_the_pickle_codec``).  On top, frames
cross between the two packages in both directions: both speak magic
``CGPP``, version 2, and pack the same payloads to the same bytes.

Arrays are made from a seed with numpy.  Runs under real hypothesis when
installed, else under the deterministic fallback installed by conftest.py.
"""

import pickle
import socket

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.cluster import wire as jax_wire
from repro_torch.cluster import wire
from repro_torch.cluster.wire import (
    DEFAULT_HEARTBEAT_S,
    Frame,
    FrameConnection,
    FrameType,
    _CodecId,
    encode_payload,
    pack_frame,
    unpack_frame,
)

DTYPES = ["float32", "float64", "int32", "uint8", "bool"]


def _roundtrip(payload):
    return unpack_frame(pack_frame(Frame(FrameType.RESULT, payload))).payload


def _codec_of(payload) -> int:
    return encode_payload(payload)[0]


# ---------------------------------------------------------------------------
# ndarray codec properties
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(
    dtype=st.sampled_from(DTYPES),
    shape=st.lists(st.integers(0, 5), min_size=0, max_size=3),
)
def test_ndarray_roundtrip_dtypes_and_shapes(dtype, shape):
    rng = np.random.default_rng(0)
    a = np.asarray(rng.random(tuple(shape)) * 100, dtype=dtype)
    assert _codec_of(a) == _CodecId.NDARRAY
    b = _roundtrip(a)
    assert b.dtype == a.dtype
    assert b.shape == a.shape
    assert np.array_equal(b, a)


@settings(max_examples=20, deadline=None)
@given(dtype=st.sampled_from(DTYPES), rows=st.integers(1, 6),
       cols=st.integers(1, 6))
def test_ndarray_roundtrip_fortran_and_noncontiguous(dtype, rows, cols):
    base = (np.arange(rows * cols * 4) % 7).astype(dtype).reshape(
        rows * 2, cols * 2
    )

    fortran = np.asfortranarray(base)
    assert fortran.flags.f_contiguous
    b = _roundtrip(fortran)
    assert np.array_equal(b, fortran) and b.shape == fortran.shape

    sliced = base[::2, ::2]  # a strided view: pays one compaction copy
    # A [1, 1] slice is a single element, which numpy counts as contiguous;
    # any larger slice of every other row and column is not.
    if sliced.size > 1:
        assert not sliced.flags.c_contiguous
    b = _roundtrip(sliced)
    assert np.array_equal(b, sliced) and b.dtype == sliced.dtype


def test_ndarray_zero_copy_encode_for_contiguous():
    a = np.arange(32, dtype=np.float32)
    codec, bufs = encode_payload(a)
    assert codec == _CodecId.NDARRAY
    raw = bufs[-1]
    assert isinstance(raw, memoryview)
    assert raw.obj is a or getattr(raw.obj, "base", None) is a


def test_ndarray_nested_in_msgpack_payload():
    a = np.linspace(0.0, 1.0, 7, dtype=np.float64)
    payload = {"id": 3, "value": a, "node_id": "node0"}
    assert _codec_of(payload) == _CodecId.MSGPACK
    back = _roundtrip(payload)
    assert back["id"] == 3 and back["node_id"] == "node0"
    assert np.array_equal(back["value"], a)


def test_empty_array_nested_in_msgpack_payload():
    payload = {"id": 1, "value": np.empty(0, dtype=np.float32)}
    back = _roundtrip(payload)
    assert back["value"].shape == (0,) and back["value"].dtype == np.float32


def test_structured_and_datetime_dtypes_fall_back_to_pickle():
    rec = np.zeros(3, dtype=[("x", "<f4"), ("y", "<i4")])
    rec["x"] = [1.0, 2.0, 3.0]
    assert _codec_of(rec) == _CodecId.PICKLE
    back = _roundtrip({"value": rec})["value"]
    assert back.dtype == rec.dtype
    assert np.array_equal(back["x"], rec["x"])

    dt = np.array(["2026-08-02", "2026-08-03"], dtype="datetime64[D]")
    assert _codec_of(dt) == _CodecId.PICKLE
    assert np.array_equal(_roundtrip(dt), dt)


def test_object_array_falls_back_to_pickle():
    o = np.array([{"a": 1}, None, (2, 3)], dtype=object)
    assert _codec_of(o) == _CodecId.PICKLE
    back = _roundtrip(o)
    assert back.dtype == object and list(back) == list(o)


def test_torch_tensor_takes_the_pickle_codec():
    """No tensor rides the raw-buffer codec: work results are meant to cross
    as plain values or numpy arrays.  A CPU tensor still round-trips."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert _codec_of(t) == _CodecId.PICKLE
    assert _codec_of({"value": t}) == _CodecId.PICKLE
    back = _roundtrip(t)
    assert isinstance(back, torch.Tensor) and torch.equal(back, t)


# ---------------------------------------------------------------------------
# single-pass encoder fallback ladder
# ---------------------------------------------------------------------------


def test_tuples_keep_exactness_via_pickle():
    payload = {"id": 1, "obj": (1, 2, [3, (4,)])}
    assert _codec_of(payload) == _CodecId.PICKLE
    back = _roundtrip(payload)
    assert back["obj"] == (1, 2, [3, (4,)])
    assert isinstance(back["obj"], tuple)


def test_plain_payloads_stay_on_msgpack():
    payload = {"node_id": "node0", "credits": 4,
               "results": [{"id": 0, "value": 1.5}]}
    assert _codec_of(payload) == _CodecId.MSGPACK
    assert _roundtrip(payload) == payload


def test_big_int_and_int_keys_roundtrip():
    assert _roundtrip({"value": 2**70})["value"] == 2**70
    assert _roundtrip({1: "a", "b": 2}) == {1: "a", "b": 2}


def test_deeply_nested_payload_raises_clear_error():
    deep = []
    for _ in range(100_000):
        deep = [deep]
    with pytest.raises(ValueError, match="nested too deeply"):
        pack_frame(Frame(FrameType.WORK, deep))


# ---------------------------------------------------------------------------
# batched frame types + shared heartbeat constant
# ---------------------------------------------------------------------------


def test_batch_frames_roundtrip():
    items = [{"id": i, "obj": i * i} for i in range(5)]
    g = unpack_frame(pack_frame(
        Frame(FrameType.WORK_BATCH, {"items": items})
    ))
    assert g.ftype is FrameType.WORK_BATCH and g.payload["items"] == items

    results = {"node_id": "n0", "credits": 2,
               "results": [{"id": 0, "value": 9}, {"id": 1, "value": 16}]}
    g = unpack_frame(pack_frame(Frame(FrameType.RESULT_BATCH, results)))
    assert g.ftype is FrameType.RESULT_BATCH and g.payload == results


def test_heartbeat_interval_shared_between_sides():
    from repro_torch.runtime.failures import HeartbeatMonitor

    assert HeartbeatMonitor().interval_s == DEFAULT_HEARTBEAT_S
    assert DEFAULT_HEARTBEAT_S == jax_wire.DEFAULT_HEARTBEAT_S


# ---------------------------------------------------------------------------
# job_id header field (wire v2, multi-job multiplexing)
# ---------------------------------------------------------------------------


@settings(max_examples=40, deadline=None)
@given(
    job_id=st.integers(0, 2**32 - 1),
    ftype=st.sampled_from([FrameType.WORK_BATCH, FrameType.RESULT_BATCH,
                           FrameType.LOAD, FrameType.JOB_CLOSE,
                           FrameType.WORK_REQUEST, FrameType.UT]),
)
def test_job_id_roundtrips_on_every_frame_type(job_id, ftype):
    f = Frame(ftype, {"node_id": "n0"}, wire.APP_WIRE_CHANNEL, job_id=job_id)
    g = unpack_frame(pack_frame(f))
    assert g.job_id == job_id
    assert g.ftype is ftype and g.channel == wire.APP_WIRE_CHANNEL


def test_job_id_defaults_to_zero():
    g = unpack_frame(pack_frame(Frame(FrameType.REGISTER, {"node_id": "n"})))
    assert g.job_id == 0


@settings(max_examples=20, deadline=None)
@given(
    job_id=st.integers(1, 2**32 - 1),
    dtype=st.sampled_from(DTYPES),
    n=st.integers(0, 16),
)
def test_job_id_roundtrips_with_ndarray_batches(job_id, dtype, n):
    a = (np.arange(n * 3) % 11).astype(dtype).reshape(n, 3)
    f = Frame(FrameType.RESULT_BATCH, a, wire.APP_WIRE_CHANNEL,
              job_id=job_id)
    g = unpack_frame(pack_frame(f))
    assert g.job_id == job_id
    assert np.array_equal(g.payload, a) and g.payload.dtype == a.dtype

    nested = {"node_id": "n0", "credits": 1,
              "results": [{"id": 0, "s": 0, "value": a}]}
    g = unpack_frame(pack_frame(
        Frame(FrameType.RESULT_BATCH, nested, wire.APP_WIRE_CHANNEL,
              job_id=job_id)
    ))
    assert g.job_id == job_id
    assert np.array_equal(g.payload["results"][0]["value"], a)


def test_wire_counters_track_traffic():
    a, b = socket.socketpair()
    left, right = FrameConnection(a), FrameConnection(b)
    try:
        f = Frame(FrameType.HEARTBEAT, {"node_id": "n"}, wire.LOAD_WIRE_CHANNEL)
        left.send(f)
        got = right.recv()
        assert got.payload == {"node_id": "n"}
        assert left.counters.frames_sent == 1
        assert right.counters.frames_recv == 1
        assert left.counters.bytes_sent == right.counters.bytes_recv > 0
    finally:
        left.close()
        right.close()


# ---------------------------------------------------------------------------
# one wire, two packages
# ---------------------------------------------------------------------------


def test_header_constants_equal_jax():
    assert (wire.MAGIC, wire.VERSION) == (jax_wire.MAGIC, jax_wire.VERSION) \
        == (b"CGPP", 2)
    assert {t.name: int(t) for t in wire.FrameType} == {
        t.name: int(t) for t in jax_wire.FrameType}
    assert (wire.LOAD_WIRE_CHANNEL, wire.APP_WIRE_CHANNEL) == (
        jax_wire.LOAD_WIRE_CHANNEL, jax_wire.APP_WIRE_CHANNEL)


def _payloads():
    rng = np.random.default_rng(7)
    return {
        "none": None,
        "msgpack": {"node_id": "node0", "credits": 4,
                    "results": [{"id": 0, "value": 1.5}]},
        "nested-array": {"id": 3, "value": rng.standard_normal(7)},
        "ndarray": rng.integers(0, 100, size=(4, 5), dtype=np.int32),
        "fortran": np.asfortranarray(rng.random((3, 6)).astype(np.float32)),
        "pickle-tuple": {"id": 1, "obj": (1, 2, [3, (4,)])},
        "big-int": {"value": 2**70},
    }


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_equal(a[k], b[k]) for k in a))
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", sorted(_payloads()))
@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
def test_frames_cross_between_packages(name, direction):
    src, dst = (jax_wire, wire) if direction == "jax-to-torch" else (wire, jax_wire)
    payload = _payloads()[name]
    for ftype in ("RESULT_BATCH", "WORK_BATCH", "HEARTBEAT"):
        raw = src.pack_frame(src.Frame(src.FrameType[ftype], payload,
                                       src.APP_WIRE_CHANNEL, job_id=12345))
        # the same frame, byte for byte, from either package
        assert raw == dst.pack_frame(dst.Frame(
            dst.FrameType[ftype], payload, dst.APP_WIRE_CHANNEL, job_id=12345))
        got = dst.unpack_frame(raw)
        assert got.ftype is dst.FrameType[ftype]
        assert (got.channel, got.job_id) == (dst.APP_WIRE_CHANNEL, 12345)
        assert _equal(payload, got.payload)


def test_shipped_code_crosses_between_packages():
    """A LOAD blob packed by one package's ``dumps_code`` loads with the
    other's ``loads_code``, plain pickle included."""
    for src, dst in ((jax_wire, wire), (wire, jax_wire)):
        assert dst.loads_code(src.dumps_code(abs))(-3) == 3
        assert dst.loads_code(pickle.dumps(divmod))(7, 2) == (3, 1)
