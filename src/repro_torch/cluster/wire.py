"""Wire format of the load and application networks.

Every message is one *frame*::

    +-------+---------+-------+-------+---------+---------+----------+---------+
    | magic | version | ftype | codec | channel | job_id  | length   | payload |
    | 4B    | 1B      | 1B    | 1B    | 1B      | 4B (!I) | 4B (!I)  | len B   |
    +-------+---------+-------+-------+---------+---------+----------+---------+

``ftype`` is the protocol event — the same alphabet as the CSP model in
``core.protocol`` plus the bootstrap events of paper §4 (Figure 1):
REGISTER/LOAD/HEARTBEAT ride the *load network* (channel 1, the paper's
"port 2000 channel 1"), WORK_REQUEST/WORK_BATCH/RESULT_BATCH/UT ride the
*application network* (channel 2).  ``UT`` is the paper's Universal
Terminator made visible on the wire.  WORK/RESULT are the original
one-object-per-frame events; the pipelined data plane coalesces them into
WORK_BATCH/RESULT_BATCH (see ARCHITECTURE.md "Data plane") but both sides
still accept the single-object forms.

``job_id`` (wire version 2) names the job every frame belongs to (the
JAX package's warm service multiplexes many jobs on one connection with
it; a run of this package has one job).  ``job_id == 0`` means "no job"
(bootstrap frames: REGISTER, HEARTBEAT, a peer-directory LOAD, the final
UT).

Payload encoding is a three-codec scheme:

* **msgpack** (codec 0) for protocol-internal messages built from plain
  JSON-ish data — cheap, language-neutral.  The encoder is single-pass:
  ``msgpack.packb(strict_types=True, default=...)`` either succeeds or
  raises on the first non-msgpack value (tuple, set, big int, custom
  class), in which case the whole payload falls back to pickle.  ndarrays
  nested inside msgpack payloads are carried as an ExtType (one copy).
* **pickle** (codec 1, via cloudpickle when available) for user objects and
  shipped code (the JCSP code-loading channel analogue of §4.1).
* **ndarray** (codec 2) for a bare ``numpy`` array payload: a tiny
  ``(order, dtype, shape)`` header followed by the raw buffer, sent as a
  ``memoryview`` — no pickle and *no copy on encode* for contiguous
  arrays.  Decode is ``np.frombuffer`` over the received bytes (read-only,
  zero-copy).  Object-dtype arrays are not bufferable and take the pickle
  codec instead.
"""

from __future__ import annotations

import enum
import io
import pickle
import socket
import struct
import sys
import threading
from dataclasses import dataclass
from typing import Any

try:
    import cloudpickle as _pickler
except ImportError:  # pragma: no cover - cloudpickle is in the image
    _pickler = pickle

try:
    import msgpack

    _HAVE_MSGPACK = True
except ImportError:  # pragma: no cover
    _HAVE_MSGPACK = False

MAGIC = b"CGPP"
VERSION = 2  # v2 added the job_id header field (multi-job multiplexing)
LOAD_WIRE_CHANNEL = 1  # paper §6: the load network uses channel number 1
APP_WIRE_CHANNEL = 2  # the application network runs on a separate channel

# One liveness default shared by the node beacon (pre- and post-LOAD) and the
# host's HeartbeatMonitor threshold, so neither side beats at a rate the
# other does not expect.
DEFAULT_HEARTBEAT_S = 0.2

# Guards against a corrupt length field consuming the heap.
MAX_FRAME_BYTES = 512 * 2**20

_HEADER = struct.Struct("!4sBBBBII")

# How deep the socket's buffered reader reads ahead: one recv syscall
# typically yields many small frames instead of 2+ recvs per frame.
READ_BUFFER_BYTES = 1 << 16


class FrameType(enum.IntEnum):
    REGISTER = 1  # NL -> HNL: node id + capabilities (load network)
    LOAD = 2  # HNL -> NL: serialized deployment (code-loading channel)
    WORK_REQUEST = 3  # NL -> HNL: demand signal carrying a credit count
    WORK = 4  # HNL -> NL: one work object (c!i.o) — legacy single form
    RESULT = 5  # NL -> HNL: one processed object (f!r) — legacy single form
    HEARTBEAT = 6  # NL -> HNL: liveness beacon (load network)
    UT = 7  # either direction: Universal Terminator / timing return
    WORK_BATCH = 8  # HNL -> NL: up to `credits` work objects in one frame
    RESULT_BATCH = 9  # NL -> HNL: coalesced results + piggybacked credits
    JOB_CLOSE = 10  # HNL -> NL: job finished/failed — drop its bindings
    REPORT = 11  # NL -> HNL: node telemetry push (load network, off-beat)
    ITEM_ACK = 12  # NL -> HNL: peer-forwarded item ids + piggybacked credits
    PEER_ITEMS = 13  # NL -> NL: stage-s results shipped directly as s+1 work
    PEER_HELLO = 14  # NL -> NL: data-plane handshake (sender's node id)
    BLOCK_REQUEST = 15  # NL -> HNL/NL: ask for one chunk of a published block
    BLOCK_CHUNK = 16  # HNL/NL -> NL: one block chunk (data=None on a miss)


class _CodecId(enum.IntEnum):
    MSGPACK = 0
    PICKLE = 1
    NDARRAY = 2


# msgpack ExtType code for an ndarray embedded in a larger payload.
_EXT_NDARRAY = 1


class UniversalTerminator:
    """The paper's UT object (§4, Listing 3 {3:21}), wire edition."""

    _instance: "UniversalTerminator | None" = None

    def __new__(cls) -> "UniversalTerminator":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "UT"


UT = UniversalTerminator()


@dataclass(frozen=True)
class Frame:
    ftype: FrameType
    payload: Any = None
    channel: int = APP_WIRE_CHANNEL
    job_id: int = 0  # 0 = not job-scoped (bootstrap frames)


# ---------------------------------------------------------------------------
# ndarray codec (codec 2 / ExtType 1)
# ---------------------------------------------------------------------------


def _as_wire_array(obj: Any):
    """A numpy view of ``obj`` if it is a bufferable array, else None.

    ``sys.modules.get`` instead of an import: if numpy was never imported in
    this process, ``obj`` cannot be an ndarray, and the bare node-loader
    bootstrap stays dependency-free.
    """
    np = sys.modules.get("numpy")
    # getattr guards: another thread may be mid-import (a worker pulling in
    # the shipped code's deps), leaving a partially initialized module in
    # sys.modules — in which case obj cannot be an array of that module yet.
    ndarray = getattr(np, "ndarray", None)
    if ndarray is None:
        return None
    if isinstance(obj, ndarray):
        return obj if _bufferable_dtype(obj.dtype) else None
    # Anything else, a torch.Tensor included, takes the pickle codec: work
    # results are meant to cross as plain values or numpy arrays.
    return None


def _bufferable_dtype(dtype) -> bool:
    """Only plain builtin dtypes ride the raw-buffer codec.

    ``dtype.str`` is the whole header, so anything it does not fully
    describe must take pickle instead: structured/record dtypes would
    silently drop their field names ('|V8'), datetime64/timedelta64 refuse
    buffer export, and object arrays are not buffers at all.
    """
    return dtype.kind in "biufcSU" and dtype.names is None


def _ndarray_buffers(a) -> list:
    """Encode one ndarray as ``[header, raw-buffer]``.

    The raw buffer is a memoryview of the array's own memory (zero-copy)
    for C- and F-contiguous arrays; only non-contiguous arrays pay one
    compaction copy.  F-order ships the bytes as laid out (via the
    C-contiguous transpose view) with an order flag so decode rebuilds the
    exact array.
    """
    import numpy as np

    if a.flags.c_contiguous:
        order, view = 0, a
    elif a.flags.f_contiguous:
        order, view = 1, a.T  # C-contiguous view over the same buffer
    else:
        order, view = 0, np.ascontiguousarray(a)
    dt = a.dtype.str.encode("ascii")
    header = (
        struct.pack(f"!BB{len(dt)}sB", order, len(dt), dt, a.ndim)
        + struct.pack(f"!{a.ndim}Q", *a.shape)
    )
    if view.size == 0:  # a zero in the shape cannot be cast to 'B'
        return [header, b""]
    return [header, memoryview(view).cast("B")]


def _decode_ndarray(raw) -> Any:
    try:
        import numpy as np
    except ImportError:  # pragma: no cover - symmetric environments
        raise RuntimeError("received ndarray frame but numpy unavailable")
    mv = memoryview(raw)
    order, dlen = struct.unpack_from("!BB", mv, 0)
    dtype = np.dtype(bytes(mv[2 : 2 + dlen]).decode("ascii"))
    (ndim,) = struct.unpack_from("!B", mv, 2 + dlen)
    off = 3 + dlen
    shape = struct.unpack_from(f"!{ndim}Q", mv, off)
    off += 8 * ndim
    arr = np.frombuffer(mv[off:], dtype=dtype)  # read-only, zero-copy
    return arr.reshape(shape, order="F" if order else "C")


def _msgpack_default(obj: Any):
    """Single-pass hook: arrays become an ExtType, anything else aborts the
    msgpack attempt (TypeError) and the payload falls back to pickle."""
    a = _as_wire_array(obj)
    if a is not None:
        header, raw = _ndarray_buffers(a)
        return msgpack.ExtType(_EXT_NDARRAY, header + bytes(raw))
    raise TypeError(f"not msgpack-encodable: {type(obj).__name__}")


def _msgpack_ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _decode_ndarray(data)
    return msgpack.ExtType(code, data)  # pragma: no cover - foreign ext


# ---------------------------------------------------------------------------
# payload codecs
# ---------------------------------------------------------------------------


def encode_payload(obj: Any) -> tuple[int, list]:
    """Encode ``obj`` to ``(codec, buffer list)`` in a single pass.

    A bare ndarray takes the zero-copy ndarray codec.  Everything else is
    attempted as msgpack (``strict_types`` keeps tuples exact by rejecting
    them) and falls back to pickle on the first non-msgpack value — no
    pre-pass traversal of the payload.  Payloads too deep for *any* codec
    raise a clear ValueError instead of a RecursionError from inside a
    serializer.
    """
    a = _as_wire_array(obj)
    if a is not None:
        try:
            return _CodecId.NDARRAY, _ndarray_buffers(a)
        except (TypeError, ValueError, struct.error):
            pass  # exotic dtype/layout the buffer codec cannot express
    if _HAVE_MSGPACK:
        try:
            return _CodecId.MSGPACK, [
                msgpack.packb(
                    obj,
                    use_bin_type=True,
                    strict_types=True,
                    default=_msgpack_default,
                )
            ]
        except (TypeError, ValueError, OverflowError, RecursionError):
            pass  # tuples, sets, big ints, custom classes, deep nesting
    try:
        return _CodecId.PICKLE, [_pickler.dumps(obj)]
    except RecursionError:
        raise ValueError(
            "payload nested too deeply for the wire codecs; "
            "flatten it before sending"
        ) from None
    except pickle.PicklingError as exc:
        # cloudpickle wraps the RecursionError; keep the clear diagnosis.
        if "recursion" in str(exc).lower():
            raise ValueError(
                "payload nested too deeply for the wire codecs; "
                "flatten it before sending"
            ) from None
        raise


def decode_payload(codec: int, raw) -> Any:
    if codec == _CodecId.MSGPACK:
        if not _HAVE_MSGPACK:  # pragma: no cover - symmetric environments
            raise RuntimeError("received msgpack frame but msgpack unavailable")
        return msgpack.unpackb(
            raw, raw=False, strict_map_key=False, ext_hook=_msgpack_ext_hook
        )
    if codec == _CodecId.PICKLE:
        return pickle.loads(raw)
    if codec == _CodecId.NDARRAY:
        return _decode_ndarray(raw)
    raise ValueError(f"unknown payload codec {codec}")


def _buffers_len(buffers) -> int:
    return sum(len(b) for b in buffers)


def pack_frame_buffers(frame: Frame) -> list:
    """Pack to ``[header, payload buffers...]`` without flattening.

    Callers that own a socket hand the list to ``sendmsg`` (scatter-gather:
    one syscall, zero concatenation); ``pack_frame`` flattens for callers
    that need contiguous bytes.
    """
    codec, bufs = encode_payload(frame.payload)
    length = _buffers_len(bufs)
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"frame payload too large: {length} bytes")
    header = _HEADER.pack(
        MAGIC, VERSION, int(frame.ftype), int(codec), frame.channel,
        frame.job_id, length,
    )
    return [header, *bufs]


def pack_frame(frame: Frame) -> bytes:
    return b"".join(
        b if isinstance(b, bytes) else b.tobytes()
        for b in pack_frame_buffers(frame)
    )


def unpack_frame(buf: bytes) -> Frame:
    return read_frame(io.BytesIO(buf).read)


def _read_exactly(read, n: int) -> bytes:
    chunks = []
    remaining = n
    while remaining:
        chunk = read(remaining)
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        chunks.append(chunk)
        remaining -= len(chunk)
    return chunks[0] if len(chunks) == 1 else b"".join(chunks)


def _read_frame_counted(read) -> tuple[Frame, int]:
    header = _read_exactly(read, _HEADER.size)
    magic, version, ftype, codec, channel, job_id, length = (
        _HEADER.unpack(header)
    )
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic!r}")
    if version != VERSION:
        raise ValueError(f"unsupported wire version {version}")
    if length > MAX_FRAME_BYTES:
        raise ValueError(f"frame length {length} exceeds cap")
    raw = _read_exactly(read, length) if length else b""
    frame = Frame(
        FrameType(ftype), decode_payload(codec, raw), channel, job_id
    )
    return frame, _HEADER.size + length


def read_frame(read) -> Frame:
    """Read one frame from any ``read(n) -> bytes`` source (socket, buffer)."""
    return _read_frame_counted(read)[0]


@dataclass
class WireCounters:
    """Per-connection traffic counters (bytes/frames each way).

    Mutated under the connection's send lock (send side) and by the single
    reader thread (recv side); reads from other threads see a consistent
    enough snapshot for reporting.
    """

    frames_sent: int = 0
    frames_recv: int = 0
    bytes_sent: int = 0
    bytes_recv: int = 0

    def as_dict(self) -> dict[str, int]:
        return {
            "frames_sent": self.frames_sent,
            "frames_recv": self.frames_recv,
            "bytes_sent": self.bytes_sent,
            "bytes_recv": self.bytes_recv,
        }

    def merge(self, other: "WireCounters | dict") -> None:
        """Fold another connection's counters into this one (cluster-wide
        totals for telemetry/timing reports)."""
        d = other.as_dict() if isinstance(other, WireCounters) else other
        self.frames_sent += d.get("frames_sent", 0)
        self.frames_recv += d.get("frames_recv", 0)
        self.bytes_sent += d.get("bytes_sent", 0)
        self.bytes_recv += d.get("bytes_recv", 0)

    @classmethod
    def total(cls, counters: "list[WireCounters]") -> "WireCounters":
        out = cls()
        for c in counters:
            out.merge(c)
        return out


class FrameConnection:
    """A framed, thread-safe view of one TCP socket.

    Many threads may ``send`` (workers delivering results while the heartbeat
    thread beats); exactly one thread should ``recv`` — the reader owns frame
    routing (see :mod:`repro_torch.cluster.netchannels`).  Receives go through a
    buffered reader so one kernel ``recv`` serves many small frames; sends go
    through ``sendmsg`` scatter-gather so a frame (header + payload buffers)
    is one syscall with no concatenation copy.
    """

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._send_lock = threading.Lock()
        self._closed = False
        self.counters = WireCounters()
        self._rfile = sock.makefile("rb", buffering=READ_BUFFER_BYTES)
        # TCP_NODELAY: frames are small and latency-sensitive (demand signals).
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:  # pragma: no cover - non-TCP sockets in tests
            pass

    @property
    def peer(self) -> str:
        try:
            name = self.sock.getpeername()
        except OSError:
            return "<closed>"
        if isinstance(name, tuple) and len(name) >= 2:
            return f"{name[0]}:{name[1]}"
        return str(name) or "<unnamed>"  # AF_UNIX pairs have no address

    def send(self, frame: Frame) -> None:
        bufs = pack_frame_buffers(frame)
        self.send_raw(bufs)

    def send_raw(self, bufs: list) -> None:
        """Send pre-packed frame buffers (``[header, *payload]``) verbatim.

        Lets callers that need byte-level control over the wire image —
        the chaos layer's payload-corruption fault — reuse the locked
        scatter-gather path instead of poking at the socket directly.
        """
        total = _buffers_len(bufs)
        with self._send_lock:
            self._send_buffers(bufs, total)
            self.counters.frames_sent += 1
            self.counters.bytes_sent += total

    def _send_buffers(self, bufs: list, total: int) -> None:
        try:
            sent = self.sock.sendmsg(bufs)
        except AttributeError:  # pragma: no cover - no scatter-gather here
            self.sock.sendall(
                b"".join(b if isinstance(b, bytes) else b.tobytes()
                         for b in bufs)
            )
            return
        if sent == total:
            return
        for b in bufs:  # short write: finish the remaining tail
            n = len(b)
            if sent >= n:
                sent -= n
                continue
            mv = memoryview(b)
            self.sock.sendall(mv[sent:] if sent else mv)
            sent = 0

    def recv(self) -> Frame:
        frame, nbytes = _read_frame_counted(self._rfile.read)
        self.counters.frames_recv += 1
        self.counters.bytes_recv += nbytes
        return frame

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            # Unblocks a reader parked in recv before we tear the fd down.
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
        try:
            self._rfile.close()
        except (OSError, ValueError):
            pass


def dumps_code(obj: Any) -> bytes:
    """Serialise shipped code (work functions, details) by value.

    cloudpickle captures closures and locally-defined functions; plain pickle
    (the fallback) requires them to be importable on the node — which the
    launcher guarantees by exporting the host's ``sys.path``.
    """
    return _pickler.dumps(obj)


def loads_code(raw: bytes) -> Any:
    return pickle.loads(raw)
