"""Socket-backed channel ends with the threaded runtime's blocking API.

``runtime.local`` wires the Figure-2 network with ``queue.Queue(maxsize=1)``
one-place buffers; this module gives the *same* blocking ``put``/``get``
surface to channel ends whose other end lives in a different OS process.
Because the API and the buffering discipline are identical, the CSP model
checked by ``core.verify`` (one-place nrfa buffer, server answers every
request in finite time, UT flood on shutdown) describes the socket network
too — only the transport changed.

A :class:`ChannelMux` owns one :class:`~repro_torch.cluster.wire.FrameConnection`
and a reader thread that routes incoming frames to per-channel inboxes; a
:class:`NetChannelEnd` is one (wire channel, frame type) view of the mux.

Fault injection: the mux only needs ``send``/``recv``/``close``/``peer``
from its connection, so a :class:`~repro_torch.cluster.chaos.FaultyConnection`
(the chaos layer's drop/delay/duplicate/corrupt wrapper) slots in wherever
a bare ``FrameConnection`` does.  Either way a dead transport surfaces as
:class:`ChannelClosed` on *both* operations — a blocked ``get`` and a
``put`` into a severed socket raise the same typed error, so runtime code
has one failure vocabulary for the read and write sides.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable

from repro_torch.cluster.wire import (
    APP_WIRE_CHANNEL,
    UT,
    Frame,
    FrameConnection,
    FrameType,
)

__all__ = ["ChannelClosed", "ChannelMux", "NetChannelEnd"]


class ChannelClosed(ConnectionError):
    """The underlying socket died while a channel end was blocked on it."""


_CLOSED = object()


class NetChannelEnd:
    """One directional channel end over a mux (paper: ip:port/channel)."""

    def __init__(self, mux: "ChannelMux", wire_channel: int, ftype: FrameType,
                 inbox: queue.Queue):
        self._mux = mux
        self._wire_channel = wire_channel
        self._ftype = ftype
        self._inbox = inbox

    # The queue.Queue surface used by runtime.local -------------------------

    def put(self, obj: Any) -> None:
        """Write ``obj`` to the remote end (UT is sent as a typed frame).

        A dead socket raises :class:`ChannelClosed`, mirroring ``get`` —
        the writer learns its peer is gone as a typed channel error, not a
        raw OSError that depends on which syscall happened to fail.
        """
        frame = (Frame(FrameType.UT, None, self._wire_channel) if obj is UT
                 else Frame(self._ftype, obj, self._wire_channel))
        try:
            self._mux.send(frame)
        except ChannelClosed:
            raise
        except (ConnectionError, OSError) as exc:
            raise ChannelClosed(
                f"peer {self._mux.conn.peer} closed while sending"
            ) from exc

    def get(self, timeout: float | None = None) -> Any:
        obj = self._inbox.get(timeout=timeout)
        if obj is _CLOSED:
            self._inbox.put(_CLOSED)  # keep later readers failing too
            raise ChannelClosed(f"peer {self._mux.conn.peer} closed")
        return obj


class ChannelMux:
    """Routes frames on one connection to per-wire-channel one-place inboxes.

    ``open`` declares a readable channel *before* the reader can deliver to
    it — the paper's "input ends are created before output ends" bootstrap
    rule (§4), enforced here per connection.
    """

    def __init__(self, conn: FrameConnection,
                 on_unrouted: Callable[[Frame], None] | None = None):
        self.conn = conn
        self._inboxes: dict[int, queue.Queue] = {}
        self._lock = threading.Lock()
        self._on_unrouted = on_unrouted
        self._reader: threading.Thread | None = None

    def open(self, wire_channel: int = APP_WIRE_CHANNEL,
             ftype: FrameType = FrameType.WORK, maxsize: int = 1,
             ) -> NetChannelEnd:
        with self._lock:
            if wire_channel not in self._inboxes:
                self._inboxes[wire_channel] = queue.Queue(maxsize=maxsize)
            inbox = self._inboxes[wire_channel]
        return NetChannelEnd(self, wire_channel, ftype, inbox)

    def send(self, frame: Frame) -> None:
        self.conn.send(frame)

    def start(self) -> None:
        self._reader = threading.Thread(
            target=self._read_loop, name="channel-mux-reader", daemon=True
        )
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                frame = self.conn.recv()
                self._route(frame)
        except (ConnectionError, OSError, ValueError):
            with self._lock:
                inboxes = list(self._inboxes.values())
            for inbox in inboxes:
                inbox.put(_CLOSED)

    def _route(self, frame: Frame) -> None:
        with self._lock:
            inbox = self._inboxes.get(frame.channel)
        if inbox is None:
            if self._on_unrouted is not None:
                self._on_unrouted(frame)
            return
        if frame.ftype is FrameType.UT:
            inbox.put(UT)
        else:
            inbox.put(frame.payload)

    def close(self) -> None:
        self.conn.close()
