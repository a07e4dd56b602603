"""Peer data plane: direct node→node stage forwarding.

The paper's Host–Node topology relays every stage-to-stage byte through the
host, so the host NIC is the throughput ceiling for multi-stage pipelines.
This module decentralises the *data* plane while the host keeps the whole
*control* plane — placement, credits, liveness, and the exactly-once ledger:

* Every node-loader opens one listening :class:`PeerServer` socket and
  reports its port in REGISTER.  The host ships a **peer directory**
  (``node_id -> (ip, port)``) and, per job, a **routing table** (source
  stage ``s`` -> ordered target nodes for the ``s -> s+1`` hop) inside the
  LOAD payload.
* For a hop marked ``route="peer"`` a stage-``s`` node ships its results
  *directly* to a stage-``s+1`` node as a ``PEER_ITEMS`` frame (placement:
  round-robin, or ``key_fn``-keyed partition — a keyed shuffle for free)
  and tells the host what it did with a compact ``ITEM_ACK`` (ids only).
  The host records the forwarded item in its peer-inflight ledger so a
  dead receiver's stranded items are re-dispatched, and duplicate results
  are dropped by the same per-stage dedup that covers host-routed hops.

Failure semantics: a peer send tries every routing-table target in
preference order and falls back to the ordinary host-relayed RESULT_BATCH
when no peer is reachable — peer routing is an optimisation, never a
correctness dependency.  The JAX package's broadcast blocks (named blobs
published through its warm service) and its chaos seam (partitioned peer
edges) are not ported yet.
"""

from __future__ import annotations

import hashlib
import socket
import threading
from typing import Any, Callable

from repro_torch.cluster.netchannels import ChannelClosed
from repro_torch.cluster.wire import (
    APP_WIRE_CHANNEL,
    Frame,
    FrameConnection,
    FrameType,
    loads_code,
    pack_frame_buffers,
    _buffers_len,
)

__all__ = ["PeerClient", "PeerServer", "RouteTable", "stable_hash"]

# How long a dialed peer link waits on connect and on a send before the link
# is declared dead and the caller falls back (next target / host).
PEER_DIAL_TIMEOUT_S = 5.0
PEER_IO_TIMEOUT_S = 10.0


# ---------------------------------------------------------------------------
# Stable hashing (keyed partition must agree across processes)
# ---------------------------------------------------------------------------


def stable_hash(key: Any) -> int:
    """A process-independent 64-bit hash for keyed partitioning.

    Python's builtin ``hash`` is salted per process (PYTHONHASHSEED), so two
    nodes would disagree on ``hash(key) % n``; this one is stable across
    processes, runs, and machines for the common key types.
    """
    return int.from_bytes(
        hashlib.sha256(_hash_bytes(key)).digest()[:8], "big"
    )


def _hash_bytes(key: Any) -> bytes:
    if isinstance(key, bytes):
        return b"b:" + key
    if isinstance(key, str):
        return b"s:" + key.encode("utf-8", "surrogatepass")
    if isinstance(key, bool):
        return b"B:1" if key else b"B:0"
    if isinstance(key, int):
        return b"i:%d" % key
    if isinstance(key, float):
        return b"f:" + repr(key).encode()
    if key is None:
        return b"n:"
    if isinstance(key, (tuple, list)):
        return b"t:" + b",".join(_hash_bytes(k) for k in key)
    return b"r:" + repr(key).encode("utf-8", "backslashreplace")


# ---------------------------------------------------------------------------
# Routing tables (node side; built by the host, shipped in LOAD)
# ---------------------------------------------------------------------------


class RouteTable:
    """Per-job peer routing: source stage ``s`` -> hop placement.

    ``raw`` is the host's wire form: ``{str(s): {"targets": [node_id...],
    "mode": "rr"|"keyed", "key_fn": code-blob|None}}``.  ``targets_for``
    returns the full target list in *preference order* — the sender walks
    it until a send succeeds, then falls back to the host, so a stale
    table (dead target, healed replacement not listed) degrades instead of
    failing.  Keyed mode pins the first preference by ``stable_hash(
    key_fn(value))``; under a dead primary the key rehashes to the next
    target — placement is best-effort, correctness never depends on it.
    """

    def __init__(self, raw: dict):
        self._lock = threading.Lock()
        self._entries: dict[int, dict] = {}
        for s, ent in (raw or {}).items():
            blob = ent.get("key_fn")
            self._entries[int(s)] = {
                "targets": list(ent.get("targets") or []),
                "key_fn": loads_code(blob) if blob else None,
                "rr": 0,
            }

    def stages(self) -> set[int]:
        return set(self._entries)

    def has(self, s: int) -> bool:
        return s in self._entries and bool(self._entries[s]["targets"])

    def targets_for(self, s: int, value: Any) -> list[str]:
        ent = self._entries.get(s)
        if ent is None or not ent["targets"]:
            return []
        targets = ent["targets"]
        if ent["key_fn"] is not None:
            first = stable_hash(ent["key_fn"](value)) % len(targets)
        else:
            with self._lock:
                first = ent["rr"] % len(targets)
                ent["rr"] += 1
        return [targets[(first + k) % len(targets)] for k in range(len(targets))]


# ---------------------------------------------------------------------------
# Peer links (dial side)
# ---------------------------------------------------------------------------


class _PeerLink:
    """One dialed data-plane connection to a sibling node.  Sends
    (PEER_ITEMS) never expect a reply."""

    def __init__(self, conn: FrameConnection):
        self.conn = conn
        self.alive = True

    def send_items(self, job_id: int, sender: str, items: list[dict]) -> int:
        frame = Frame(FrameType.PEER_ITEMS, {"from": sender, "items": items},
                      APP_WIRE_CHANNEL, job_id)
        bufs = pack_frame_buffers(frame)
        nbytes = _buffers_len(bufs)
        self.conn.send_raw(bufs)
        return nbytes

    def close(self) -> None:
        self.alive = False
        self.conn.close()


class PeerClient:
    """Dial-and-cache peer links, keyed by target node id.

    ``directory`` is the live ``node_id -> (ip, port)`` map owned by the
    node-loader (merged from every LOAD); the client resolves targets at
    send time so directory refreshes take effect without reconnecting.
    """

    def __init__(self, node_id: str, directory: dict[str, tuple[str, int]]):
        self.node_id = node_id
        self.directory = directory
        self._links: dict[str, _PeerLink] = {}
        self._lock = threading.Lock()
        self.items_sent = 0
        self.bytes_sent = 0

    def _link(self, target: str) -> _PeerLink:
        with self._lock:
            link = self._links.get(target)
        if link is not None and link.alive:
            return link
        addr = self.directory.get(target)
        if not addr:
            raise ChannelClosed(f"no peer address for {target!r}")
        host, port = addr[0], int(addr[1])
        try:
            sock = socket.create_connection((host, port),
                                            timeout=PEER_DIAL_TIMEOUT_S)
        except OSError as exc:
            raise ChannelClosed(f"dial {target} ({host}:{port}): {exc}") from exc
        sock.settimeout(PEER_IO_TIMEOUT_S)
        link = _PeerLink(FrameConnection(sock))
        try:
            link.conn.send(Frame(FrameType.PEER_HELLO,
                                 {"node_id": self.node_id}))
        except OSError as exc:
            link.close()
            raise ChannelClosed(f"hello to {target}: {exc}") from exc
        with self._lock:
            prior = self._links.get(target)
            if prior is not None and prior.alive:
                link.close()
                return prior
            self._links[target] = link
        return link

    def _drop(self, target: str) -> None:
        with self._lock:
            link = self._links.pop(target, None)
        if link is not None:
            link.close()

    def send_items(self, job_id: int, target: str, items: list[dict]) -> int:
        """Ship result items to ``target``; returns bytes on the wire.
        Raises :class:`ChannelClosed` when the edge is unusable."""
        link = self._link(target)
        try:
            nbytes = link.send_items(job_id, self.node_id, items)
        except (OSError, ValueError) as exc:
            self._drop(target)
            raise ChannelClosed(f"send to {target}: {exc}") from exc
        self.items_sent += len(items)
        self.bytes_sent += nbytes
        return nbytes

    def close(self) -> None:
        with self._lock:
            links, self._links = list(self._links.values()), {}
        for link in links:
            link.close()


# ---------------------------------------------------------------------------
# Peer server (listen side)
# ---------------------------------------------------------------------------


class PeerServer:
    """A node's listening data-plane socket.

    One accept thread; one reader thread per accepted connection, handling
    PEER_HELLO (identify sender) and PEER_ITEMS (hand work to the
    node-loader via ``on_items``).  Items arriving before the node-loader
    has installed its handler are held and drained on
    :meth:`set_on_items` — a sibling's LOAD can complete before ours.
    """

    def __init__(self, node_id: str, bind_host: str = "0.0.0.0"):
        self.node_id = node_id
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind_host, 0))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._lock = threading.Lock()
        self._on_items: Callable[[int, list], None] | None = None
        self._intake_gate: Callable[[int], None] | None = None
        self._held: list[tuple[int, list]] = []
        self._conns: list[FrameConnection] = []
        self._closed = False
        self.items_recv = 0
        self.bytes_recv = 0

    def set_on_items(self, fn: Callable[[int, list], None]) -> None:
        with self._lock:
            self._on_items = fn
            held, self._held = self._held, []
        for job_id, items in held:
            fn(job_id, items)

    def set_intake_gate(self, gate: Callable[[int], None]) -> None:
        """Install a backpressure gate called (with the item count) on the
        reader thread before each PEER_ITEMS batch is handed over.  A gate
        that blocks while the node's peer backlog is full stops the socket
        drain, so the kernel buffers fill and TCP throttles the sender —
        the peer plane's analogue of the host's credit window."""
        with self._lock:
            self._intake_gate = gate

    def start(self) -> None:
        threading.Thread(target=self._accept_loop,
                         name=f"peer-accept-{self.node_id}",
                         daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                sock, _ = self._sock.accept()
            except OSError:
                return
            conn = FrameConnection(sock)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name=f"peer-serve-{self.node_id}",
                             daemon=True).start()

    def _serve(self, conn: FrameConnection) -> None:
        try:
            while True:
                frame = conn.recv()
                if frame.ftype is FrameType.PEER_ITEMS:
                    items = frame.payload.get("items") or []
                    self.items_recv += len(items)
                    with self._lock:
                        handler = self._on_items
                        gate = self._intake_gate
                        if handler is None:
                            self._held.append((frame.job_id, items))
                    if handler is not None:
                        if gate is not None:
                            gate(len(items))
                        handler(frame.job_id, items)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            self.bytes_recv += conn.counters.bytes_recv
            conn.close()
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    def counters(self) -> dict[str, int]:
        with self._lock:
            live = sum(c.counters.bytes_recv for c in self._conns)
        return {
            "peer_items_recv": self.items_recv,
            "peer_bytes_recv": self.bytes_recv + live,
        }

    def close(self) -> None:
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), []
        for conn in conns:
            conn.close()
