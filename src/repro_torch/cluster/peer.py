"""Peer data plane: direct node→node stage forwarding + broadcast blocks.

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
* On the same sockets rides a chunked **broadcast block** layer: the host
  publishes named immutable blobs (``ClusterService.publish_block``),
  nodes stripe their first fetch across the host (each node pulls a
  disjoint ``1/n`` of the chunks) and trade the remaining chunks with each
  other, so an N-node pool costs the host ~1 copy instead of N.  Complete
  blocks are LRU-bounded like the warm code cache; work functions read
  them via :func:`get_block`.

Failure semantics: a peer send tries every routing-table target in
preference order and falls back to the ordinary host-relayed RESULT_BATCH
when no peer is reachable — peer routing is an optimisation, never a
correctness dependency.  The chaos harness cuts edges via
:func:`partition_node` (module-level seam, effective under the in-process
launcher where all node threads share this module).
"""

from __future__ import annotations

import hashlib
import socket
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Iterable

from repro_torch.cluster.netchannels import ChannelClosed
from repro_torch.cluster.wire import (
    APP_WIRE_CHANNEL,
    BLOCK_CACHE_SLOTS,
    BLOCK_CHUNK_BYTES,
    Frame,
    FrameConnection,
    FrameType,
    loads_code,
    pack_frame_buffers,
    _buffers_len,
)

__all__ = [
    "BlockRegistry", "BlockStore", "PeerClient", "PeerServer", "RouteTable",
    "block_digest", "fetch_blocks", "get_block", "heal_partitions",
    "partition_node", "stable_hash",
]

# How long a dialed peer link waits on connect and on a chunk reply before
# the link is declared dead and the caller falls back (next target / host).
PEER_DIAL_TIMEOUT_S = 5.0
PEER_IO_TIMEOUT_S = 10.0


# ---------------------------------------------------------------------------
# Chaos seam: partitioned peer edges
# ---------------------------------------------------------------------------

_partition_lock = threading.Lock()
_partitioned_until: dict[str, float] = {}


def partition_node(node_id: str, duration_s: float = 1.0) -> None:
    """Cut every peer edge touching ``node_id`` for ``duration_s``.

    Module-level on purpose: under the in-process launcher all node threads
    share this module, so the chaos controller (host side) can sever edges
    the node-loaders will honour.  Subprocess pools do not see it — the
    chaos fault documents that limitation.

    The cut is enforced on the *send* side only (``PeerClient._link``
    checks both endpoints before every transfer).  Item frames already in
    flight when the partition activates are still processed by the
    receiver: the sender has told the host the transfer succeeded, so a
    receiver-side drop would strand the item in the exactly-once ledger
    at a live target and stall the job to its deadline.  Block chunk
    *requests* answer ``data=None`` under a partition instead — the
    fetcher treats that as a miss and retries elsewhere, so the stricter
    behaviour is safe there.
    """
    with _partition_lock:
        _partitioned_until[node_id] = time.monotonic() + duration_s


def heal_partitions() -> None:
    with _partition_lock:
        _partitioned_until.clear()


def is_partitioned(*node_ids: str | None) -> bool:
    now = time.monotonic()
    with _partition_lock:
        return any(
            nid is not None and _partitioned_until.get(nid, 0.0) > now
            for nid in node_ids
        )


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
# Broadcast blocks
# ---------------------------------------------------------------------------


def block_digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _nchunks(size: int) -> int:
    return max(1, -(-size // BLOCK_CHUNK_BYTES))


class BlockRegistry:
    """Host-side store of published blocks (the origin copy).

    ``publish`` is idempotent for identical bytes; re-publishing a name
    with different content raises — blocks are immutable by contract (the
    digest in the manifest is what nodes verify against).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._blocks: dict[str, bytes] = {}
        self._meta: dict[str, dict] = {}
        self.chunks_served = 0
        self.chunk_bytes_served = 0

    def publish(self, name: str, data: bytes) -> str:
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise TypeError(f"block {name!r} must be bytes, got {type(data)}")
        data = bytes(data)
        digest = block_digest(data)
        with self._lock:
            prior = self._meta.get(name)
            if prior is not None and prior["digest"] != digest:
                raise ValueError(
                    f"block {name!r} already published with different content"
                )
            self._blocks[name] = data
            self._meta[name] = {
                "name": name, "digest": digest, "size": len(data),
                "nchunks": _nchunks(len(data)),
            }
        return digest

    def manifest(self) -> list[dict]:
        with self._lock:
            return [dict(m) for m in self._meta.values()]

    def get_chunk(self, name: str, idx: int) -> bytes | None:
        with self._lock:
            data = self._blocks.get(name)
            if data is None:
                return None
            lo = idx * BLOCK_CHUNK_BYTES
            if idx < 0 or lo >= len(data) and not (idx == 0 and not data):
                return None
            chunk = data[lo:lo + BLOCK_CHUNK_BYTES]
            self.chunks_served += 1
            self.chunk_bytes_served += len(chunk)
            return chunk


# Process-global published blocks: the read side for work functions.  Under
# the in-process launcher every node thread shares this dict — harmless,
# since blocks are immutable and digest-verified.  Entries are refcounted
# by the BlockStores holding the block resident, and evicted when the last
# holder's LRU lets go, so this mirror is bounded by the stores' slots and
# a long-lived warm pool node does not retain every block ever published.
_global_cv = threading.Condition()
_global_blocks: dict[str, bytes] = {}
_global_refs: dict[str, int] = {}


def get_block(name: str, timeout: float = 60.0) -> bytes:
    """Read a published broadcast block from inside a work function.

    Blocks are fetched at LOAD time; the wait only triggers when a work
    item races ahead of a still-assembling block.
    """
    deadline = time.monotonic() + timeout
    with _global_cv:
        while name not in _global_blocks:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise KeyError(f"block {name!r} not available on this node")
            _global_cv.wait(remaining)
        return _global_blocks[name]


def _publish_global(name: str, data: bytes) -> None:
    with _global_cv:
        _global_blocks[name] = data
        _global_refs[name] = _global_refs.get(name, 0) + 1
        _global_cv.notify_all()


def _unpublish_global(name: str) -> None:
    """One holder evicted/released the block; drop the global copy when
    the last holder is gone."""
    with _global_cv:
        refs = _global_refs.get(name, 0) - 1
        if refs > 0:
            _global_refs[name] = refs
        else:
            _global_refs.pop(name, None)
            _global_blocks.pop(name, None)


class BlockStore:
    """Node-side chunk assembly + LRU-bounded complete blocks.

    Chunks arrive from two directions (host replies routed by the frame
    loop, synchronous peer fetches) and are idempotent; a completed block
    is digest-verified before it becomes readable, a corrupt assembly is
    dropped so the fetcher retries from the host.
    """

    def __init__(self, slots: int = BLOCK_CACHE_SLOTS):
        self._cv = threading.Condition()
        self._slots = slots
        self._blocks: OrderedDict[str, bytes] = OrderedDict()
        self._meta: dict[str, dict] = {}
        self._partial: dict[str, dict[int, bytes]] = {}
        self.fetched_from_peers = 0
        self.fetched_from_host = 0
        self.chunks_served = 0
        self.digest_failures = 0

    def expect(self, entry: dict) -> bool:
        """Register a manifest entry; True when the block still needs
        fetching on this node."""
        name = entry["name"]
        with self._cv:
            if name in self._blocks and (
                self._meta[name]["digest"] == entry["digest"]
            ):
                self._blocks.move_to_end(name)
                return False
            self._meta[name] = dict(entry)
            self._partial.setdefault(name, {})
            return True

    def missing(self, name: str) -> list[int]:
        with self._cv:
            meta = self._meta.get(name)
            if meta is None or name in self._blocks:
                return []
            have = self._partial.get(name) or {}
            return [c for c in range(meta["nchunks"]) if c not in have]

    def add_chunk(self, name: str, idx: int, data: bytes | None,
                  *, from_peer: bool = False) -> None:
        if data is None:
            return
        with self._cv:
            meta = self._meta.get(name)
            if meta is None or name in self._blocks:
                return
            part = self._partial.setdefault(name, {})
            if idx in part or not (0 <= idx < meta["nchunks"]):
                return
            part[idx] = bytes(data)
            if from_peer:
                self.fetched_from_peers += 1
            else:
                self.fetched_from_host += 1
            if len(part) < meta["nchunks"]:
                return
            blob = b"".join(part[c] for c in range(meta["nchunks"]))
            if block_digest(blob) != meta["digest"] or len(blob) != meta["size"]:
                self.digest_failures += 1
                self._partial[name] = {}
                return
            self._partial.pop(name, None)
            self._blocks[name] = blob
            evicted = []
            while len(self._blocks) > self._slots:
                old, _ = self._blocks.popitem(last=False)
                self._meta.pop(old, None)
                evicted.append(old)
            _publish_global(name, blob)
            # The global read-side mirror must shrink with the LRU or an
            # immortal pool node retains every block ever published.
            for old in evicted:
                _unpublish_global(old)
            self._cv.notify_all()

    def get_chunk(self, name: str, idx: int) -> bytes | None:
        """Serve a chunk to a peer — from a complete block or a partial
        assembly (striped chunks propagate before the block completes)."""
        with self._cv:
            data = self._blocks.get(name)
            if data is not None:
                self._blocks.move_to_end(name)
                lo = idx * BLOCK_CHUNK_BYTES
                if idx < 0 or (lo >= len(data) and not (idx == 0 and not data)):
                    return None
                self.chunks_served += 1
                return data[lo:lo + BLOCK_CHUNK_BYTES]
            chunk = (self._partial.get(name) or {}).get(idx)
            if chunk is not None:
                self.chunks_served += 1
            return chunk

    def has(self, name: str) -> bool:
        with self._cv:
            return name in self._blocks

    def wait(self, name: str, timeout: float = 60.0) -> bytes:
        deadline = time.monotonic() + timeout
        with self._cv:
            while name not in self._blocks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"block {name!r} incomplete after {timeout}s")
                self._cv.wait(remaining)
            return self._blocks[name]

    def counters(self) -> dict[str, int]:
        with self._cv:
            return {
                "blocks_fetched_from_peers": self.fetched_from_peers,
                "blocks_fetched_from_host": self.fetched_from_host,
                "block_chunks_served": self.chunks_served,
                "blocks_resident": len(self._blocks),
            }

    def release(self) -> None:
        """Drop every resident block and its global refcounts — node
        shutdown; without this an in-process pool's exited nodes would
        pin their blocks in the process-global mirror forever."""
        with self._cv:
            names, self._blocks = list(self._blocks), OrderedDict()
            self._meta.clear()
            self._partial.clear()
        for name in names:
            _unpublish_global(name)


# ---------------------------------------------------------------------------
# Peer links (dial side)
# ---------------------------------------------------------------------------


class _PeerLink:
    """One dialed data-plane connection to a sibling node.

    Sends (PEER_ITEMS) never expect a reply; the only request/response pair
    is BLOCK_REQUEST -> BLOCK_CHUNK, serialised under ``_req_lock`` so the
    single ``recv`` always reads its own reply (the server answers frames
    in arrival order).
    """

    def __init__(self, conn: FrameConnection):
        self.conn = conn
        self._req_lock = threading.Lock()
        self.alive = True

    def send_items(self, job_id: int, sender: str, items: list[dict]) -> int:
        frame = Frame(FrameType.PEER_ITEMS, {"from": sender, "items": items},
                      APP_WIRE_CHANNEL, job_id)
        bufs = pack_frame_buffers(frame)
        nbytes = _buffers_len(bufs)
        self.conn.send_raw(bufs)
        return nbytes

    def fetch_chunk(self, name: str, idx: int) -> bytes | None:
        with self._req_lock:
            self.conn.send(Frame(FrameType.BLOCK_REQUEST,
                                 {"name": name, "chunk": idx}))
            reply = self.conn.recv()
        if reply.ftype is not FrameType.BLOCK_CHUNK:
            raise ChannelClosed(f"unexpected {reply.ftype.name} on peer link")
        return reply.payload.get("data")

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
        if is_partitioned(self.node_id, target):
            raise ChannelClosed(
                f"peer edge {self.node_id}->{target} partitioned")
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

    def fetch_chunk(self, target: str, name: str, idx: int) -> bytes | None:
        """Fetch one block chunk from a peer; None means the peer does not
        have it yet.  Raises :class:`ChannelClosed` on a dead edge."""
        link = self._link(target)
        try:
            return link.fetch_chunk(name, idx)
        except (OSError, ChannelClosed, ValueError) as exc:
            self._drop(target)
            if isinstance(exc, ChannelClosed):
                raise
            raise ChannelClosed(f"fetch from {target}: {exc}") from exc

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
    PEER_HELLO (identify sender), PEER_ITEMS (hand work to the node-loader
    via ``on_items``) and BLOCK_REQUEST (serve a chunk from the local
    store).  Items arriving before the node-loader has installed its
    handler are held and drained on :meth:`set_on_items` — a sibling's
    LOAD can complete before ours.
    """

    def __init__(self, node_id: str, block_store: BlockStore,
                 bind_host: str = "0.0.0.0"):
        self.node_id = node_id
        self.block_store = block_store
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
        sender: str | None = None
        try:
            while True:
                frame = conn.recv()
                if frame.ftype is FrameType.PEER_HELLO:
                    sender = frame.payload.get("node_id")
                elif frame.ftype is FrameType.PEER_ITEMS:
                    items = frame.payload.get("items") or []
                    # No partition check here: the SENDER gates every
                    # transfer on is_partitioned (in ``_link``), so a
                    # frame that reached us was sent before the edge was
                    # cut and must be processed — eating it would strand
                    # the item in the host's exactly-once ledger at a
                    # live target, which no requeue path ever revisits.
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
                elif frame.ftype is FrameType.BLOCK_REQUEST:
                    name = frame.payload.get("name")
                    idx = int(frame.payload.get("chunk", 0))
                    data = None
                    if not is_partitioned(self.node_id, sender):
                        data = self.block_store.get_chunk(name, idx)
                    conn.send(Frame(FrameType.BLOCK_CHUNK,
                                    {"name": name, "chunk": idx, "data": data}))
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


# ---------------------------------------------------------------------------
# Block fetch orchestration (runs on a node-loader thread at LOAD time)
# ---------------------------------------------------------------------------


def fetch_blocks(manifest: Iterable[dict], *, store: BlockStore,
                 client: PeerClient, host_request: Callable[[str, int], None],
                 deadline_s: float = 60.0) -> None:
    """Assemble every manifest block: stripe the host, trade with peers.

    With ``n`` nodes (sorted directory order), node ``i`` pulls chunks
    ``c % n == i`` from the host (async — replies come back through the
    node's frame loop into ``store.add_chunk``) and asks peers for the
    rest, retrying with backoff; any chunk still missing near the deadline
    is re-requested from the host, so a lone node or a partitioned pool
    still converges.
    """
    todo = [dict(m) for m in manifest if store.expect(m)]
    if not todo:
        return
    peers = sorted(n for n in client.directory if n != client.node_id)
    ring = sorted(set(client.directory) | {client.node_id})
    n = max(1, len(ring))
    my_index = ring.index(client.node_id) if client.node_id in ring else 0
    deadline = time.monotonic() + deadline_s
    for meta in todo:
        for c in range(meta["nchunks"]):
            if c % n == my_index:
                host_request(meta["name"], c)
    backoff = 0.02
    while time.monotonic() < deadline:
        remaining = [m for m in todo if store.missing(m["name"])]
        if not remaining:
            return
        progressed = False
        for meta in remaining:
            name = meta["name"]
            for c in store.missing(name):
                if c % n == my_index:
                    continue  # the host reply is in flight
                for k in range(len(peers)):
                    target = peers[(my_index + 1 + k + c) % len(peers)] if peers else None
                    if target is None:
                        break
                    try:
                        data = client.fetch_chunk(target, name, c)
                    except ChannelClosed:
                        continue
                    if data is not None:
                        store.add_chunk(name, c, data, from_peer=True)
                        progressed = True
                        break
        if progressed:
            backoff = 0.02
            continue
        # Peers have nothing new for us yet; near the deadline, stop being
        # polite and pull the stragglers straight from the origin.
        if deadline - time.monotonic() < deadline_s / 2:
            for meta in remaining:
                for c in store.missing(meta["name"]):
                    host_request(meta["name"], c)
            for meta in remaining:
                try:
                    store.wait(meta["name"],
                               max(0.05, deadline - time.monotonic()))
                except TimeoutError:
                    pass
            return
        time.sleep(backoff)
        backoff = min(backoff * 2, 0.25)
