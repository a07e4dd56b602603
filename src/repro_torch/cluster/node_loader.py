"""The Node-Loader (NL): the identical executable every worker machine runs.

Paper §4: the user starts *one* NodeLoader per node — it knows only the
host's load address ("ip:2000/1"); everything else (code, topology, worker
count) arrives over the load network.  Mirroring that:

    python -m repro_torch.cluster.node_loader --host 127.0.0.1 --port <p>

Lifecycle (timed per requirement 7, split three ways):

1. *boot*: connect + REGISTER (node id, cores, pid) on the load channel
   while a background thread pre-imports heavy dependencies named on the
   command line (``--preload repro_torch.quickstart``) — the environment cost of the
   workstation, accounted separately from code distribution.  The dial
   retries with exponential backoff inside ``--connect-timeout``: a
   remotely launched node may come up before the host is listening;
2. *load*: receive LOAD frames — the deployment payload (work functions
   shipped over the code-loading channel).  The first LOAD configures the
   node (worker count, credit window, flush cadence), binds its stage
   function and starts the workers; a LOAD without ``workers`` only
   refreshes the peer directory.  Deserialization is
   deferred until the preloader finishes so shipped-code imports hit a warm
   module cache instead of serializing on the import lock inside the load
   window;
3. *run*: the node-local Figure-2 fragment, pipelined.  The nrfa client
   keeps a *window* of ``workers + prefetch`` items resident: one initial
   WORK_REQUEST carries ``credits=window``, the host answers with
   WORK_BATCH frames, and every RESULT_BATCH the flusher sends piggybacks
   ``credits=len(results)`` — each completed item frees a window slot, so
   demand travels with delivery and workers never idle on a round-trip.
   Results coalesce in small per-job buffers flushed on a threshold or a
   few-ms interval instead of one frame + one syscall per item;
4. on UT: flood workers with UT, join them, return
   (boot_ms, load_ms, run_ms, items) to the host in a final UT frame,
   exit 0.

Work items arrive tagged with the frame-header ``job_id`` (wire v2) and
their stage index ``s``; the worker dispatches through a ``(job_id, s) ->
function`` table.  JOB_CLOSE drops the job's bindings (the host sends it
when the job fails); UT terminates the node itself.

This module must import without torch — a node-loader on a fresh workstation
is a bare bootstrap; the shipped code pulls in its own dependencies when
deserialized (or earlier, via ``--preload``).
"""

from __future__ import annotations

import argparse
import importlib
import os
import queue
import random
import socket
import threading
import time
import traceback
from typing import Any, Callable, Sequence

from repro_torch.cluster import peer as peer_mod
from repro_torch.cluster.netchannels import ChannelClosed
from repro_torch.cluster.wire import (
    APP_WIRE_CHANNEL,
    DEFAULT_HEARTBEAT_S,
    LOAD_WIRE_CHANNEL,
    UT,
    Frame,
    FrameConnection,
    FrameType,
    loads_code,
)

# Minimum spacing of unsolicited REPORT frames: enough for live gauges to
# track batch completion instead of lagging one heartbeat, small enough to
# stay invisible next to the result traffic itself.
REPORT_MIN_INTERVAL_S = 0.05

# Peer-delivered items a node holds locally (queued for workers + parked
# for a late stage binding) before its peer-serve readers stop draining
# their sockets.  Host-dispatched work is bounded by the credit window;
# this is the peer plane's equivalent bound — once full, the reader
# blocks, the kernel buffers fill, and TCP throttles the upstream sender
# instead of this node's queue growing without bound.
PEER_INTAKE_MAX_ITEMS = 256

def connect_with_retry(host: str, port: int, timeout: float = 30.0, *,
                       max_delay: float = 2.0, jitter: float = 0.5,
                       _sleep: Callable[[float], None] = time.sleep,
                       _rng: Any = None) -> socket.socket:
    """Dial the host, retrying with exponential backoff until ``timeout``.

    On a real network the start order is uncontrolled: an ssh-launched
    node-loader routinely comes up before the host binds its load port (or
    while the host is still syncing code to other machines).  Dying on the
    first ECONNREFUSED would turn every such race into a lost workstation;
    instead the node keeps dialling — 0.2s, 0.4s, ... capped at
    ``max_delay`` between attempts — and only gives up once the whole
    window is spent.

    Each pause is scaled by a uniform draw from ``[1 - jitter, 1]`` so a
    mass (re)spawn — every node of a healed or freshly fanned-out pool
    dialling the same listener — decorrelates instead of hammering the
    accept queue in lockstep (the thundering herd).  ``_sleep``/``_rng``
    are test seams.
    """
    deadline = time.monotonic() + timeout
    delay = 0.2
    rng = random if _rng is None else _rng
    while True:
        remaining = deadline - time.monotonic()
        try:
            return socket.create_connection(
                (host, port), timeout=max(0.2, min(5.0, remaining))
            )
        except OSError as exc:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ConnectionError(
                    f"could not reach host-node-loader at {host}:{port} "
                    f"within {timeout}s: {exc}"
                ) from exc
            pause = min(delay, remaining)
            if jitter > 0:
                pause *= rng.uniform(max(0.0, 1.0 - jitter), 1.0)
            _sleep(pause)
            delay = min(delay * 2, max_delay)


def run_node(
    host: str,
    port: int,
    *,
    node_id: str | None = None,
    connect_timeout: float = 30.0,
    preload: Sequence[str] = (),
    on_conn: Callable[[FrameConnection], None] | None = None,
) -> dict[str, Any]:
    """Run one Node-Loader to completion; returns its timing record.

    ``on_conn`` (test hook) is called with the live :class:`FrameConnection`
    right after the dial succeeds, so an in-process harness can sever the
    socket to simulate this node dying mid-run.
    """
    node_id = node_id or f"{socket.gethostname()}-{os.getpid()}"
    t_boot0 = time.perf_counter()

    # Heavy dependencies import concurrently with registration: the cost of
    # booting the environment lands in boot_ms, not in the code-distribution
    # (load) window the paper accounts in §8.2.
    def preloader() -> None:
        for name in preload:
            try:
                importlib.import_module(name)
            except Exception:  # the shipped code will surface a real error
                pass

    preload_thread = threading.Thread(target=preloader, name="nl-preload",
                                      daemon=True)
    preload_thread.start()

    sock = connect_with_retry(host, port, timeout=connect_timeout)
    sock.settimeout(None)
    conn = FrameConnection(sock)
    if on_conn is not None:
        on_conn(conn)

    # The peer data plane: a listening socket siblings dial directly (stage
    # forwarding).  Opened before REGISTER so the host can put this node in
    # peer directories immediately; items arriving before the worker pool
    # exists are held inside the server and drained once the handler is
    # installed below.
    peer_dir: dict[str, tuple] = {}
    peer_client = peer_mod.PeerClient(node_id, peer_dir)
    peer_server = peer_mod.PeerServer(node_id)
    peer_server.start()

    conn.send(Frame(
        FrameType.REGISTER,
        {"node_id": node_id, "cores": os.cpu_count() or 1,
         "pid": os.getpid(), "peer_port": peer_server.port},
        LOAD_WIRE_CHANNEL,
    ))

    # The beacon starts right after REGISTER: the boot/load phases may take
    # seconds (torch import), and the host must not mistake them for death.
    # The interval is refined once the plan says what the host expects.
    stop_beat = threading.Event()
    beat_interval = [DEFAULT_HEARTBEAT_S]

    # Node-side telemetry, piggybacked on every beat — the only node->host
    # reporting channel that exists before UT.  Mutated in place by the
    # load/worker paths (single-value updates; a torn read costs nothing).
    report = {"boot_ms": 0.0, "load_ms": 0.0, "items": 0}

    def snapshot_report() -> dict:
        rep = dict(report)
        rep.update(peer_server.counters())
        rep["peer_items_sent"] = peer_client.items_sent
        rep["peer_bytes_sent"] = peer_client.bytes_sent
        return rep

    def heartbeat() -> None:
        while not stop_beat.wait(beat_interval[0]):
            try:
                conn.send(Frame(
                    FrameType.HEARTBEAT,
                    {"node_id": node_id, "report": snapshot_report()},
                    LOAD_WIRE_CHANNEL,
                ))
            except OSError:
                return

    beat_thread = threading.Thread(target=heartbeat, name="nl-heartbeat",
                                   daemon=True)
    beat_thread.start()

    # LOAD decoding (and the shipped code's imports with it) must not
    # contend with the preloader inside the load window; inbound frames
    # simply wait in the kernel socket buffer until it joins.
    preload_thread.join()
    boot_ms = (time.perf_counter() - t_boot0) * 1e3
    report["boot_ms"] = round(boot_ms, 3)
    load_ms = 0.0
    items_done = 0
    run_ms = 0.0

    def early_record() -> dict[str, Any]:
        # Host aborted (UT) or vanished during bootstrap: nothing ran.
        stop_beat.set()
        peer_server.close()
        peer_client.close()
        conn.close()
        return {"node_id": node_id, "boot_ms": round(boot_ms, 3),
                "load_ms": 0.0, "run_ms": 0.0, "items": 0}

    # -- job state ----------------------------------------------------------
    # fns: the worker dispatch table.
    fns: dict[tuple[int, int], Callable[[Any], Any]] = {}
    configured = False
    workers = 1
    slowdown = 0.0
    window = 2
    flush_items = 8
    flush_interval = 0.005

    work_q: queue.Queue = queue.Queue()
    items_lock = threading.Lock()
    out_lock = threading.Lock()
    out_bufs: dict[int, list[dict]] = {}  # job_id -> pending results
    flush_now = threading.Event()
    stop_flush = threading.Event()

    # Peer routing state: per-job routing tables from LOAD, plus a holding
    # pen for peer-delivered items whose stage binding has not arrived yet
    # (a sibling's LOAD can complete before ours).
    route_tables: dict[int, peer_mod.RouteTable] = {}
    hold_lock = threading.Lock()
    peer_hold: dict[int, list[dict]] = {}
    last_report = [0.0]
    # Peer intake accounting: items admitted from the peer plane that the
    # workers have not consumed yet.  The gate below blocks the peer-serve
    # reader threads at PEER_INTAKE_MAX_ITEMS (TCP backpressure on the
    # sender); self-delivery and the pre-handler held drain never block,
    # so the flusher and the main frame loop cannot deadlock on it.
    intake_cv = threading.Condition()
    peer_backlog = [0]

    def peer_intake_gate(n: int) -> None:
        with intake_cv:
            while (peer_backlog[0] >= PEER_INTAKE_MAX_ITEMS
                   and not stop_flush.is_set()):
                intake_cv.wait(0.05)

    def peer_intake_release(n: int) -> None:
        with intake_cv:
            peer_backlog[0] -= n
            intake_cv.notify_all()

    def send_report(force: bool = False) -> None:
        # The dedicated REPORT frame: pushed right after result activity so
        # host-side gauges track completions instead of lagging one beat.
        now = time.monotonic()
        if not force and now - last_report[0] < REPORT_MIN_INTERVAL_S:
            return
        last_report[0] = now
        try:
            conn.send(Frame(
                FrameType.REPORT,
                {"node_id": node_id, "report": snapshot_report()},
                LOAD_WIRE_CHANNEL,
            ))
        except OSError:
            pass

    def on_peer_items(job_id: int, items: list) -> None:
        with intake_cv:
            peer_backlog[0] += len(items)
        with hold_lock:
            for item in items:
                s = int(item.get("s", 0))
                if (job_id, s) in fns:
                    work_q.put((job_id, item))
                else:
                    peer_hold.setdefault(job_id, []).append(item)

    peer_server.set_on_items(on_peer_items)
    peer_server.set_intake_gate(peer_intake_gate)

    def complete(job_id: int, result: dict, urgent: bool = False) -> None:
        with out_lock:
            out_bufs.setdefault(job_id, []).append(result)
            n = sum(len(b) for b in out_bufs.values())
        if urgent or n >= flush_items:
            flush_now.set()

    def peer_deliver(jid: int, target: str, items: list[dict]) -> bool:
        if target == node_id:
            # Our own node is a valid next-stage target: skip the wire.
            on_peer_items(jid, items)
            peer_client.items_sent += len(items)
            return True
        try:
            peer_client.send_items(jid, target, items)
            return True
        except ChannelClosed:
            return False

    def flush() -> None:
        with out_lock:
            batches = [(jid, buf) for jid, buf in out_bufs.items() if buf]
            out_bufs.clear()
        sent_any = False
        for jid, batch in batches:
            rt = route_tables.get(jid)
            host_results = batch
            if rt is not None:
                host_results = []
                acks: list[dict] = []
                ack_credits = 0
                # Group by each item's first-preference target so one frame
                # carries a whole flush worth of same-destination items.
                groups: dict[str, list[tuple[dict, list[str]]]] = {}
                for r in batch:
                    s = int(r.get("s", 0))
                    targets = (rt.targets_for(s, r["value"])
                               if "value" in r and rt.has(s) else [])
                    if not targets:
                        host_results.append(r)
                        continue
                    groups.setdefault(targets[0], []).append((r, targets))

                def fwd(r: dict) -> dict:
                    return {"id": r["id"], "s": int(r["s"]) + 1,
                            "obj": r["value"], "peer": True}

                for primary, entries in groups.items():
                    shipped: list[tuple[dict, str]] = []
                    if peer_deliver(jid, primary,
                                    [fwd(r) for r, _ in entries]):
                        shipped = [(r, primary) for r, _ in entries]
                    else:
                        # Primary unreachable: walk each item's fallback
                        # list; anything with no live peer goes to the host
                        # as an ordinary relayed result (correct, degraded).
                        for r, targets in entries:
                            for t in targets[1:]:
                                if peer_deliver(jid, t, [fwd(r)]):
                                    shipped.append((r, t))
                                    break
                            else:
                                host_results.append(r)
                    for r, t in shipped:
                        acks.append({"id": r["id"], "s": int(r["s"]),
                                     "to": t})
                        # Window credits return only for host-dispatched
                        # inputs; peer-delivered ones never consumed a
                        # credit, so crediting them would grow the window.
                        if not r.get("peer"):
                            ack_credits += 1
                if acks:
                    try:
                        conn.send(Frame(
                            FrameType.ITEM_ACK,
                            {"node_id": node_id, "acks": acks,
                             "credits": ack_credits},
                            APP_WIRE_CHANNEL, job_id=jid,
                        ))
                    except OSError:
                        pass
                    sent_any = True
            if not host_results:
                continue
            payload = {"node_id": node_id, "results": host_results,
                       # Each finished item frees one window slot: demand
                       # piggybacks on delivery (no separate request frame).
                       # Peer-delivered inputs carry no credit (see above).
                       "credits": sum(1 for r in host_results
                                      if not r.get("peer"))}
            try:
                conn.send(Frame(FrameType.RESULT_BATCH, payload,
                                APP_WIRE_CHANNEL, job_id=jid))
                sent_any = True
            except OSError:
                pass  # host gone: the nrfa loop shuts the node down
            except Exception as exc:
                # A result refused to serialize: report instead of stalling
                # the job with a silently dead flusher (the host fails fast).
                try:
                    conn.send(Frame(
                        FrameType.RESULT_BATCH,
                        {"node_id": node_id, "credits": payload["credits"],
                         "results": [{
                             "id": host_results[0]["id"],
                             "s": host_results[0].get("s", 0),
                             "error": f"{type(exc).__name__}: {exc}",
                             "traceback": traceback.format_exc(),
                         }]},
                        APP_WIRE_CHANNEL, job_id=jid,
                    ))
                    sent_any = True
                except OSError:
                    pass
        if sent_any:
            send_report()

    def flusher() -> None:
        while not stop_flush.is_set():
            flush_now.wait(flush_interval)
            flush_now.clear()
            flush()
        flush()  # drain the tail after the workers joined

    def worker() -> None:
        nonlocal items_done
        while True:
            got = work_q.get()
            if got is UT:
                return
            job_id, item = got
            s = int(item.get("s", 0))
            # Results remember whether their input arrived from a peer: the
            # flusher returns window credits only for host-dispatched items.
            tag = {"peer": True} if item.get("peer") else {}
            if tag:
                peer_intake_release(1)  # consumed: reopen the intake gate
            fn = fns.get((job_id, s))
            if fn is None:
                # JOB_CLOSE raced ahead of in-flight items: the job is
                # already finished/failed host-side, so the result is moot —
                # but the credit is not (a dropped item would shrink the
                # window forever).  Report an error result; the host ignores
                # results of closed jobs and banks the piggybacked credit.
                complete(job_id, {"id": item["id"], "s": s,
                                  "error": "stage binding dropped "
                                           "(job closed)", **tag},
                         urgent=True)
                continue
            try:
                value = fn(item["obj"])
                if slowdown > 0.0:
                    time.sleep(slowdown)  # injected straggler (§6.1 testing)
                complete(job_id, {"id": item["id"], "s": s, "value": value,
                                  **tag})
            except BaseException as exc:
                # Report instead of dying silently: a dead worker thread
                # would stall the node (heartbeats keep flowing, so the
                # host would never re-dispatch).  The host fails the job.
                complete(job_id,
                         {"id": item["id"], "s": s,
                          "error": f"{type(exc).__name__}: {exc}",
                          "traceback": traceback.format_exc(), **tag},
                         urgent=True)
                continue
            with items_lock:
                items_done += 1
                report["items"] = items_done

    worker_threads: list[threading.Thread] = []
    flush_thread = threading.Thread(target=flusher, name="nl-flusher",
                                    daemon=True)
    t_run0 = time.perf_counter()

    def bind_stages(job_id: int, plan: dict) -> None:
        bound = False
        for entry in plan.get("stages", ()):
            fns[(job_id, int(entry["s"]))] = loads_code(entry["function"])
            bound = True
        if bound:
            # Drain peer-delivered items that raced ahead of this binding.
            with hold_lock:
                held = peer_hold.pop(job_id, [])
                for item in held:
                    if (job_id, int(item.get("s", 0))) in fns:
                        work_q.put((job_id, item))
                    else:
                        peer_hold.setdefault(job_id, []).append(item)

    def apply_load(job_id: int, plan: dict) -> None:
        nonlocal configured, workers, slowdown, window
        nonlocal flush_items, flush_interval, t_run0
        pd = plan.get("peer")
        if pd:
            for nid, addr in (pd.get("dir") or {}).items():
                peer_dir[nid] = (addr[0], int(addr[1]))
            routes = pd.get("routes")
            if routes:
                route_tables[job_id] = peer_mod.RouteTable(routes)
        if "workers" not in plan:
            return  # a directory refresh, not a deployment
        if not configured:
            configured = True
            workers = int(plan["workers"])
            slowdown = float(plan.get("slowdown", 0.0))
            beat_interval[0] = float(
                plan.get("heartbeat_interval", DEFAULT_HEARTBEAT_S)
            )
            prefetch = plan.get("prefetch")
            # None = one extra per worker; 0 is honoured (strict
            # one-item-per-worker window, the pure demand-driven
            # pre-pipelining behaviour).
            prefetch = workers if prefetch is None else max(0, int(prefetch))
            window = workers + prefetch
            flush_items = max(1, int(plan.get("flush_items", 8)))
            flush_interval = float(plan.get("flush_interval", 0.005))
            bind_stages(job_id, plan)
            for i in range(workers):
                t = threading.Thread(target=worker, name=f"nl-worker{i}",
                                     daemon=True)
                t.start()
                worker_threads.append(t)
            flush_thread.start()
            t_run0 = time.perf_counter()
            # The windowed nrfa client: one up-front demand for the whole
            # window, then WORK_BATCH frames fill it and RESULT_BATCH
            # credits (sent by the flusher) keep it full.  Sent *after* the
            # stages bound above, so work can never outrun code.
            conn.send(Frame(
                FrameType.WORK_REQUEST,
                {"node_id": node_id, "credits": window},
                APP_WIRE_CHANNEL,
            ))
        else:
            bind_stages(job_id, plan)

    # First frame: the host answers REGISTER with LOAD (or UT on abort).
    # Bound the wait — a host that never loads us is indistinguishable from
    # a wedged bootstrap, and the paper's NL is supposed to fail loudly.
    sock.settimeout(connect_timeout)
    try:
        first = conn.recv()
    except socket.timeout:
        stop_beat.set()
        conn.close()
        raise ConnectionError(
            f"no LOAD received from the host within {connect_timeout}s "
            "(are all expected node-loaders up?)"
        ) from None
    except (ConnectionError, OSError, ValueError):
        return early_record()
    sock.settimeout(None)

    terminated_by_host = False
    frame: Frame | None = first
    try:
        while True:
            if frame is None:
                frame = conn.recv()
            if frame.ftype is FrameType.UT:
                if not configured:
                    return early_record()
                terminated_by_host = True
                break
            if frame.ftype is FrameType.LOAD:
                t0 = time.perf_counter()
                apply_load(frame.job_id, frame.payload)
                load_ms += (time.perf_counter() - t0) * 1e3
                report["load_ms"] = round(load_ms, 3)
            elif frame.ftype is FrameType.WORK_BATCH:
                for item in frame.payload["items"]:
                    work_q.put((frame.job_id, item))
            elif frame.ftype is FrameType.WORK:  # legacy single form
                work_q.put((frame.job_id, frame.payload))
            elif frame.ftype is FrameType.JOB_CLOSE:
                # The job failed host-side: drop its dispatch bindings.
                jid = frame.job_id
                for key in [k for k in fns if k[0] == jid]:
                    del fns[key]
                route_tables.pop(jid, None)
                with hold_lock:
                    dropped = peer_hold.pop(jid, None)
                if dropped:
                    # Parked items die with their job; their intake slots
                    # must reopen or the gate leaks capacity.
                    peer_intake_release(len(dropped))
            frame = None
    except (ConnectionError, OSError, ValueError):
        # Host vanished (mid-recv): there is nobody to deliver to; shut
        # down quietly.
        if not configured:
            return early_record()

    for _ in range(workers):
        work_q.put(UT)
    for t in worker_threads:
        t.join()
    stop_flush.set()
    flush_now.set()
    flush_thread.join()
    run_ms = (time.perf_counter() - t_run0) * 1e3
    stop_beat.set()
    peer_server.close()
    peer_client.close()

    record = {
        "node_id": node_id,
        "boot_ms": round(boot_ms, 3),
        "load_ms": round(load_ms, 3),
        "run_ms": round(run_ms, 3),
        "items": items_done,
    }
    if terminated_by_host:
        try:
            conn.send(Frame(FrameType.UT, record, LOAD_WIRE_CHANNEL))
        except OSError:
            pass
    conn.close()
    return record


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="ClusterBuilder Node-Loader (paper §4)"
    )
    parser.add_argument("--host", required=True,
                        help="Host-Node-Loader address")
    parser.add_argument("--port", type=int, required=True,
                        help="load network port (the paper's 2000)")
    parser.add_argument("--node-id", default=None)
    parser.add_argument(
        "--connect-timeout", type=float, default=30.0,
        help="seconds to keep retrying the initial host dial (with "
             "exponential backoff) before giving up",
    )
    parser.add_argument(
        "--preload", default="",
        help="comma-separated modules to import during boot, overlapping "
             "registration (e.g. 'repro_torch.quickstart')",
    )
    args = parser.parse_args(argv)
    preload = tuple(m for m in args.preload.split(",") if m)
    try:
        record = run_node(
            args.host, args.port,
            node_id=args.node_id,
            connect_timeout=args.connect_timeout,
            preload=preload,
        )
    except (ConnectionError, socket.timeout, OSError) as exc:
        print(
            f"node-loader: cannot reach host-node-loader at "
            f"{args.host}:{args.port}: {exc}",
            flush=True,
        )
        return 1
    print(f"node-loader done: {record}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
