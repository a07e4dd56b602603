"""InProcessLauncher: node-loaders as threads of the host process.

The fastest incarnation — no interpreter fork, no pipe plumbing — while
still exercising the *entire* wire protocol: each thread runs the real
:func:`repro_torch.cluster.node_loader.run_node` against the host's TCP socket,
so REGISTER/LOAD/credits/UT all happen over real frames.  Meant for
launcher-logic and placement-policy tests (respawn, degraded start, late
join) where forking interpreters per scenario would dominate the suite.

Caveats, on purpose: threads share the GIL (no perf isolation) and cannot
be SIGKILLed — :meth:`ThreadNodeHandle.kill` only abandons the thread (its
socket dies with the host), which is exactly the "silent node" shape the
placement policy exists to handle.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Mapping, Sequence

from repro_torch.cluster.deploy.base import Launcher, NodeHandle


class ThreadNodeHandle(NodeHandle):
    """A node-loader running on a daemon thread of this process.

    ``delay`` holds the thread back before it dials — a slow-booting
    workstation in miniature, for exercising the host's silent-node and
    late-join policies without wall-clock-heavy subprocesses.
    """

    def __init__(self, node_id: str, connect_host: str, port: int,
                 connect_timeout: float = 30.0, delay: float = 0.0):
        self.node_id = node_id
        self.where = "thread"
        self.killed = False
        self._exit: int | None = None
        self._log: list[str] = []
        self._conn = None  # the node's FrameConnection, once it dialled

        def target() -> None:
            from repro_torch.cluster.node_loader import run_node

            def on_conn(conn) -> None:
                self._conn = conn

            try:
                if delay > 0.0:
                    time.sleep(delay)
                record = run_node(connect_host, port, node_id=node_id,
                                  connect_timeout=connect_timeout,
                                  on_conn=on_conn)
                self._log.append(f"node-loader done: {record}")
                self._exit = 0
            except BaseException as exc:
                self._log.append(f"node-loader failed: {exc}")
                self._log.extend(traceback.format_exc().splitlines()[-5:])
                self._exit = 1

        self._thread = threading.Thread(target=target,
                                        name=f"inproc-{node_id}", daemon=True)
        self._thread.start()

    def poll(self) -> int | None:
        return self._exit if not self._thread.is_alive() else None

    def wait(self, timeout: float | None = None) -> int | None:
        self._thread.join(timeout=timeout)
        return self.poll()

    def kill(self) -> None:
        # Threads cannot be killed, but a *connected* node can be made dead
        # to the cluster by severing its socket: heartbeats stop, the host
        # reaps it and redispatches its in-flight work — a faithful
        # mid-run crash for the failover tests.  An unconnected
        # handle stays a "silent node" (the placement policy's problem).
        self.killed = True
        conn = self._conn
        if conn is not None:
            conn.close()

    def logs(self) -> list[str]:
        return list(self._log)


class InProcessLauncher(Launcher):
    """Runs node-loaders as threads (real sockets, no subprocess cost).

    ``delays`` maps node ids to seconds of pre-dial sleep (slow boots).
    """

    def __init__(self, *, connect_timeout: float = 30.0,
                 delays: Mapping[str, float] | None = None):
        self.connect_timeout = connect_timeout
        self.delays = dict(delays or {})
        self.connect_host = "127.0.0.1"
        self.port = 0
        self.launched: list[str] = []

    def launch(self, node_id: str, *,
               avoid: Sequence[str] = ()) -> ThreadNodeHandle:
        self.launched.append(node_id)
        return ThreadNodeHandle(node_id, self.connect_host, self.port,
                                connect_timeout=self.connect_timeout,
                                delay=self.delays.get(node_id, 0.0))
