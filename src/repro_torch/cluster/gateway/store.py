"""The durable ticket store: one SQLite table, one row per submission.

hyper-shell's client/cluster apps model the pattern this module follows: a
job submitted to a shared pool is a *database row first* — the client can
disconnect, the gateway can crash, and the row (spec blob, tenant, policy,
lifecycle state, eventually the result) is still there when either comes
back.  ``repro_torch.cluster.gateway.JobGateway`` keeps its whole queue in here;
the in-memory scheduler is a cache of the ``queued`` rows, rebuilt on
restart.

Ticket lifecycle::

    queued -(admitted)-> running -(job done)---> done
       |                    |  \\-(job error)--> failed
       |                    \\-(gateway crash)-> queued   [recover()]
       \\-(cancel / queued-timeout)-----------> cancelled

Stdlib only (``sqlite3``); specs and results are pickled with the same
:func:`repro_torch.cluster.wire.dumps_code` codec the LOAD path ships stage
functions with (cloudpickle where it is installed, else plain pickle), so
anything submittable is persistable.  One connection,
serialized by a lock (the gateway pump, enqueuing clients, and attached
handles all read/write concurrently); every write commits — durability is
the point.
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from dataclasses import dataclass
from typing import Any

from repro_torch.cluster.wire import dumps_code, loads_code

__all__ = ["TicketRow", "TicketStore", "QUEUED", "RUNNING", "DONE",
           "FAILED", "CANCELLED"]

QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"
CANCELLED = "cancelled"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS tickets (
    ticket       TEXT PRIMARY KEY,
    tenant       TEXT NOT NULL,
    priority     INTEGER NOT NULL DEFAULT 0,
    retries      INTEGER NOT NULL DEFAULT 0,
    timeout      REAL,
    state        TEXT NOT NULL,
    spec         BLOB NOT NULL,
    submitted_at REAL NOT NULL,
    started_at   REAL,
    finished_at  REAL,
    result       BLOB,
    error        TEXT,
    summary      TEXT
);
CREATE INDEX IF NOT EXISTS tickets_state ON tickets (state);
"""


@dataclass
class TicketRow:
    ticket: str
    tenant: str
    priority: int
    retries: int
    timeout: float | None
    state: str
    spec: bytes
    submitted_at: float
    started_at: float | None = None
    finished_at: float | None = None
    result: bytes | None = None
    error: str | None = None
    summary: dict[str, Any] | None = None

    def load_spec(self) -> Any:
        return loads_code(self.spec)

    def load_result(self) -> Any:
        return None if self.result is None else loads_code(self.result)


def _row(raw: sqlite3.Row) -> TicketRow:
    summary = raw["summary"]
    return TicketRow(
        ticket=raw["ticket"], tenant=raw["tenant"],
        priority=int(raw["priority"]), retries=int(raw["retries"]),
        timeout=raw["timeout"], state=raw["state"], spec=raw["spec"],
        submitted_at=float(raw["submitted_at"]),
        started_at=raw["started_at"], finished_at=raw["finished_at"],
        result=raw["result"], error=raw["error"],
        summary=json.loads(summary) if summary else None,
    )


class TicketStore:
    """The gateway's SQLite task table (see module docstring).

    ``path`` may be a filesystem path (durable) or ``":memory:"`` (tests
    of the scheduling machinery that don't exercise restart).
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        with self._lock:
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    # -- writes --------------------------------------------------------------

    def add(self, ticket: str, spec: Any, *, tenant: str, priority: int,
            retries: int, timeout: float | None,
            now: float | None = None) -> TicketRow:
        now = time.time() if now is None else now
        blob = dumps_code(spec)
        with self._lock:
            self._conn.execute(
                "INSERT INTO tickets (ticket, tenant, priority, retries,"
                " timeout, state, spec, submitted_at)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?)",
                (ticket, tenant, priority, retries, timeout, QUEUED,
                 blob, now),
            )
            self._conn.commit()
        return TicketRow(ticket=ticket, tenant=tenant, priority=priority,
                         retries=retries, timeout=timeout, state=QUEUED,
                         spec=blob, submitted_at=now)

    def mark_running(self, ticket: str, now: float | None = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            self._conn.execute(
                "UPDATE tickets SET state = ?, started_at = ?"
                " WHERE ticket = ?", (RUNNING, now, ticket))
            self._conn.commit()

    def finish(self, ticket: str, *, result: Any = None,
               error: str | None = None,
               summary: dict[str, Any] | None = None,
               now: float | None = None) -> None:
        """Terminal transition: ``done`` with a pickled result, or
        ``failed`` with the error string.  The summary (boot/latency
        figures from the live JobHandle) is persisted so a handle attached
        *after* the gateway restarts can still report them."""
        now = time.time() if now is None else now
        state = FAILED if error is not None else DONE
        blob = None if error is not None else dumps_code(result)
        with self._lock:
            self._conn.execute(
                "UPDATE tickets SET state = ?, finished_at = ?, result = ?,"
                " error = ?, summary = ? WHERE ticket = ?",
                (state, now, blob, error,
                 json.dumps(summary) if summary else None, ticket))
            self._conn.commit()

    def cancel(self, ticket: str, reason: str,
               now: float | None = None) -> bool:
        """Cancel a still-queued ticket (running/terminal rows refuse)."""
        now = time.time() if now is None else now
        with self._lock:
            cur = self._conn.execute(
                "UPDATE tickets SET state = ?, finished_at = ?, error = ?"
                " WHERE ticket = ? AND state = ?",
                (CANCELLED, now, reason, ticket, QUEUED))
            self._conn.commit()
        return cur.rowcount > 0

    def recover(self) -> list[TicketRow]:
        """Crash recovery, called once by a fresh gateway over an existing
        database: rows stuck ``running`` lost their pool job with the old
        gateway process, so they go back to ``queued`` (the attempt is
        charged nowhere — the ticket's own ``retries`` budget rides the
        resubmission); returns every queued row, oldest first."""
        with self._lock:
            self._conn.execute(
                "UPDATE tickets SET state = ?, started_at = NULL"
                " WHERE state = ?", (QUEUED, RUNNING))
            self._conn.commit()
            rows = self._conn.execute(
                "SELECT * FROM tickets WHERE state = ?"
                " ORDER BY submitted_at", (QUEUED,)).fetchall()
        return [_row(r) for r in rows]

    # -- reads ---------------------------------------------------------------

    def get(self, ticket: str) -> TicketRow | None:
        with self._lock:
            raw = self._conn.execute(
                "SELECT * FROM tickets WHERE ticket = ?",
                (ticket,)).fetchone()
        return None if raw is None else _row(raw)

    def counts(self) -> dict[str, int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT state, COUNT(*) AS n FROM tickets"
                " GROUP BY state").fetchall()
        return {r["state"]: int(r["n"]) for r in rows}

    def close(self) -> None:
        with self._lock:
            self._conn.close()
