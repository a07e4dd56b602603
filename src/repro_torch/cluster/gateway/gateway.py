"""JobGateway: the durable, multi-tenant front door of a warm pool.

``ClusterService.submit`` is a live-process API: the JobHandle is the only
record a job exists, so the client must stay connected and the scheduling
is strict priority+FIFO.  The gateway puts three things in front of it
(see ARCHITECTURE.md "Job gateway & fair scheduling"):

* **durability** — ``enqueue()`` writes the spec to a SQLite task table
  (:mod:`.store`) and returns a ticket id; the client may disconnect, the
  gateway may restart over the same database, and ``attach(ticket)`` still
  resolves to the result (rows caught mid-run by a crash are requeued);
* **weighted-fair admission** — queued tickets enter the pool via
  deficit-round-robin over tenants with aging (:mod:`.scheduler`); submit
  priority only orders tickets *within* a tenant, and each tenant's
  ``max_inflight`` credit cap rides the submission into
  ``host_loader._answer`` so a wide job cannot monopolise node credits;
* **autoscaling** — pass ``autoscale=AutoscalePolicy(...)`` and a control
  loop (:mod:`.autoscale`) grows/shrinks the pool with queue depth.

The pump — one daemon thread — is the only writer of scheduler state: it
reaps finished pool jobs into the store, drops queued tickets whose
submit timeout expired (they report ``cancelled``, never holding a slot
forever), and admits the next DRR pick whenever an admission slot frees.
"""

from __future__ import annotations

import threading
import time
import traceback
import uuid
from typing import Any

from repro_torch.cluster.gateway.autoscale import AutoscalePolicy, Autoscaler
from repro_torch.cluster.gateway.scheduler import (
    FairScheduler,
    QueueEntry,
    TenantPolicy,
)
from repro_torch.cluster.gateway.store import (
    CANCELLED,
    DONE,
    FAILED,
    TicketStore,
)

__all__ = ["JobGateway", "TicketHandle", "JobCancelled"]

TERMINAL_STATES = (DONE, FAILED, CANCELLED)


class JobCancelled(RuntimeError):
    """Raised by ``TicketHandle.result()`` for a cancelled ticket (explicit
    ``cancel()`` or a submit timeout that expired while still queued)."""


class _Active:
    """One admitted ticket: its live pool-job handle plus identity."""

    __slots__ = ("ticket", "tenant", "handle")

    def __init__(self, ticket: str, tenant: str, handle: Any):
        self.ticket = ticket
        self.tenant = tenant
        self.handle = handle


class TicketHandle:
    """A ticket's future, valid across gateway restarts.

    Unlike a ``JobHandle`` this is just a view over the task table (plus
    the live pool handle while the job runs), so any process that can open
    the gateway's database can wait on any ticket.
    """

    def __init__(self, gateway: "JobGateway", ticket: str):
        self._gateway = gateway
        self.ticket = ticket

    def status(self) -> str:
        """``queued`` | ``running`` | ``done`` | ``failed`` | ``cancelled``."""
        row = self._gateway._row(self.ticket)
        return row.state

    def done(self) -> bool:
        return self.status() in TERMINAL_STATES

    def wait(self, timeout: float | None = None) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # The live handle's event is the fast path; the store poll
            # covers queued tickets and post-restart attachment.
            active = self._gateway._active_of(self.ticket)
            if active is not None:
                step = 0.25 if deadline is None else min(
                    0.25, max(0.0, deadline - time.monotonic()))
                active.handle.wait(step)
            if self.status() in TERMINAL_STATES:
                return True
            if deadline is not None and time.monotonic() >= deadline:
                return False
            if active is None:
                time.sleep(self._gateway.poll_interval)

    def result(self, timeout: float | None = None) -> Any:
        if not self.wait(timeout):
            raise TimeoutError(
                f"ticket {self.ticket} not finished within {timeout}s")
        row = self._gateway._row(self.ticket)
        if row.state == CANCELLED:
            raise JobCancelled(row.error or f"ticket {self.ticket} cancelled")
        if row.state == FAILED:
            raise RuntimeError(row.error or f"ticket {self.ticket} failed")
        return row.load_result()

    def stats(self) -> dict[str, Any]:
        """Ticket metadata merged with the job's figures: live from the
        pool handle while running, from the persisted summary after —
        ``cluster_boot_ms`` survives reattachment either way."""
        row = self._gateway._row(self.ticket)
        out: dict[str, Any] = {
            "ticket": row.ticket,
            "tenant": row.tenant,
            "state": row.state,
            "priority": row.priority,
            "submitted_at": row.submitted_at,
            "started_at": row.started_at,
            "finished_at": row.finished_at,
        }
        active = self._gateway._active_of(self.ticket)
        if active is not None:
            out.update(active.handle.stats())
        elif row.summary:
            out.update(row.summary)
        return out


class JobGateway:
    """The durable multi-tenant submit queue over one ``ClusterService``.

    ``tenants`` maps tenant name -> :class:`TenantPolicy` (weights, caps);
    unknown tenants get ``default_policy``.  ``mode="fifo"`` disables the
    DRR machinery (strict priority+FIFO admission, no credit caps) — the
    measured baseline, not a recommended configuration.

    ``max_active_jobs`` bounds concurrently admitted pool jobs overall —
    the admission slots DRR arbitrates.  The gateway never owns the
    service: ``close()`` stops metering but leaves the pool warm.
    """

    def __init__(
        self,
        service,
        db_path: str,
        *,
        tenants: dict[str, TenantPolicy] | None = None,
        default_policy: TenantPolicy | None = None,
        mode: str = "fair",
        max_active_jobs: int = 8,
        aging_s: float = 30.0,
        autoscale: AutoscalePolicy | None = None,
        poll_interval: float = 0.05,
    ):
        if max_active_jobs < 1:
            raise ValueError("max_active_jobs must be >= 1")
        self.service = service
        self.telemetry = service.telemetry
        self.mode = mode
        self.max_active_jobs = max_active_jobs
        self.poll_interval = poll_interval
        self.store = TicketStore(db_path)
        self.scheduler = FairScheduler(tenants, default=default_policy,
                                       mode=mode, aging_s=aging_s)
        self._lock = threading.Lock()
        self._active: dict[str, _Active] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        # Crash recovery: rows left ``running`` by a dead gateway lost
        # their pool job with it — requeue them with the queued rows.
        for row in self.store.recover():
            self.scheduler.push(QueueEntry(
                ticket=row.ticket, tenant=row.tenant, priority=row.priority,
                submitted_at=row.submitted_at, timeout=row.timeout,
                retries=row.retries, spec=None,  # lazily unpickled on admit
            ))
        self.telemetry.set_sampler("gateway", self._sample)
        self._pump = threading.Thread(target=self._pump_loop,
                                      name="gateway-pump", daemon=True)
        self._pump.start()
        self.autoscaler: Autoscaler | None = None
        if autoscale is not None:
            self.autoscaler = Autoscaler(self, autoscale)
            self.autoscaler.start()

    # -- client API ----------------------------------------------------------

    def enqueue(self, spec, *, tenant: str = "default", priority: int = 0,
                retries: int = 0, timeout: float | None = None) -> str:
        """Persist one submission; returns its ticket id immediately.

        The ticket survives client disconnect and gateway restart;
        ``timeout`` is end-to-end from enqueue (a ticket still queued at
        its deadline is cancelled, one admitted gets the remainder as its
        job timeout).
        """
        if self._stop.is_set():
            raise RuntimeError("gateway is closed")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        ticket = f"t{uuid.uuid4().hex[:12]}"
        row = self.store.add(ticket, spec, tenant=tenant, priority=priority,
                             retries=retries, timeout=timeout)
        with self._lock:
            self.scheduler.push(QueueEntry(
                ticket=ticket, tenant=tenant, priority=priority,
                submitted_at=row.submitted_at, timeout=timeout,
                retries=retries, spec=spec,
            ))
        self.telemetry.inc("tickets_enqueued")
        self.telemetry.emit("ticket_enqueued", ticket=ticket, tenant=tenant,
                            priority=priority)
        self._wake.set()
        return ticket

    def attach(self, ticket: str) -> TicketHandle:
        """Reconnect to a ticket (this gateway's or any prior one's over
        the same database)."""
        self._row(ticket)  # raise early on unknown ids
        return TicketHandle(self, ticket)

    def cancel(self, ticket: str) -> bool:
        """Remove a still-queued ticket.  True when it was cancelled;
        False when it already started (or finished) — running work is
        never preempted here."""
        with self._lock:
            entry = self.scheduler.remove(ticket)
        if entry is None:
            return False
        self.store.cancel(ticket, "cancelled by client")
        self.telemetry.inc("tickets_cancelled")
        self.telemetry.emit("ticket_cancelled", ticket=ticket,
                            tenant=entry.tenant, reason="client")
        return True

    # -- introspection (autoscaler + telemetry) ------------------------------

    def queued_count(self) -> int:
        with self._lock:
            return self.scheduler.depth()

    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def oldest_queued_wait(self) -> float:
        with self._lock:
            return self.scheduler.oldest_wait()

    def _row(self, ticket: str):
        row = self.store.get(ticket)
        if row is None:
            raise KeyError(f"unknown ticket {ticket!r}")
        return row

    def _active_of(self, ticket: str) -> _Active | None:
        with self._lock:
            return self._active.get(ticket)

    def _sample(self) -> dict:
        with self._lock:
            depth = self.scheduler.depth_by_tenant()
            active = list(self._active.values())
            oldest = self.scheduler.oldest_wait()
        by_tenant: dict[str, dict] = {}
        for t, n in depth.items():
            by_tenant.setdefault(t, {"queued": 0, "active": 0})["queued"] = n
        for a in active:
            by_tenant.setdefault(a.tenant,
                                 {"queued": 0, "active": 0})["active"] += 1
        for t, fields in by_tenant.items():
            pol = self.scheduler.policy(t)
            fields["weight"] = pol.weight
            if pol.max_inflight is not None:
                fields["max_inflight"] = pol.max_inflight
        return {
            "mode": self.mode,
            "queued": sum(depth.values()),
            "active": len(active),
            "oldest_wait_s": round(oldest, 6),
            "tickets": self.store.counts(),
            "tenants": by_tenant,
        }

    # -- the pump ------------------------------------------------------------

    def _pump_loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.poll_interval)
            self._wake.clear()
            try:
                self._reap()
                self._expire()
                self._admit()
            except Exception:
                if self._stop.is_set():
                    return  # store/service closed under the pump: done
                # A dead pump strands every tenant — nothing is ever
                # reaped, expired or admitted again and waiters block
                # forever — so surface the error on the bus and keep
                # pumping.
                self.telemetry.inc("gateway_pump_errors")
                self.telemetry.emit("gateway_pump_error",
                                    error=traceback.format_exc(limit=8))

    def _reap(self) -> None:
        with self._lock:
            # Claim atomically: close(wait=True) reaps on the caller
            # thread while the pump runs its own _reap, and each finished
            # ticket must be recorded (store row, counters, bus event)
            # exactly once — whoever pops the ticket processes it.
            finished = [self._active.pop(a.ticket)
                        for a in list(self._active.values())
                        if a.handle.done()]
        for a in finished:
            try:
                self._record_finished(a)
            except Exception as exc:
                # An unpicklable result (or a store hiccup) must not
                # strand the row as ``running`` or kill the pump: record
                # the ticket failed instead.
                self.store.finish(a.ticket,
                                  error=f"{type(exc).__name__}: {exc}")
                self.telemetry.inc("tickets_failed")
                self.telemetry.emit("ticket_failed", ticket=a.ticket,
                                    tenant=a.tenant, error=str(exc))

    def _record_finished(self, a: _Active) -> None:
        handle = a.handle
        stats = handle.stats()
        summary = {
            "items_collected": stats.get("items_collected"),
            "cluster_boot_ms": stats.get("cluster_boot_ms"),
            "submit_to_first_result_ms":
                stats.get("submit_to_first_result_ms"),
            "code_shipped": stats.get("code_shipped"),
            "retries": stats.get("retries"),
        }
        if handle.error is None:
            self.store.finish(a.ticket, result=handle._job.result,
                              summary=summary)
            self.telemetry.inc("tickets_done")
            self.telemetry.emit("ticket_done", ticket=a.ticket,
                                tenant=a.tenant,
                                items=stats.get("items_collected"))
        else:
            self.store.finish(a.ticket, error=str(handle.error),
                              summary=summary)
            self.telemetry.inc("tickets_failed")
            self.telemetry.emit("ticket_failed", ticket=a.ticket,
                                tenant=a.tenant,
                                error=str(handle.error))

    def _expire(self) -> None:
        with self._lock:
            expired = self.scheduler.drop_expired()
        for entry in expired:
            self.store.cancel(
                entry.ticket,
                f"timed out after {entry.timeout}s while still queued")
            self.telemetry.inc("tickets_cancelled")
            self.telemetry.emit("ticket_cancelled", ticket=entry.ticket,
                                tenant=entry.tenant, reason="queued_timeout")

    def _admit(self) -> None:
        while True:
            with self._lock:
                if len(self._active) >= self.max_active_jobs:
                    return
                counts: dict[str, int] = {}
                for a in self._active.values():
                    counts[a.tenant] = counts.get(a.tenant, 0) + 1
                entry = self.scheduler.pop_next(counts)
            if entry is None:
                return
            try:
                self._admit_one(entry)
            except Exception as exc:
                # The entry is already out of the scheduler, so one bad
                # ticket (unpicklable spec, spec validation refusing it,
                # a submit error) fails alone — the pump survives and
                # every other tenant keeps flowing.
                self.store.finish(entry.ticket,
                                  error=f"{type(exc).__name__}: {exc}")
                self.telemetry.inc("tickets_failed")
                self.telemetry.emit("ticket_failed", ticket=entry.ticket,
                                    tenant=entry.tenant, error=str(exc))

    def _admit_one(self, entry: QueueEntry) -> None:
        row = self._row(entry.ticket)
        spec = entry.spec if entry.spec is not None else row.load_spec()
        job_timeout = None
        if entry.timeout is not None:
            job_timeout = entry.deadline() - time.time()
            if job_timeout <= 0:
                self.store.cancel(
                    entry.ticket,
                    f"timed out after {entry.timeout}s while queued")
                self.telemetry.inc("tickets_cancelled")
                self.telemetry.emit("ticket_cancelled",
                                    ticket=entry.ticket,
                                    tenant=entry.tenant,
                                    reason="queued_timeout")
                return
        pol = self.scheduler.policy(entry.tenant)
        if self.mode == "fair":
            # Cross-tenant ordering is the DRR's job (already applied)
            # — inside the pool every tenant's jobs run at one
            # priority, with the tenant's credit cap metering items.
            handle = self.service.submit(
                spec, priority=0, timeout=job_timeout,
                retries=entry.retries, tenant=entry.tenant,
                max_inflight=pol.max_inflight,
            )
        else:
            handle = self.service.submit(
                spec, priority=entry.priority, timeout=job_timeout,
                retries=entry.retries, tenant=entry.tenant,
            )
        self.store.mark_running(entry.ticket)
        with self._lock:
            self._active[entry.ticket] = _Active(entry.ticket,
                                                 entry.tenant, handle)
        self.telemetry.inc("tickets_admitted")
        self.telemetry.emit("ticket_admitted", ticket=entry.ticket,
                            tenant=entry.tenant,
                            job=handle.job_id)

    # -- lifecycle -----------------------------------------------------------

    def close(self, *, wait: bool = True,
              timeout: float | None = 60.0) -> None:
        """Stop metering.  ``wait=True`` (default) first lets admitted
        jobs finish and records their results; queued tickets stay queued
        in the store either way — a later gateway over the same database
        resumes them.  The pool itself is left running (caller-owned)."""
        if wait:
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while True:
                with self._lock:
                    active = list(self._active.values())
                if not active:
                    break
                if deadline is not None and time.monotonic() >= deadline:
                    break
                active[0].handle.wait(0.25)
                self._reap()
        self.kill()

    def kill(self) -> None:
        """Abrupt stop — the crash the durability tests simulate: no
        reaping, no state transitions; ``running`` rows are left as-is for
        the next gateway's ``recover()`` to requeue."""
        self._stop.set()
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self._wake.set()
        self._pump.join(timeout=5.0)
        self.store.close()

    def __enter__(self) -> "JobGateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
