"""Weighted-fair admission over tenants (deficit round robin + aging).

The warm service's dispatcher schedules *admitted* jobs strictly
priority-then-FIFO — fine for one user, starvation for many: a wide
high-priority job drains every node credit first.  The gateway therefore
meters **admission**: queued tickets enter the pool in an order decided
here, per tenant, and raw submit priority only ranks tickets *within* a
tenant (cross-tenant ordering is the weights' job).

The mechanism is deficit round robin.  Every eligible tenant accrues
credit in proportion to its weight; admitting one job costs one credit;
the tenant with the most accumulated credit goes next (ties break to the
least-recently-served, so equal weights alternate).  Credit is clamped at
``max(1, weight)`` and reset when a tenant's queue empties, so an idle
tenant cannot bank a burst.  Starvation-proofing *within* a tenant is
aging: a ticket's effective priority is ``priority + age/aging_s``, so any
queued ticket eventually outranks fresher high-priority ones.

``mode="fifo"`` keeps the whole structure but admits strictly
priority-then-FIFO across all tenants, kept as the baseline a fairness
measurement compares the weighted mode with.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

__all__ = ["TenantPolicy", "QueueEntry", "FairScheduler"]


@dataclass
class TenantPolicy:
    """Per-tenant shares and caps, keyed by tenant name in the gateway.

    * ``weight`` — DRR share; a weight-2 tenant is admitted twice per
      weight-1 admission when both have work;
    * ``max_active_jobs`` — concurrently *admitted* jobs (None = only the
      gateway-wide cap applies);
    * ``max_inflight`` — item-level credit cap enforced inside
      ``host_loader._answer``: the tenant's jobs together may hold at most
      this many host-dispatched items in flight, so one wide job cannot
      monopolise node credits (None = uncapped).
    """

    weight: float = 1.0
    max_active_jobs: int | None = None
    max_inflight: int | None = None

    def validate(self) -> None:
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")
        if self.max_active_jobs is not None and self.max_active_jobs < 0:
            raise ValueError("max_active_jobs must be >= 0")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")


@dataclass
class QueueEntry:
    """One queued ticket as the scheduler sees it."""

    ticket: str
    tenant: str
    priority: int
    submitted_at: float  # epoch seconds (matches the store rows)
    timeout: float | None = None
    retries: int = 0
    spec: Any = None  # the live object when enqueued this process
    seq: int = 0  # FIFO tiebreak, assigned by push()

    def deadline(self) -> float | None:
        if self.timeout is None:
            return None
        return self.submitted_at + self.timeout


@dataclass
class _TenantQueue:
    entries: list = field(default_factory=list)
    deficit: float = 0.0
    served: int = 0


class FairScheduler:
    """In-memory admission queue (see module docstring).

    Not thread-safe by itself — the owning gateway serializes access
    under its lock.  Pure data structure: no clocks of its own (callers
    pass ``now``), no threads, so it unit-tests deterministically.
    """

    def __init__(self, policies: dict[str, TenantPolicy] | None = None, *,
                 default: TenantPolicy | None = None, mode: str = "fair",
                 aging_s: float = 30.0):
        if mode not in ("fair", "fifo"):
            raise ValueError(f"mode must be 'fair' or 'fifo', got {mode!r}")
        if aging_s <= 0:
            raise ValueError(f"aging_s must be > 0, got {aging_s}")
        self.mode = mode
        self.aging_s = aging_s
        self.default = default or TenantPolicy()
        self.default.validate()
        self.policies = dict(policies or {})
        for pol in self.policies.values():
            pol.validate()
        self._queues: dict[str, _TenantQueue] = {}
        self._seq = 0
        self._pops = 0  # global serve counter (least-recently-served ties)

    def policy(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self.default)

    # -- queue maintenance ---------------------------------------------------

    def push(self, entry: QueueEntry) -> None:
        self._seq += 1
        entry.seq = self._seq
        self._queues.setdefault(entry.tenant, _TenantQueue()) \
            .entries.append(entry)

    def remove(self, ticket: str) -> QueueEntry | None:
        for tq in self._queues.values():
            for i, entry in enumerate(tq.entries):
                if entry.ticket == ticket:
                    del tq.entries[i]
                    if not tq.entries:
                        tq.deficit = 0.0
                    return entry
        return None

    def drop_expired(self, now: float | None = None) -> list[QueueEntry]:
        """Remove every queued entry whose submit timeout elapsed while it
        waited — the fix for ``submit(timeout=)`` on a still-queued job:
        it must leave the queue (and report ``cancelled``), not hold a
        scheduler slot forever."""
        now = time.time() if now is None else now
        expired = []
        for tq in self._queues.values():
            keep = []
            for entry in tq.entries:
                deadline = entry.deadline()
                if deadline is not None and now >= deadline:
                    expired.append(entry)
                else:
                    keep.append(entry)
            tq.entries = keep
            if not keep:
                tq.deficit = 0.0
        return expired

    # -- admission -----------------------------------------------------------

    def _effective_priority(self, entry: QueueEntry, now: float) -> float:
        return entry.priority + max(0.0, now - entry.submitted_at) / self.aging_s

    def _pop_best(self, tenant: str, now: float) -> QueueEntry:
        tq = self._queues[tenant]
        best = max(range(len(tq.entries)), key=lambda i: (
            self._effective_priority(tq.entries[i], now),
            -tq.entries[i].seq,
        ))
        entry = tq.entries.pop(best)
        self._pops += 1
        tq.served = self._pops
        if not tq.entries:
            tq.deficit = 0.0
        return entry

    def pop_next(self, active_by_tenant: dict[str, int] | None = None,
                 now: float | None = None) -> QueueEntry | None:
        """The next ticket to admit, or None when everything queued is
        blocked by a per-tenant ``max_active_jobs`` cap (or empty).
        ``active_by_tenant`` is the gateway's live count of admitted jobs
        per tenant."""
        now = time.time() if now is None else now
        active = active_by_tenant or {}

        def capped(tenant: str) -> bool:
            cap = self.policy(tenant).max_active_jobs
            return cap is not None and active.get(tenant, 0) >= cap

        eligible = [t for t, tq in self._queues.items()
                    if tq.entries and not capped(t)]
        if not eligible:
            return None
        if self.mode == "fifo":
            # The baseline: strict priority then FIFO across ALL tenants.
            best = max(
                eligible,
                key=lambda t: max(
                    (self._effective_priority(e, now), -e.seq)
                    for e in self._queues[t].entries
                ),
            )
            return self._pop_best(best, now)
        # DRR: everyone eligible accrues weight until someone can afford
        # an admission, then the richest (ties: least recently served,
        # then name for determinism) pays one credit and goes.
        while all(self._queues[t].deficit < 1.0 for t in eligible):
            for t in eligible:
                tq = self._queues[t]
                w = self.policy(t).weight
                tq.deficit = min(tq.deficit + w, max(1.0, w))
        winner = max(eligible, key=lambda t: (
            self._queues[t].deficit, -self._queues[t].served, t))
        self._queues[winner].deficit -= 1.0
        return self._pop_best(winner, now)

    # -- introspection -------------------------------------------------------

    def depth(self) -> int:
        return sum(len(tq.entries) for tq in self._queues.values())

    def depth_by_tenant(self) -> dict[str, int]:
        return {t: len(tq.entries) for t, tq in self._queues.items()
                if tq.entries}

    def oldest_wait(self, now: float | None = None) -> float:
        """Seconds the longest-queued ticket has waited (0 when empty) —
        the autoscaler's primary scale-up signal."""
        now = time.time() if now is None else now
        oldest = min(
            (e.submitted_at for tq in self._queues.values()
             for e in tq.entries),
            default=None,
        )
        return 0.0 if oldest is None else max(0.0, now - oldest)
