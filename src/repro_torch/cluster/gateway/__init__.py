"""repro_torch.cluster.gateway — the multi-tenant front door of a warm pool.

The paper's premise — idle workstations absorbing an organisation's big
jobs — implies many independent users sharing one cluster.  This package
is that sharing layer, sitting in front of
:class:`~repro_torch.cluster.service.ClusterService` (the Public Cluster line of
work, arXiv:0708.0605/0708.0603, is the shape; hyper-shell's
database-backed task table is the durability exemplar):

* :mod:`~repro_torch.cluster.gateway.store` — the SQLite ticket table: every
  submission is a row first, so tickets survive client disconnects and
  gateway restarts;
* :mod:`~repro_torch.cluster.gateway.scheduler` — weighted-fair admission:
  deficit round robin over tenants (priority only orders *within* a
  tenant) with starvation-proof aging, plus per-tenant caps;
* :mod:`~repro_torch.cluster.gateway.autoscale` — the queue-driven control loop
  growing/shrinking the pool through late join and graceful retirement;
* :mod:`~repro_torch.cluster.gateway.gateway` — :class:`JobGateway`, tying the
  three together: ``enqueue() -> ticket``, ``attach(ticket)``,
  ``cancel(ticket)``.

See ARCHITECTURE.md "Job gateway & fair scheduling".
"""

from repro_torch.cluster.gateway.autoscale import (  # noqa: F401
    AutoscalePolicy,
    Autoscaler,
)
from repro_torch.cluster.gateway.gateway import (  # noqa: F401
    JobCancelled,
    JobGateway,
    TicketHandle,
)
from repro_torch.cluster.gateway.scheduler import (  # noqa: F401
    FairScheduler,
    QueueEntry,
    TenantPolicy,
)
from repro_torch.cluster.gateway.store import TicketRow, TicketStore  # noqa: F401

__all__ = [
    "AutoscalePolicy",
    "Autoscaler",
    "FairScheduler",
    "JobCancelled",
    "JobGateway",
    "QueueEntry",
    "TenantPolicy",
    "TicketHandle",
    "TicketRow",
    "TicketStore",
]
