"""repro_torch.cluster.telemetry — live observability for the cluster.

Three pieces, all stdlib-only (this package must import without torch, like
the rest of the node-loader bootstrap path):

* :mod:`~repro_torch.cluster.telemetry.registry` — the thread-safe event bus +
  metrics registry every host-side component publishes into, plus the
  JSONL trace writer for offline replay;
* :mod:`~repro_torch.cluster.telemetry.http` — the ``GET /metrics`` / ``/jobs``
  / ``/nodes`` / ``/events`` status endpoint (JSON + Prometheus text);
* :mod:`~repro_torch.cluster.telemetry.dashboard` — the self-contained HTML
  dashboard served at ``GET /``.

See ARCHITECTURE.md "Observability" for how the host loader, membership
layer and node heartbeats feed it.
"""

from repro_torch.cluster.telemetry.http import TelemetryServer  # noqa: F401
from repro_torch.cluster.telemetry.registry import (  # noqa: F401
    Histogram,
    Telemetry,
    TraceWriter,
    read_trace,
    total_counts,
)

__all__ = ["Histogram", "Telemetry", "TelemetryServer", "TraceWriter",
           "read_trace", "total_counts"]
