"""repro_torch.cluster — the real (multi-process, TCP) deployment subsystem.

The paper's central deliverable is *deployment*: a Host-Node-Loader (HNL)
bootstraps a load network on port 2000 / channel 1, ships code to Node-Loaders
(NL) running on idle workstations, wires the application network, and only
then runs the emit/cluster/collect farm (§4, Figure 1).  ``runtime.local``
executes the same network as threads in one process; this package crosses the
process boundary: the *same* :class:`~repro_torch.core.dsl.ClusterSpec` runs over
real OS processes connected by sockets, with zero changes to user code —
``ClusterBuilder.build_application(spec, backend="cluster")``.

Modules (one per architectural role):

* :mod:`repro_torch.cluster.wire` — length-prefixed msgpack/pickle/ndarray wire
  format with a typed frame header (REGISTER/LOAD/WORK_REQUEST/WORK_BATCH/
  RESULT_BATCH/HEARTBEAT/UT plus the legacy WORK/RESULT single forms);
* :mod:`repro_torch.cluster.netchannels` — socket-backed channel ends with the same
  blocking queue API as the threaded runtime, so the protocol model-checked
  by ``core.verify`` still describes the network;
* :mod:`repro_torch.cluster.host_loader` — the Host-Node-Loader (registration,
  code broadcast, the credit-pipelined onrl server loop, collect, failure
  re-dispatch);
* :mod:`repro_torch.cluster.node_loader` — the Node-Loader a worker machine runs
  (register, boot-preload, load, windowed request→compute→batched deliver,
  UT shutdown);
* :mod:`repro_torch.cluster.peer` — the peer data plane: results of a
  ``route="peer"`` stage hop go node to node, the host keeping only the
  exactly-once ledger; named broadcast blocks striped over the pool;
* :mod:`repro_torch.cluster.membership` — registry + heartbeat tracking feeding the
  ``runtime.failures`` detection thresholds, with a launch lifecycle
  (launching/registered/loaded/done/dead/replaced) for the placement policy;
* :mod:`repro_torch.cluster.deploy` — the pluggable deployment layer: the
  :class:`~repro_torch.cluster.deploy.base.Launcher` contract plus LocalLauncher
  (subprocesses, §6.1 "test on one host first"), SSHLauncher (the identical
  node-loader command fanned out over ssh, with rsync/tar code sync) and
  InProcessLauncher (threads, for launcher-logic tests);
* :mod:`repro_torch.cluster.spawn` — ProcessClusterApplication: cluster lifecycle
  + placement policy over whichever launcher the deployment chose;
* :mod:`repro_torch.cluster.service` — ClusterService: a persistent warm node pool
  multiplexing many jobs over one bootstrap (digest-keyed warm code cache,
  FIFO-with-priority scheduling);
* :mod:`repro_torch.cluster.gateway` — the job gateway in front of the service:
  a durable SQLite-backed submit queue (tickets survive client disconnects
  and gateway restarts), a weighted-fair multi-tenant admission scheduler
  (deficit round robin + per-tenant in-flight caps), and a queue-driven
  autoscaler growing/shrinking the pool through the launcher's late-join
  and graceful-retirement paths;
* :mod:`repro_torch.cluster.telemetry` — live observability: the event bus +
  metrics registry every host-side component publishes into, the
  ``GET /metrics`` / dashboard HTTP endpoint, and the JSONL trace writer;
* :mod:`repro_torch.cluster.chaos` — fault injection against the real transport:
  a declarative :class:`~repro_torch.cluster.chaos.FaultPlan` (kill/drop/delay/
  duplicate/corrupt/stall-heartbeat/partition/straggler) armed by a
  :class:`~repro_torch.cluster.chaos.ChaosController`, exercising the heal +
  retry machinery continuously (``ClusterService(chaos=...)``).

This package must stay importable without torch: the node-loader bootstrap path
(wire/netchannels/membership/node_loader) imports no accelerator code; user
work functions pull in whatever they need when the shipped code is loaded.
"""

from repro_torch.cluster.chaos import (  # noqa: F401
    ChaosController,
    Fault,
    FaultPlan,
)
from repro_torch.cluster.wire import UT, Frame, FrameType  # noqa: F401
