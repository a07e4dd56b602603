"""repro_torch.cluster.deploy — the pluggable deployment layer.

*How* node-loaders come into existence is orthogonal to everything else in
the cluster subsystem (the wire protocol, the credit pipeline, membership):
the paper's node side is one identical executable that needs only the
host's load address.  This package isolates that concern behind the
:class:`~repro_torch.cluster.deploy.base.Launcher` contract:

* :class:`LocalLauncher` — subprocesses on this machine (§6.1 single-host
  confidence building; the seed behaviour);
* :class:`SSHLauncher` — the same command fanned out over ssh to idle
  workstations, with rsync / tar-over-ssh code sync;
* :class:`InProcessLauncher` — node-loaders as threads (fast
  launcher-logic and placement-policy tests).

:class:`PlacementPolicy` is the host-side companion: what the registration
barrier does when launches misbehave (respawn silent nodes, degraded start
with ``min_nodes`` survivors, late join mid-run).
"""

from repro_torch.cluster.deploy.base import (  # noqa: F401
    Launcher,
    NodeHandle,
    PlacementPolicy,
)
from repro_torch.cluster.deploy.inprocess import (  # noqa: F401
    InProcessLauncher,
    ThreadNodeHandle,
)
from repro_torch.cluster.deploy.local import (  # noqa: F401
    LocalLauncher,
    PopenNodeHandle,
    node_loader_argv,
    spawn_node_loader,
)
from repro_torch.cluster.deploy.ssh import SSHLauncher  # noqa: F401
