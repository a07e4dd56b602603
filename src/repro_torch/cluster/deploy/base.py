"""The Launcher contract: *how* node-loaders come into existence.

The paper's deployment story (§4) deliberately makes the node side trivial —
every workstation runs the *identical* executable knowing only the host's
load address ("ip:2000/1").  Everything that varies between deployments is
therefore concentrated in one question: *who starts that executable, where?*
This module answers it with a small pluggable surface:

* :class:`Launcher` — ``launch(node_id) -> NodeHandle`` plus a one-time
  :meth:`Launcher.prepare` (told the host's connect address once the load
  port is bound) and :meth:`Launcher.close`.
* :class:`NodeHandle` — ``poll``/``wait``/``kill``/``logs`` over one launched
  node-loader, however it is incarnated (subprocess, ssh session, thread).
* :class:`PlacementPolicy` — what the host does when launches misbehave:
  respawn a node that never registers (``max_respawns``), admit the job with
  survivors (``min_nodes``), and let stragglers join after the run started
  (``allow_late_join``).

Concrete launchers: :class:`~repro_torch.cluster.deploy.local.LocalLauncher`
(subprocesses on this machine), :class:`~repro_torch.cluster.deploy.ssh.SSHLauncher`
(the same command fanned out over ssh), and
:class:`~repro_torch.cluster.deploy.inprocess.InProcessLauncher` (threads, for fast
launcher-logic tests).  No module here may import torch — launchers run on the
bare bootstrap side of the code-shipping boundary.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Sequence


class NodeHandle(abc.ABC):
    """One launched node-loader, however it runs (process, ssh, thread)."""

    node_id: str
    where: str  # human-readable placement, e.g. "local", "ssh:ws07", "thread"

    @abc.abstractmethod
    def poll(self) -> int | None:
        """Exit code, or None while the node-loader is still running."""

    @abc.abstractmethod
    def wait(self, timeout: float | None = None) -> int | None:
        """Block up to ``timeout`` for exit; returns the code or None."""

    @abc.abstractmethod
    def kill(self) -> None:
        """Hard-stop the node-loader (a real node loss, not a clean UT)."""

    @abc.abstractmethod
    def logs(self) -> list[str]:
        """Most recent stdout+stderr lines, for diagnostics."""

    @property
    def returncode(self) -> int | None:
        """Popen-compatible accessor (tests and callers poll this)."""
        return self.poll()


class Launcher(abc.ABC):
    """Starts node-loaders somewhere; the host neither knows nor cares where.

    Lifecycle: ``prepare(connect_host, port)`` once (after the host bound its
    load port — launchers that ship code do it here), then ``launch`` per
    node (and per respawn), then ``close`` at teardown.
    """

    def prepare(self, connect_host: str, port: int) -> None:
        """Told the load-network address nodes must dial; sync code if the
        target machines don't already share this filesystem.

        A host bound to the wildcard address is unroutable as a dial
        target; launchers whose nodes live on this machine substitute
        loopback (launchers that span machines must be configured with a
        reachable ``connect_host`` and keep it).
        """
        self.connect_host = (
            "127.0.0.1" if connect_host in ("0.0.0.0", "") else connect_host
        )
        self.port = port

    @abc.abstractmethod
    def launch(self, node_id: str, *,
               avoid: Sequence[str] = ()) -> NodeHandle:
        """Start one node-loader.  ``avoid`` names placements (``where``
        values) a respawn should steer clear of — the machine that already
        swallowed one launch silently."""

    def close(self) -> None:  # pragma: no cover - trivial default
        """Release launcher-held resources (nothing by default)."""


@dataclass
class PlacementPolicy:
    """What the host's registration barrier does about imperfect clusters.

    The paper assumes every workstation it was pointed at shows up; real
    idle-workstation pools (the arXiv:0708.0605 model) don't.  Three relaxes:

    * ``max_respawns`` — a node silent for ``respawn_after`` seconds is
      relaunched elsewhere (its first launch marked *replaced*), up to this
      many times cluster-wide.
    * ``min_nodes`` — at ``register_timeout`` the job is admitted with the
      survivors if at least this many registered (*degraded start*) instead
      of raising.  ``None`` means all expected nodes (the strict barrier).
    * ``allow_late_join`` — a node registering after the run started is
      given LOAD and answered credits immediately (the per-registration
      LOAD path always supported this; the barrier was what blocked it).
    * ``max_heals`` — a node that dies *during* a run is relaunched through
      the same ``_relaunch`` path (mid-run pool healing: dead → launching →
      registered, warm code re-shipped, credits re-armed), up to this many
      times cluster-wide.  0 keeps the historical behaviour of shrinking
      to survivors.

    ``respawn_after=None`` spreads the respawn budget evenly across the
    registration window (``register_timeout / (max_respawns + 1)``).
    """

    min_nodes: int | None = None
    max_respawns: int = 0
    respawn_after: float | None = None
    allow_late_join: bool = True
    max_heals: int = 0

    def validate(self, nclusters: int) -> None:
        if self.min_nodes is not None and not (
                1 <= self.min_nodes <= nclusters):
            raise ValueError(
                f"min_nodes must be in [1, {nclusters}], got {self.min_nodes}"
            )
        if self.max_respawns < 0:
            raise ValueError(f"max_respawns must be >= 0, got {self.max_respawns}")
        if self.max_heals < 0:
            raise ValueError(f"max_heals must be >= 0, got {self.max_heals}")
