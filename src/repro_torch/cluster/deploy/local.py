"""LocalLauncher: node-loaders as subprocesses of this machine.

The paper's §6.1 workflow — "operation and testing of a system can be
conducted on a single host node before using multiple nodes" — with true
process isolation: each Node-Loader is a fresh ``python -m
repro_torch.cluster.node_loader`` OS process talking TCP on localhost, so there is
no GIL coupling and killing one is a *real* node death, not an injected one.

The launcher exports the port's ``src/`` and the host's ``sys.path`` to the
children so code shipped by reference (plain pickle, user modules) resolves;
code shipped by value (cloudpickle closures) needs only the libraries it
imports.  Children are started with ``subprocess`` (fork and exec), so a
host that has already opened a CUDA context never forks a live copy of it:
every node-loader opens its own.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Sequence

from repro_torch.cluster.deploy.base import Launcher, NodeHandle


# The checkout's ``src/``, which holds ``repro_torch``.
SRC_DIR = str(Path(__file__).resolve().parents[3])


def torch_node_env() -> dict[str, str]:
    """The env overlay every node-loader needs, whatever launches it.

    Only the port's ``src/`` on ``PYTHONPATH``, so ``python -m
    repro_torch.cluster.node_loader`` resolves and code pickled by
    reference imports on the node.  No platform is pinned: a node runs on
    the device its spec names.  No compile cache is named either: the
    kernels' libraries are shared through the checkout's
    ``build/repro_torch``, found by the hash of their source, so a node
    loads the library the host built instead of running ``nvcc`` again.
    """
    return {"PYTHONPATH": SRC_DIR}


def _child_env() -> dict[str, str]:
    env = dict(os.environ)
    paths = [torch_node_env()["PYTHONPATH"], *(p for p in sys.path if p)]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    return env


def node_loader_argv(host: str, port: int, node_id: str,
                     *, python: str = sys.executable,
                     preload: Sequence[str] = (),
                     connect_timeout: float | None = None) -> list[str]:
    """The §4 'identical executable' invocation every launcher fans out."""
    cmd = [python, "-m", "repro_torch.cluster.node_loader",
           "--host", host, "--port", str(port), "--node-id", node_id]
    if preload:
        cmd += ["--preload", ",".join(preload)]
    if connect_timeout is not None:
        cmd += ["--connect-timeout", str(connect_timeout)]
    return cmd


def spawn_node_loader(host: str, port: int, node_id: str,
                      *, python: str = sys.executable,
                      preload: tuple[str, ...] = ()) -> subprocess.Popen:
    """Start one Node-Loader subprocess (kept for direct callers).

    ``preload`` names modules the child imports concurrently with its
    registration (e.g. ``("repro_torch.quickstart",)``), so heavy
    environment boot overlaps the load-network handshake instead of
    serializing after it.
    """
    return subprocess.Popen(
        node_loader_argv(host, port, node_id, python=python, preload=preload),
        env=_child_env(),
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


class PopenNodeHandle(NodeHandle):
    """A node-loader behind a local ``subprocess.Popen`` (direct child or an
    ssh client process).  Stdout+stderr are drained continuously so a chatty
    child never blocks on a full pipe; the tail is kept for diagnostics."""

    def __init__(self, node_id: str, proc: subprocess.Popen,
                 where: str = "local", log_lines: int = 200):
        self.node_id = node_id
        self.where = where
        self.proc = proc
        self._log: collections.deque[str] = collections.deque(maxlen=log_lines)
        self._drainers: list[threading.Thread] = []
        for stream in (proc.stdout, proc.stderr):
            if stream is None:
                continue
            t = threading.Thread(target=self._drain, args=(stream,),
                                 name=f"drain-{node_id}", daemon=True)
            t.start()
            self._drainers.append(t)

    def _drain(self, stream) -> None:
        for line in stream:
            self._log.append(line.rstrip("\n"))
        stream.close()

    def poll(self) -> int | None:
        return self.proc.poll()

    def wait(self, timeout: float | None = None) -> int | None:
        try:
            return self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def kill(self) -> None:
        self.proc.kill()

    def logs(self) -> list[str]:
        return list(self._log)

    def join_drainers(self, timeout: float = 5.0) -> None:
        for t in self._drainers:  # EOF arrives once the child exits
            t.join(timeout=timeout)

    @property
    def returncode(self) -> int | None:
        return self.proc.returncode


class LocalLauncher(Launcher):
    """Forks node-loader subprocesses on this machine (the seed behaviour,
    extracted out of ``ProcessClusterApplication``)."""

    def __init__(self, *, python: str = sys.executable,
                 preload: Sequence[str] = ()):
        self.python = python
        self.preload = tuple(preload)
        self.connect_host = "127.0.0.1"
        self.port = 0

    def launch(self, node_id: str, *,
               avoid: Sequence[str] = ()) -> PopenNodeHandle:
        proc = spawn_node_loader(
            self.connect_host, self.port, node_id,
            python=self.python, preload=self.preload,
        )
        return PopenNodeHandle(node_id, proc, where="local")
