"""SSHLauncher: fan the identical node-loader command out over ssh.

This is the paper's deployment made literal — the arXiv:1708.05264 cluster
report boots its Raspberry-Pi farm by running one identical command per host
over ssh, and our node-loader was designed for exactly that shape: it needs
nothing but ``--host <ip> --port 2000``.  The launcher runs

    ssh <workstation> 'cd <dir> && env PYTHONPATH=... python -m
        repro_torch.cluster.node_loader --host <hnl-ip> --port <p>
        --node-id <id>'

once per node, round-robining over ``hosts``; a respawn avoids the machine
that already swallowed a launch (``avoid``).  The local ssh client process
*is* the node handle — killing it tears down the remote session (the
default opts force a pty with ``-tt`` precisely so sshd HUPs the remote
command), and its stdout/stderr are the remote node's logs.

**Code sync.**  Work functions shipped by value (cloudpickle) need only
their libraries; code shipped *by reference* (plain pickle, the paper's
``repro_torch.quickstart.Calculate``, user modules) needs this repo's
``src`` tree on the remote filesystem.  Three modes via ``remote_dir``:

* ``None`` (default) — assume a shared or identical filesystem (NFS'd home
  directories, the classic idle-workstation pool; also exactly right for
  ssh-to-localhost): the remote ``PYTHONPATH`` names this checkout's
  ``src`` and replicates this process's ``sys.path``.
* a path + ``sync="rsync"|"tar"|"auto"`` — push ``src`` to
  ``<host>:<remote_dir>/src`` before the first launch: ``rsync -az`` when
  available, else a ``tar -cf - | ssh tar -xf -`` pipeline (``auto`` picks).
  The remote ``PYTHONPATH`` is then ``<remote_dir>/src``.

The node env is :func:`~repro_torch.cluster.deploy.local.torch_node_env`'s,
with ``PYTHONPATH`` pointed at the remote tree: no platform is pinned, a
node runs on the device its work function names.  The sync ships ``src``
only, never ``build/``: a remote node that runs a CUDA kernel builds it
with its own ``nvcc`` at first use, into ``<remote_dir>/build/repro_torch/``
(``repro_torch.kernels._build.BUILD_DIR``), and pays that compile inside
its first work item.

Node-loaders started remotely race the host's listener, so launches always
pass ``--connect-timeout`` and the node-loader retries its dial with
backoff — start ordering is uncontrolled on a real network.
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import sys
from typing import Mapping, Sequence

from repro_torch.cluster.deploy.base import Launcher
from repro_torch.cluster.deploy.local import (
    PopenNodeHandle,
    node_loader_argv,
    torch_node_env,
)

# The tree that holds ``src``: ssh.py -> deploy -> cluster -> repro_torch
# -> src -> checkout root.  Syncs ship ``<source_root>/src`` to the remote side.
_SRC_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))

_DEFAULT_SSH_OPTS = (
    "-o", "BatchMode=yes",
    "-o", "StrictHostKeyChecking=accept-new",
    # Force a pty: without one sshd does NOT signal the remote command when
    # the client dies, so kill()ing the local ssh process would leave a
    # live node-loader on the workstation.  With a pty the hangup reaches
    # the remote process group — kill() means what NodeHandle says it
    # means.  (Cost: remote stderr merges into stdout in the logs.)
    "-tt",
)


class SSHLauncher(Launcher):
    """Starts node-loaders on remote workstations over ssh."""

    def __init__(
        self,
        hosts: Sequence[str],
        *,
        connect_host: str | None = None,
        python: str = "python3",
        remote_dir: str | None = None,
        sync: str = "auto",
        ssh_cmd: Sequence[str] = ("ssh",),
        ssh_opts: Sequence[str] | None = None,
        env: Mapping[str, str] | None = None,
        preload: Sequence[str] = (),
        connect_timeout: float = 60.0,
        source_root: str = _SRC_ROOT,
    ):
        if not hosts:
            raise ValueError("SSHLauncher needs at least one host")
        if sync not in ("auto", "rsync", "tar", "none"):
            raise ValueError(f"unknown sync mode {sync!r}")
        self.hosts = list(hosts)
        self.connect_host = connect_host
        self.python = python
        self.remote_dir = remote_dir
        self.sync = sync
        self.ssh_cmd = tuple(ssh_cmd)
        self.ssh_opts = tuple(
            _DEFAULT_SSH_OPTS if ssh_opts is None else ssh_opts
        )
        self.env = dict(env or {})
        self.preload = tuple(preload)
        self.connect_timeout = connect_timeout
        self.source_root = source_root
        self.port = 0
        self._next_host = 0
        self.synced_hosts: list[str] = []

    # -- preparation --------------------------------------------------------

    def prepare(self, connect_host: str, port: int) -> None:
        # An explicitly configured LAN-reachable connect_host always wins:
        # the application's bind address ("0.0.0.0", or a loopback default)
        # is generally not what a *remote* machine can dial.  Without one,
        # fall back to the bind address — correct for ssh-to-localhost.
        if self.connect_host is None:
            self.connect_host = (
                "127.0.0.1" if connect_host in ("0.0.0.0", "")
                else connect_host
            )
        self.port = port
        if self.remote_dir is not None and self.sync != "none":
            for host in dict.fromkeys(self.hosts):  # unique, ordered
                self.sync_code(host)

    def sync_code(self, host: str) -> None:
        """Push the ``src`` tree to ``host:remote_dir/src``."""
        method = self.sync
        if method == "auto":
            method = "rsync" if shutil.which("rsync") else "tar"
        if method == "rsync":
            self._sync_rsync(host)
        else:
            self._sync_tar(host)
        self.synced_hosts.append(host)

    def _ssh_argv(self, host: str, command: str) -> list[str]:
        return [*self.ssh_cmd, *self.ssh_opts, host, command]

    @staticmethod
    def _sh_expr(path: str) -> str:
        """Quote a remote path for sh, keeping a leading ``~`` expandable.

        ``shlex.quote("~/x")`` would make the remote shell look for a
        literal ``./~`` directory; home-relative paths (the natural way to
        name a per-user deploy dir) must go through ``$HOME`` instead.
        """
        if path == "~":
            return '"$HOME"'
        if path.startswith("~/"):
            return '"$HOME"/' + shlex.quote(path[2:])
        return shlex.quote(path)

    def _sync_rsync(self, host: str) -> None:
        self._run_checked(self._ssh_argv(
            host, f"mkdir -p {self._sh_expr(self.remote_dir)}"
        ))
        rsh = " ".join(shlex.quote(a) for a in (*self.ssh_cmd, *self.ssh_opts))
        self._run_checked([
            "rsync", "-az", "--delete", "--exclude", "__pycache__",
            "-e", rsh,
            os.path.join(self.source_root, "src") + "/",
            f"{host}:{self.remote_dir}/src/",
        ])

    def _sync_tar(self, host: str) -> None:
        """``tar -cf - src | ssh host 'mkdir -p dir && tar -xf - -C dir'`` —
        the no-rsync fallback (one round, no deletion of stale files)."""
        tar = subprocess.Popen(
            ["tar", "-C", self.source_root, "--exclude", "__pycache__",
             "-cf", "-", "src"],
            stdout=subprocess.PIPE,
        )
        remote = (f"mkdir -p {self._sh_expr(self.remote_dir)} && "
                  f"tar -xf - -C {self._sh_expr(self.remote_dir)}")
        try:
            untar = subprocess.run(
                self._ssh_argv(host, remote),
                stdin=tar.stdout, capture_output=True, text=True,
                timeout=120,
            )
        finally:
            tar.stdout.close()
            tar_rc = tar.wait()
        if tar_rc != 0 or untar.returncode != 0:
            raise RuntimeError(
                f"code sync to {host} failed (tar rc={tar_rc}, "
                f"ssh rc={untar.returncode}): {untar.stderr.strip()}"
            )

    @staticmethod
    def _run_checked(argv: list[str]) -> None:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{argv[0]} failed (rc={proc.returncode}): "
                f"{proc.stderr.strip()}"
            )

    # -- launching ----------------------------------------------------------

    def _pick_host(self, avoid: Sequence[str]) -> str:
        avoided = {a.removeprefix("ssh:") for a in avoid}
        for _ in range(len(self.hosts)):
            host = self.hosts[self._next_host % len(self.hosts)]
            self._next_host += 1
            if host not in avoided:
                return host
        # Every host already failed a launch: reuse the rotation anyway —
        # a retry on a flaky machine beats not retrying at all.
        host = self.hosts[self._next_host % len(self.hosts)]
        self._next_host += 1
        return host

    def _remote_env(self) -> dict[str, str]:
        env = torch_node_env()
        if self.remote_dir is not None:
            env["PYTHONPATH"] = f"{self.remote_dir}/src"
        else:  # shared/identical filesystem: this checkout and this path
            paths = [env["PYTHONPATH"], *(p for p in sys.path if p)]
            env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
        env.update(self.env)
        return env

    def remote_command(self, node_id: str) -> str:
        argv = node_loader_argv(
            self.connect_host, self.port, node_id,
            python=self.python, preload=self.preload,
            connect_timeout=self.connect_timeout,
        )
        # Env values quote through _sh_expr so a home-relative remote_dir
        # lands in PYTHONPATH as "$HOME"/... rather than a literal tilde.
        exports = " ".join(
            f"{k}={self._sh_expr(v)}" for k, v in self._remote_env().items()
        )
        cmd = f"env {exports} " + " ".join(shlex.quote(a) for a in argv)
        if self.remote_dir is not None:
            cmd = f"cd {self._sh_expr(self.remote_dir)} && {cmd}"
        return cmd

    def launch(self, node_id: str, *,
               avoid: Sequence[str] = ()) -> PopenNodeHandle:
        host = self._pick_host(avoid)
        proc = subprocess.Popen(
            self._ssh_argv(host, self.remote_command(node_id)),
            stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        return PopenNodeHandle(node_id, proc, where=f"ssh:{host}")
