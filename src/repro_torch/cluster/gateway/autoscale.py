"""Queue-driven pool autoscaling: grow on backlog, retire when idle.

The pool's geometry was fixed at boot; the gateway makes demand visible
(queue depth, oldest wait) — this control loop closes the loop through the
deployment layer's two existing elasticity paths:

* **up** — ``ClusterService.grow()`` launches fresh node-loaders that take
  the mid-run *late-join* path (REGISTER after the barrier → pool LOAD +
  every active job's LOAD + peer-directory broadcast);
* **down** — ``ClusterService.shrink()`` sends one node the *graceful
  retirement* UT: it drains its queued items, flushes, returns its timing
  record and exits; anything still in flight host-side is requeued exactly
  as a death would be, minus the death.

Scaling is bounded by ``min_nodes``/``max_nodes``, rate-limited by a
cooldown (a grow decision must not repeat while the launch it triggered is
still booting), and shrink only fires after the gateway has been fully
idle for ``idle_shrink_s``.  Every decision is a telemetry event plus the
``scale_up_events``/``scale_down_events`` counters CI gates on.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

__all__ = ["AutoscalePolicy", "Autoscaler"]


@dataclass
class AutoscalePolicy:
    """Bounds and thresholds for the control loop."""

    min_nodes: int = 1
    max_nodes: int = 4
    #: scale up when the oldest queued ticket waited this long...
    scale_up_wait_s: float = 1.0
    #: ...or when (queued + running) demand exceeds this per pool node.
    backlog_per_node: float = 4.0
    #: nodes launched per scale-up decision.
    step: int = 1
    #: no queued or running work for this long before retiring a node.
    idle_shrink_s: float = 10.0
    #: minimum seconds between scaling decisions (covers launch boot).
    cooldown_s: float = 3.0
    #: control loop period.
    interval_s: float = 0.25

    def validate(self) -> None:
        if self.min_nodes < 1:
            raise ValueError("min_nodes must be >= 1")
        if self.max_nodes < self.min_nodes:
            raise ValueError("max_nodes must be >= min_nodes")
        if self.step < 1:
            raise ValueError("step must be >= 1")


class Autoscaler:
    """The control thread; owned (started/stopped) by a JobGateway."""

    def __init__(self, gateway, policy: AutoscalePolicy):
        policy.validate()
        self.gateway = gateway
        self.policy = policy
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_scale = 0.0
        self._idle_since: float | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="gateway-autoscale",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- the control loop ----------------------------------------------------

    def _loop(self) -> None:
        pol = self.policy
        while not self._stop.wait(pol.interval_s):
            try:
                self._step(time.monotonic())
            except Exception:
                # The pool may be mid-teardown under us; scaling is an
                # optimisation and must never take the gateway down.
                continue

    def _step(self, now: float) -> None:
        pol = self.policy
        gw = self.gateway
        service = gw.service
        queued = gw.queued_count()
        running = gw.active_count()
        wait_s = gw.oldest_queued_wait()
        alive, launching = service.pool_span()
        span = alive + launching  # capacity present or already on its way
        demand = queued + running
        if demand > 0:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now
        if now - self._last_scale < pol.cooldown_s:
            return
        if queued > 0 and span < pol.max_nodes and (
                wait_s >= pol.scale_up_wait_s
                or span == 0
                or demand > span * pol.backlog_per_node):
            n = min(pol.step, pol.max_nodes - span)
            service.grow(n, reason="queue_backlog")
            self._last_scale = now
            return
        if (demand == 0 and alive > pol.min_nodes
                and self._idle_since is not None
                and now - self._idle_since >= pol.idle_shrink_s):
            if service.shrink(reason="pool_idle") is not None:
                self._last_scale = now
