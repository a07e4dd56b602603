"""Executable emit/stages/collect network (the paper's Figure 2), local mode.

This is the runtime behind ``ClusterBuilder.build_application``: the wired
process network running as threads with bounded rendezvous channels on one
machine — precisely the paper's §6.1 *"operation and testing of a system can
be conducted on a single host node before using multiple nodes"* mode.  The
topology, the demand-driven client-server protocol (``onrl``/``nrfa``), the
one-place buffer invariant and Universal-Terminator shutdown are the ones
model-checked in ``core.verify``; this module is their operational twin.

Generalised to a :class:`~repro_torch.core.dsl.PipelineSpec`: each stage is the
Figure-2 fragment, and stage *s*'s host-side merge (``afo``) feeds stage
*s+1*'s server through a one-place rendezvous queue — the same channel
discipline as Emit feeding the first stage, which is exactly how the chained
CSP model composes.  A ``ClusterSpec`` is accepted and normalised to its
one-stage pipeline view.

Worker functions are expected to be PyTorch/numpy computations: PyTorch's
operations and the ctypes call that launches a CUDA kernel release the GIL,
so worker threads genuinely overlap.

``readonly_delivery=True`` delivers work items as read-only ndarray views,
mirroring the cluster backend's zero-copy wire codec (whose decoded arrays
are immutable) — so an in-place-mutating work function fails here, on one
host, the same way it would on the real cluster.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass
from typing import Any

from repro_torch.core.builder import DeploymentPlan
from repro_torch.core.timing import TimingCollector
from repro_torch.runtime.failures import WorkFunctionError


class _UT:
    """Universal Terminator (paper §4, Listing 3 {3:21})."""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "UT"


UT = _UT()


def _readonly_view(obj: Any) -> Any:
    """Recursively replace ndarrays with read-only views (no copy).

    Mirrors what the wire codec does to payloads: a bare ndarray decodes to
    a read-only ``np.frombuffer`` view, and ndarrays nested in containers
    arrive read-only through the ExtType path.  Non-array leaves pass
    through untouched.
    """
    import numpy as np

    if isinstance(obj, np.ndarray):
        view = obj.view()
        view.flags.writeable = False
        return view
    if isinstance(obj, dict):
        return {k: _readonly_view(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_readonly_view(v) for v in obj)
    if isinstance(obj, list):
        return [_readonly_view(v) for v in obj]
    return obj


@dataclass
class LocalClusterApplication:
    spec: Any  # PipelineSpec (a ClusterSpec is normalised on construction)
    plan: DeploymentPlan
    timing: TimingCollector
    readonly_delivery: bool = False

    result: Any = None
    _ran: bool = False

    def __post_init__(self) -> None:
        if hasattr(self.spec, "as_pipeline"):
            self.spec = self.spec.as_pipeline()

    def run(self) -> Any:
        """Load the network, run to termination, return the finalised result."""
        if self._ran:
            raise RuntimeError("application already ran; build a fresh one")
        self._ran = True
        pipe = self.spec
        stages = pipe.stages
        S = len(stages)
        # Flat node ids in stage order ("node0".. — the one-stage case keeps
        # the historical naming), grouped per stage for wiring.
        assignments = pipe.node_assignments()
        stage_node_ids: list[list[str]] = [[] for _ in range(S)]
        for node_id, s in assignments:
            stage_node_ids[s].append(node_id)

        errors: list[BaseException] = []
        err_lock = threading.Lock()

        with self.timing.phase("host", "load"):
            # -- channel construction (input ends before output ends, §6) --
            # stage_in[s] is the a.s channel: emit -> server 0, and the
            # stage-to-stage rendezvous (reducer s-1 -> server s) otherwise.
            stage_in = [queue.Queue(maxsize=1) for _ in range(S)]
            request_q = [queue.Queue() for _ in range(S)]  # b.s many-to-one
            node_in = [
                [queue.Queue(maxsize=1) for _ in range(st.nclusters)]
                for st in stages
            ]  # c.s.i
            work_q = [
                [queue.Queue(maxsize=1) for _ in range(st.nclusters)]
                for st in stages
            ]  # d.s.i (one-place buffer)
            afoc_q = [
                [queue.Queue(maxsize=st.workers_per_node)
                 for _ in range(st.nclusters)]
                for st in stages
            ]  # e.s.i
            afo_q = [queue.Queue() for _ in range(S)]  # node merge -> afo_s
            collect_q: queue.Queue = queue.Queue()  # f

            threads: list[threading.Thread] = []

            def _spawn(fn, *args, name: str) -> None:
                t = threading.Thread(target=fn, args=args, name=name, daemon=True)
                threads.append(t)

            # ---- host: Emit ------------------------------------------------
            def emit_proc() -> None:
                details = pipe.emit.e_details
                state = details.initial_state()
                while True:
                    item, state = details.create(state)
                    if item is None:  # normalTermination
                        stage_in[0].put(UT)
                        return
                    stage_in[0].put(item)

            # ---- per stage: onrl (server) ----------------------------------
            def onrl_proc(s: int) -> None:
                n = stages[s].nclusters
                while True:
                    obj = stage_in[s].get()
                    if obj is UT:
                        # Server_End: answer each node's next request with UT.
                        for _ in range(n):
                            node = request_q[s].get()
                            node_in[s][node].put(UT)
                        return
                    node = request_q[s].get()  # wait for any node's request
                    node_in[s][node].put(obj)  # answer it in finite time

            # ---- per node: nrfa (client, one-place buffer) -----------------
            def nrfa_proc(s: int, j: int) -> None:
                node_id = stage_node_ids[s][j]
                w = stages[s].workers_per_node
                with self.timing.phase(node_id, "load"):
                    pass  # channel ends created above; record the touchpoint
                t0 = time.perf_counter()
                while True:
                    request_q[s].put(j)  # b!j.S — only after prior delivery
                    obj = node_in[s][j].get()  # c?j.o
                    if obj is UT:
                        for _ in range(w):
                            work_q[s][j].put(UT)
                        break
                    work_q[s][j].put(obj)  # d!j.o (blocks until a worker idles)
                self.timing.add(node_id, "run",
                                (time.perf_counter() - t0) * 1e3)

            # ---- per node: workers -----------------------------------------
            def worker_proc(s: int, j: int, _wi: int) -> None:
                fn = stages[s].function
                node_id = stage_node_ids[s][j]
                readonly = self.readonly_delivery
                while True:
                    obj = work_q[s][j].get()
                    if obj is UT:
                        afoc_q[s][j].put(UT)
                        return
                    try:
                        value = fn(_readonly_view(obj) if readonly else obj)
                    except BaseException as exc:
                        # Record and keep consuming: a worker that died here
                        # would strand UTs and hang the network; instead the
                        # run raises WorkFunctionError after shutdown —
                        # matching the cluster backend's fail-fast report.
                        with err_lock:
                            errors.append(exc)
                        continue
                    afoc_q[s][j].put(value)
                    self.timing.count_item(node_id)

            # ---- per node: afoc (merge workers, net output) ----------------
            def afoc_proc(s: int, j: int) -> None:
                remaining = stages[s].workers_per_node
                while remaining:
                    obj = afoc_q[s][j].get()
                    if obj is UT:
                        remaining -= 1
                        continue
                    afo_q[s].put(obj)
                afo_q[s].put(UT)  # single UT per node

            # ---- per stage: afo (merge nodes -> next stage / collect) ------
            def afo_proc(s: int) -> None:
                downstream = stage_in[s + 1] if s + 1 < S else collect_q
                remaining = stages[s].nclusters
                while remaining:
                    obj = afo_q[s].get()
                    if obj is UT:
                        remaining -= 1
                        continue
                    downstream.put(obj)
                downstream.put(UT)

            # ---- host: collect ---------------------------------------------
            def collect_proc() -> None:
                details = pipe.collector.r_details
                acc = details.init()
                while True:
                    obj = collect_q.get()
                    if obj is UT:
                        self.result = details.finalise(acc)
                        return
                    acc = details.collect(acc, obj)

            _spawn(emit_proc, name="emit")
            for s, st in enumerate(stages):
                _spawn(onrl_proc, s, name=f"onrl{s}")
                for j in range(st.nclusters):
                    _spawn(nrfa_proc, s, j, name=f"nrfa{s}.{j}")
                    for wi in range(st.workers_per_node):
                        _spawn(worker_proc, s, j, wi,
                               name=f"worker{s}.{j}.{wi}")
                    _spawn(afoc_proc, s, j, name=f"afoc{s}.{j}")
                _spawn(afo_proc, s, name=f"afo{s}")
            _spawn(collect_proc, name="collect")

        with self.timing.phase("host", "run"):
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        if errors:
            first = errors[0]
            self.result = None
            raise WorkFunctionError(
                f"work function raised: {type(first).__name__}: {first}"
            ) from first
        return self.result
