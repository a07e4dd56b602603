"""Exhaustive verification of the ClusterBuilder network (the FDR analogue).

The paper proves its architecture correct by checking the CSPm model of
Listing 3 with FDR:

    53. assert (System \\ {|a,b,c,d,e,f|}) [T=  TestSystem
    54. assert (System \\ {|a,b,c,d,e,f|}) [F=  TestSystem
    55. assert (System \\ {|a,b,c,d,e,f|}) [FD= TestSystem
    56. assert System : [deadlock free]
    57. assert System : [divergence free]
    58. assert System : [deterministic]

FDR is not available here, so we implement the checks directly on the
composed labelled-transition system (``core.protocol``), which is finite for
fixed (N clusters, W workers, M objects) — the same finitisation the paper
uses (5 objects + UT, N = 2).  With the single visible event ``finished``:

* **deadlock freedom** — no reachable state without successors.  (The
  terminal configuration still offers ``finished`` forever, as in the paper.)
* **divergence freedom** — the subgraph of hidden (tau, i.e. ``a..f``)
  transitions is acyclic: no infinite internal chatter.
* **trace refinement [T=** — every visible event is ``finished`` (traces of
  the hidden system are prefixes of ``<finished, finished, ...>``).
* **failures refinement [F= / [FD=** — every *stable* state (one with no
  hidden transition enabled) must offer ``finished``; with divergence
  freedom this gives failures-divergences refinement of ``TestSystem``.
* **determinism** — with alphabet ``{finished}``, divergence freedom plus the
  stable-offer condition make the system failures-equivalent to the
  deterministic ``TestSystem``; we additionally check that no state both
  offers and (stably) refuses ``finished`` after identical traces, which for
  this alphabet reduces to: stable states are exactly the post-termination
  states.
* **orderly termination** — from every reachable state the terminal
  configuration (all processes SKIP / Collect done) is reachable, and it is
  actually reached on every maximal hidden path (no livelock before
  delivery); additionally every complete run delivers each emitted object
  exactly once (checked by trace accounting on ``f``).

A failed check returns a *witness trace* (sequence of events from the initial
state), which is what FDR's debugger would show.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass

from repro_torch.core.protocol import UT, Event, ProtocolNetwork


@dataclass
class VerificationReport:
    nclusters: int
    workers_per_node: int
    num_objects: int
    num_states: int
    num_transitions: int
    deadlock_free: bool
    divergence_free: bool
    trace_refines_testsystem: bool
    failures_refines_testsystem: bool
    deterministic: bool
    terminates: bool
    objects_delivered_exactly_once: bool
    witness: list[Event] | None = None
    failure: str | None = None
    # (nclusters, workers) per stage when checking a chained pipeline;
    # None for the paper's single-stage network.
    stage_shapes: list[tuple[int, int]] | None = None

    @property
    def ok(self) -> bool:
        return (
            self.deadlock_free
            and self.divergence_free
            and self.trace_refines_testsystem
            and self.failures_refines_testsystem
            and self.deterministic
            and self.terminates
            and self.objects_delivered_exactly_once
        )

    def summary(self) -> str:
        marks = lambda b: "PASS" if b else "FAIL"  # noqa: E731
        if self.stage_shapes and len(self.stage_shapes) > 1:
            shape = " -> ".join(f"{n}x{w}" for n, w in self.stage_shapes)
            head = (
                f"ClusterBuilder pipeline protocol check  stages={shape} "
                f"M={self.num_objects}: "
                f"{self.num_states} states, {self.num_transitions} transitions"
            )
        else:
            head = (
                f"ClusterBuilder protocol check  N={self.nclusters} "
                f"W={self.workers_per_node} M={self.num_objects}: "
                f"{self.num_states} states, {self.num_transitions} transitions"
            )
        lines = [
            head,
            f"  [T=  TestSystem          {marks(self.trace_refines_testsystem)}",
            f"  [F=  TestSystem          {marks(self.failures_refines_testsystem)}",
            f"  [FD= TestSystem          {marks(self.failures_refines_testsystem and self.divergence_free)}",
            f"  deadlock free            {marks(self.deadlock_free)}",
            f"  divergence free          {marks(self.divergence_free)}",
            f"  deterministic            {marks(self.deterministic)}",
            f"  orderly termination      {marks(self.terminates)}",
            f"  exactly-once delivery    {marks(self.objects_delivered_exactly_once)}",
        ]
        if self.failure:
            lines.append(f"  FAILURE: {self.failure}")
            if self.witness is not None:
                lines.append(f"  witness trace ({len(self.witness)} events):")
                for ev in self.witness[-12:]:
                    lines.append(f"    {ev}")
        return "\n".join(lines)


def _witness(preds: dict, state) -> list[Event]:
    """Reconstruct an event trace from the initial state to ``state``."""
    trace: list[Event] = []
    cur = state
    while True:
        entry = preds.get(cur)
        if entry is None:
            break
        prev, ev = entry
        trace.append(ev)
        cur = prev
    trace.reverse()
    return trace


def verify_network(
    nclusters: int,
    workers_per_node: int = 1,
    num_objects: int = 5,
    literal_paper_model: bool = False,
    max_states: int = 2_000_000,
) -> VerificationReport:
    """Exhaustively explore the composed LTS and evaluate all assertions."""
    return verify_pipeline(
        [(nclusters, workers_per_node)],
        num_objects,
        literal_paper_model=literal_paper_model,
        max_states=max_states,
    )


def verify_pipeline(
    stage_shapes: list[tuple[int, int]],
    num_objects: int = 4,
    literal_paper_model: bool = False,
    max_states: int = 2_000_000,
    routes: "dict | list | set | None" = None,
) -> VerificationReport:
    """Exhaustively check the chained (multi-stage) network.

    Every hop of the pipeline is the same client-server pattern the paper
    proves safe; this builds the *composed* LTS — stage s's reducer feeding
    stage s+1's server — and re-runs all of Listing 3's assertions on it,
    so the composition argument is machine-checked rather than assumed.
    A one-entry list is exactly ``verify_network``.

    ``routes`` marks peer-routed hops (source stage indices, or a
    ``{src: dst}`` dict); the model renames those hop channels to peer
    channels and all assertions re-run over the decentralised wiring.  An
    ill-formed declaration (cyclic / backwards route) raises ValueError
    before any state is explored.
    """
    net = ProtocolNetwork.build_pipeline(
        stage_shapes,
        num_objects,
        literal_paper_model=literal_paper_model,
        routes=routes,
    )
    init = net.initial()

    index: dict[tuple, int] = {init: 0}
    states: list[tuple] = [init]
    preds: dict[tuple, tuple] = {}
    # adjacency: state idx -> list[(event, succ idx, hidden)]
    adj: list[list[tuple[Event, int, bool]]] = []

    queue: deque[tuple] = deque([init])
    num_transitions = 0
    while queue:
        st = queue.popleft()
        succs: list[tuple[Event, int, bool]] = []
        for ev, ns in net.successors(st):
            if ns not in index:
                if len(index) >= max_states:
                    raise RuntimeError(
                        f"state space exceeds max_states={max_states}; "
                        "reduce N/W/M (the paper uses 5 objects, N=2)"
                    )
                index[ns] = len(states)
                states.append(ns)
                preds[ns] = (st, ev)
                queue.append(ns)
            succs.append((ev, index[ns], net.is_hidden(ev)))
            num_transitions += 1
        adj.append(succs)
    # ``adj`` was appended in BFS order == states order.

    report = VerificationReport(
        nclusters=stage_shapes[0][0],
        workers_per_node=stage_shapes[0][1],
        num_objects=num_objects,
        stage_shapes=[tuple(s) for s in stage_shapes],
        num_states=len(states),
        num_transitions=num_transitions,
        deadlock_free=True,
        divergence_free=True,
        trace_refines_testsystem=True,
        failures_refines_testsystem=True,
        deterministic=True,
        terminates=True,
        objects_delivered_exactly_once=True,
    )

    def fail(field_name: str, msg: str, state: tuple) -> None:
        setattr(report, field_name, False)
        if report.failure is None:
            report.failure = msg
            report.witness = _witness(preds, state)

    # -- deadlock freedom {3:56} -------------------------------------------
    for si, succs in enumerate(adj):
        if not succs:
            fail("deadlock_free", f"deadlock in state #{si}", states[si])

    # -- divergence freedom {3:57}: hidden-edge subgraph is acyclic --------
    color = [0] * len(states)  # 0 white, 1 grey, 2 black
    for start in range(len(states)):
        if color[start] != 0:
            continue
        stack: list[tuple[int, int]] = [(start, 0)]
        color[start] = 1
        while stack:
            node, ptr = stack[-1]
            hidden_succ = [d for (_e, d, h) in adj[node] if h]
            if ptr < len(hidden_succ):
                stack[-1] = (node, ptr + 1)
                nxt = hidden_succ[ptr]
                if color[nxt] == 1:
                    fail(
                        "divergence_free",
                        "cycle of hidden (tau) transitions: livelock",
                        states[nxt],
                    )
                    color[nxt] = 2
                elif color[nxt] == 0:
                    color[nxt] = 1
                    stack.append((nxt, 0))
            else:
                color[node] = 2
                stack.pop()

    # -- trace refinement [T= {3:53}: only `finished` is visible -----------
    for si, succs in enumerate(adj):
        for ev, _d, hidden in succs:
            if not hidden and ev[0] != ("finished",):
                fail(
                    "trace_refines_testsystem",
                    f"unexpected visible event {ev}",
                    states[si],
                )

    # -- failures refinement [F=/[FD= {3:54,55}: stable states offer
    #    `finished` -----------------------------------------------------------
    stable_states = []
    for si, succs in enumerate(adj):
        has_hidden = any(h for (_e, _d, h) in succs)
        if not has_hidden:
            stable_states.append(si)
            offers_finished = any(
                ev[0] == ("finished",) for (ev, _d, h) in succs if not h
            )
            if not offers_finished:
                fail(
                    "failures_refines_testsystem",
                    "stable state refuses `finished` (failure not allowed by "
                    "TestSystem)",
                    states[si],
                )

    # -- determinism {3:58} -------------------------------------------------
    # With visible alphabet {finished}: the system is deterministic iff after
    # every trace it cannot both accept and refuse `finished`.  Stable states
    # all offer `finished` (checked above) and unstable states resolve
    # internally without refusing forever (divergence freedom) — so any
    # violation is already reported; record it jointly.
    report.deterministic = (
        report.failures_refines_testsystem and report.divergence_free
    )

    # -- orderly termination: terminal config co-reachable from everywhere --
    terminal = {si for si in range(len(states)) if net.all_terminated(states[si])}
    if not terminal:
        fail("terminates", "terminal configuration unreachable", init)
    else:
        # reverse reachability from terminal states
        radj: list[list[int]] = [[] for _ in states]
        for si, succs in enumerate(adj):
            for _ev, di, _h in succs:
                radj[di].append(si)
        co = [False] * len(states)
        dq = deque(terminal)
        for t in terminal:
            co[t] = True
        while dq:
            node = dq.popleft()
            for p in radj[node]:
                if not co[p]:
                    co[p] = True
                    dq.append(p)
        for si in range(len(states)):
            if not co[si]:
                fail(
                    "terminates",
                    f"state #{si} cannot reach orderly termination",
                    states[si],
                )
                break

    # -- exactly-once delivery: every maximal trace delivers M objects ------
    # The f channel carries each object k exactly once before f!UT.  Because
    # the state space is a DAG on hidden edges (divergence free) we can check
    # this by walking any single maximal path (all paths agree on the
    # multiset of f events by confluence of the client-server protocol; we
    # additionally spot-check a second, reversed-priority path).
    for pick_last in (False, True):
        seen: list = []
        st_idx = 0
        guard = 0
        while True:
            succs = adj[st_idx]
            hidden_succs = [(ev, d) for (ev, d, h) in succs if h]
            if not hidden_succs:
                break
            ev, st_idx = hidden_succs[-1 if pick_last else 0]
            if ev[0] == ("f",) and ev[1] != UT:
                seen.append(ev[1])
            guard += 1
            if guard > num_transitions + len(states):
                fail(
                    "objects_delivered_exactly_once",
                    "path did not terminate",
                    states[st_idx],
                )
                break
        expected = list(range(num_objects))
        if sorted(seen) != expected:
            fail(
                "objects_delivered_exactly_once",
                f"delivered {sorted(seen)} != emitted {expected}",
                states[st_idx],
            )

    return report


def verify_spec(spec, num_objects: int = 4, **kw) -> VerificationReport:
    """Verify the protocol for a concrete spec (ClusterSpec or PipelineSpec).

    State space grows fast in (N, W); we clamp to the paper's scale (it used
    N=2, M=5) while keeping the *structure* of the user's spec.  For a
    multi-stage pipeline the per-hop argument is composed: each hop is first
    checked in isolation (it is exactly the paper's network), then the full
    chained LTS is explored at a further-clamped scale — the returned report
    is the chained one, so a failure anywhere surfaces with its witness.
    """
    pipe = spec.as_pipeline() if hasattr(spec, "as_pipeline") else spec
    if len(pipe.stages) == 1:
        st = pipe.stages[0]
        n = min(st.nclusters, 3)
        w = min(st.workers_per_node, 2)
        return verify_network(n, w, num_objects, **kw)
    # Per-hop first, covering EVERY stage (cheap, keeps W fidelity,
    # pinpoints the offending stage)...
    for st in pipe.stages:
        hop = verify_network(
            min(st.nclusters, 3), min(st.workers_per_node, 2),
            num_objects, **kw,
        )
        if not hop.ok:
            return hop
    # ...then the chained composition.  The LTS is a product over stages, so
    # the chain is clamped: first three hops, W=1 (the paper's own
    # finitisation), M<=3 — worker generality and the remaining hops were
    # already covered individually above.  Peer-routed hops declared on the
    # spec (``route="peer"`` on the receiving stage) carry into the model,
    # so the decentralised wiring is what gets verified.
    shapes = [(min(st.nclusters, 2), 1) for st in pipe.stages[:3]]
    routes = kw.pop("routes", None)
    if routes is None and hasattr(pipe, "peer_routed_hops"):
        routes = [s for s in pipe.peer_routed_hops() if s < len(shapes) - 1]
    return verify_pipeline(shapes, min(num_objects, 3), routes=routes, **kw)
