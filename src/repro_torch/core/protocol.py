"""CSP process model of the ClusterBuilder application network (Listing 3).

This is a direct transliteration of the paper's CSPm specification into a
labelled-transition-system (LTS) form that ``core.verify`` can exhaustively
check, generalised two ways beyond the paper: from ``W = 1`` worker per node
to ``W >= 1`` (the deployed network of Figure 2 has ``cores`` workers behind
every ``nrfa``), and from one cluster stage to an ordered *pipeline* of
stages (``PipelineSpec``) — each stage's reducer feeds the next stage's
server exactly as Emit feeds the first, so every hop repeats the same
client-server pattern.

Processes and channels (paper Figure 3, channels now stage-indexed):

    Emit --a.0--> Server_0 --c.0.i--> Client_0i --d.0.i--> Worker_0iw
                     ^-----b.0.i---------|
    Worker_0iw --e.0.i--> Reducer_0 --a.1--> Server_1 --...--> Reducer_{S-1}
    Reducer_{S-1} --f--> Collect --finished--> env

All channels are synchronous, unbuffered and unidirectional (CSP semantics:
a communication happens only when writer and reader are simultaneously
ready).  The hidden channels are everything except ``finished`` when
checking refinement against ``TestSystem = finished -> TestSystem`` —
exactly the setup of Listing 3 lines 50-58, with ``a..f`` now the union over
stages.

NOTE — paper erratum: Listing 3 line 28 reads ``Server_End(y) = b?y.S ->
c!y.UT -> if y == N then SKIP else Server_End(y+1)``.  Taken literally, with
clients indexed ``0..N-1`` the recursion reaches ``Server_End(N)`` and blocks
on the non-existent channel ``b.N`` — a deadlock FDR would flag.  We
implement the evidently-intended ``if y == N-1 then SKIP`` and the verifier
(tests) demonstrates that the literal version never reaches orderly
termination while the corrected one passes all assertions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Hashable, Iterable

# The Universal Terminator object (paper's ``UT``).
UT = "UT"

# Process-state sentinel equivalent to CSP SKIP (successful termination).
SKIP = ("SKIP",)

Event = tuple  # (channel_key, value)
State = Hashable


@dataclass(frozen=True)
class Output:
    chan: Hashable
    value: Any
    next_state: State


@dataclass(frozen=True)
class Input:
    chan: Hashable
    # accept(value) -> next_state, or None to refuse the value.
    accept: Callable[[Any], State | None]


class Process:
    """A process = initial state + ready-output/ready-input functions."""

    name: str = "proc"

    def initial(self) -> State:
        raise NotImplementedError

    def outputs(self, state: State) -> list[Output]:
        return []

    def inputs(self, state: State) -> list[Input]:
        return []

    def is_terminated(self, state: State) -> bool:
        return state == SKIP


# ---------------------------------------------------------------------------
# The six process kinds of Listing 3.
# ---------------------------------------------------------------------------


class EmitProc(Process):
    """Emit(o) = a!o -> if o == UT then SKIP else Emit(create(o))  {3:22}."""

    def __init__(self, num_objects: int):
        self.name = "emit"
        self.num_objects = num_objects

    def initial(self) -> State:
        return ("emit", 0)

    def outputs(self, state: State) -> list[Output]:
        if state == SKIP:
            return []
        _, k = state
        if k < self.num_objects:
            return [Output(("a", 0), k, ("emit", k + 1))]
        return [Output(("a", 0), UT, SKIP)]


class ServerProc(Process):
    """The ``onrl`` server {3:24-29} (with the line-28 erratum corrected).

    ``stage`` indexes which pipeline hop this server distributes for: it
    reads ``a.stage`` (the emit stream for stage 0, the previous stage's
    reducer output otherwise) and serves its own clients on
    ``b.stage.i``/``c.stage.i``.  ``literal_paper_model=True`` reproduces
    Listing 3 exactly (including the off-by-one) so the verifier can exhibit
    the deadlock.
    """

    def __init__(self, nclusters: int, stage: int = 0,
                 literal_paper_model: bool = False,
                 peer_input: bool = False):
        self.name = f"server{stage}"
        self.n = nclusters
        self.s = stage
        self.literal = literal_paper_model
        # A peer-routed hop renames the input stream ("a", s) -> ("p", s):
        # the *location* of the channel moved off the host, its protocol
        # (a well-behaved emit stream ending in one UT) did not — which is
        # exactly why the Listing-3 assertions transfer unchanged.
        self.in_chan: Hashable = ("p", stage) if peer_input else ("a", stage)

    def initial(self) -> State:
        return ("idle",)

    def inputs(self, state: State) -> list[Input]:
        if state == ("idle",):
            # Server() = a?o -> ...
            def accept(o: Any) -> State:
                return ("end", 0) if o == UT else ("have", o)

            return [Input(self.in_chan, accept)]
        if state[0] == "have":
            # Server_Choice(o) = [] x : {0..N-1} @ Service(x, o); Service
            # begins b?i.S.
            o = state[1]
            return [
                Input(("b", self.s, i), lambda _s, i=i, o=o: ("serve", i, o))
                for i in range(self.n)
            ]
        if state[0] == "end":
            # Server_End(y) = b?y.S -> c!y.UT -> ...
            y = state[1]
            if y < self.n:
                return [Input(("b", self.s, y),
                              lambda _s, y=y: ("end_serve", y))]
        return []

    def outputs(self, state: State) -> list[Output]:
        if state and state[0] == "serve":
            _, i, o = state
            return [Output(("c", self.s, i), o, ("idle",))]
        if state and state[0] == "end_serve":
            y = state[1]
            if self.literal:
                # Literal Listing 3: `if y == N then SKIP else Server_End(y+1)`
                nxt = SKIP if y == self.n else ("end", y + 1)
            else:
                nxt = SKIP if y == self.n - 1 else ("end", y + 1)
            return [Output(("c", self.s, y), UT, nxt)]
        return []


class ClientProc(Process):
    """The ``nrfa`` client of node ``i`` {3:30-31}, generalised to W workers.

    Client(i) = b!i.S -> c?i.o -> if o == UT then (d!i.UT * W -> SKIP)
                                  else (d!i.o -> Client(i))

    The one-place-buffer invariant is structural: the client re-enters the
    requesting state only *after* the d.i communication completes, so the
    server can never be blocked by a node with an idle worker (paper §5).
    """

    def __init__(self, i: int, workers: int, stage: int = 0):
        self.name = f"client{stage}.{i}"
        self.i = i
        self.s = stage
        self.workers = workers

    def initial(self) -> State:
        return ("req",)

    def outputs(self, state: State) -> list[Output]:
        if state == ("req",):
            return [Output(("b", self.s, self.i), "S", ("wait",))]
        if state and state[0] == "deliver":
            o = state[1]
            if o == UT:
                # First of W terminators — one per worker behind this client.
                nxt = SKIP if self.workers == 1 else ("term", 1)
                return [Output(("d", self.s, self.i), UT, nxt)]
            return [Output(("d", self.s, self.i), o, ("req",))]
        if state and state[0] == "term":
            w = state[1]
            nxt = SKIP if w + 1 == self.workers else ("term", w + 1)
            return [Output(("d", self.s, self.i), UT, nxt)]
        return []

    def inputs(self, state: State) -> list[Input]:
        if state == ("wait",):
            return [Input(("c", self.s, self.i), lambda o: ("deliver", o))]
        return []


class WorkerProc(Process):
    """Worker {3:35-36}: d?i.o -> (e!i.o ->) with UT termination."""

    def __init__(self, i: int, w: int, stage: int = 0):
        self.name = f"worker{stage}.{i}.{w}"
        self.i = i
        self.s = stage

    def initial(self) -> State:
        return ("work",)

    def inputs(self, state: State) -> list[Input]:
        if state == ("work",):
            return [Input(("d", self.s, self.i), lambda o: ("fwd", o))]
        return []

    def outputs(self, state: State) -> list[Output]:
        if state and state[0] == "fwd":
            o = state[1]
            nxt = SKIP if o == UT else ("work",)
            return [Output(("e", self.s, self.i), o, nxt)]
        return []


class ReducerProc(Process):
    """Reducer {3:39-45}, generalised: forwards non-UT objects from any e.i,
    counts ``N*W`` UTs (one per worker), then emits a single terminal UT.

    The final stage's reducer writes ``f`` (into Collect, as in the paper);
    an intermediate stage's reducer writes ``a.(s+1)`` — it *is* the next
    stage's Emit, which is the whole compositional argument: each hop sees
    upstream only as a well-behaved emit stream.
    """

    def __init__(self, nclusters: int, workers: int, stage: int = 0,
                 last: bool = True, peer_output: bool = False):
        self.name = f"reducer{stage}"
        self.n = nclusters
        self.s = stage
        if last:
            self.out_chan: Hashable = ("f",)
        elif peer_output:
            self.out_chan = ("p", stage + 1)
        else:
            self.out_chan = ("a", stage + 1)
        self.remaining = nclusters * workers

    def initial(self) -> State:
        return ("read", self.remaining)

    def inputs(self, state: State) -> list[Input]:
        if state and state[0] == "read":
            k = state[1]

            def accept(o: Any, k: int = k) -> State:
                if o == UT:
                    return ("fwd_ut",) if k == 1 else ("read", k - 1)
                return ("fwd", o, k)

            return [Input(("e", self.s, i), accept) for i in range(self.n)]
        return []

    def outputs(self, state: State) -> list[Output]:
        if state and state[0] == "fwd":
            _, o, k = state
            return [Output(self.out_chan, o, ("read", k))]
        if state == ("fwd_ut",):
            return [Output(self.out_chan, UT, SKIP)]
        return []


class CollectProc(Process):
    """Collect {3:46-48}: reads f until UT, then loops on finished!True."""

    def __init__(self) -> None:
        self.name = "collect"

    def initial(self) -> State:
        return ("run",)

    def inputs(self, state: State) -> list[Input]:
        if state == ("run",):
            return [Input(("f",), lambda o: ("done",) if o == UT else ("run",))]
        return []

    def outputs(self, state: State) -> list[Output]:
        if state == ("done",):
            return [Output(("finished",), True, ("done",))]
        return []

    def is_terminated(self, state: State) -> bool:
        return state == ("done",)


# ---------------------------------------------------------------------------
# Network assembly.
# ---------------------------------------------------------------------------


def normalize_routes(routes: "dict | Iterable[int] | None",
                     nstages: int) -> frozenset:
    """Validate peer-route declarations; return the set of source stages.

    Accepts a set/list of source stage indices (each meaning "the hop
    ``s -> s+1`` is peer-routed") or a ``{src: dst}`` dict — the explicit
    form exists so an ill-formed topology can be *stated* and rejected:
    a route whose destination is not downstream of its source would let
    items re-enter a stage they already left, so the per-stage UT
    accounting (each reducer counts exactly ``N*W`` terminators) could
    wait forever on a cycle the emit stream never closes.  That is
    refused here, before any state-space work.
    """
    if not routes:
        return frozenset()
    if isinstance(routes, dict):
        pairs = [(int(s), int(d)) for s, d in routes.items()]
    else:
        pairs = [(int(s), int(s) + 1) for s in routes]
    srcs = set()
    for src, dst in pairs:
        if not 0 <= src < nstages - 1:
            raise ValueError(
                f"peer route source stage {src} out of range for "
                f"{nstages} stages (a route leaves stages 0..{nstages - 2})"
            )
        if dst <= src:
            raise ValueError(
                f"cyclic peer route: stage {src} -> stage {dst} sends data "
                "backwards (or to itself), so stage UT accounting would "
                "deadlock — peer routes must target the next stage"
            )
        if dst != src + 1:
            raise ValueError(
                f"unsupported peer route: stage {src} -> stage {dst} skips "
                f"stage {src + 1}; peer routes cover the adjacent hop only"
            )
        srcs.add(src)
    return frozenset(srcs)


@dataclass
class ProtocolNetwork:
    """The composed System of Listing 3 lines 50-51."""

    processes: list[Process]
    visible_channels: frozenset = frozenset({("finished",)})

    @staticmethod
    def build(
        nclusters: int,
        workers_per_node: int = 1,
        num_objects: int = 5,
        literal_paper_model: bool = False,
    ) -> "ProtocolNetwork":
        return ProtocolNetwork.build_pipeline(
            [(nclusters, workers_per_node)],
            num_objects,
            literal_paper_model=literal_paper_model,
        )

    @staticmethod
    def build_pipeline(
        stage_shapes: list[tuple[int, int]],
        num_objects: int = 5,
        literal_paper_model: bool = False,
        routes: "dict | Iterable[int] | None" = None,
    ) -> "ProtocolNetwork":
        """The chained System: one (server, clients, workers, reducer) group
        per ``(nclusters, workers_per_node)`` stage shape, reducer *s* wired
        to server *s+1*; a single-entry list is Listing 3 verbatim.

        ``routes`` marks peer-routed hops (see :func:`normalize_routes`):
        for each source stage ``s`` in it the hop channel ``("a", s+1)``
        is renamed ``("p", s+1)`` — the stream's endpoints moved from the
        host to the nodes, its protocol did not, so the composition is
        re-verified over the renamed channels with zero new process kinds.
        """
        if not stage_shapes:
            raise ValueError("pipeline needs at least one stage shape")
        peer_srcs = normalize_routes(routes, len(stage_shapes))
        procs: list[Process] = [EmitProc(num_objects)]
        last = len(stage_shapes) - 1
        for s, (n, w) in enumerate(stage_shapes):
            procs.append(
                ServerProc(n, stage=s, literal_paper_model=literal_paper_model,
                           peer_input=(s - 1) in peer_srcs)
            )
            for i in range(n):
                procs.append(ClientProc(i, w, stage=s))
            for i in range(n):
                for wi in range(w):
                    procs.append(WorkerProc(i, wi, stage=s))
            procs.append(ReducerProc(n, w, stage=s, last=(s == last),
                                     peer_output=s in peer_srcs))
        procs.append(CollectProc())
        return ProtocolNetwork(processes=procs)

    def initial(self) -> tuple:
        return tuple(p.initial() for p in self.processes)

    def successors(self, state: tuple) -> Iterable[tuple[Event, tuple]]:
        """All enabled synchronisations from a global state.

        A transition exists for every (writer, reader) pair that is ready on
        the same channel and whose reader accepts the offered value.
        """
        procs = self.processes
        # Gather ready outputs and inputs per channel.
        outs: dict[Hashable, list[tuple[int, Output]]] = {}
        ins: dict[Hashable, list[tuple[int, Input]]] = {}
        for pi, proc in enumerate(procs):
            for out in proc.outputs(state[pi]):
                outs.setdefault(out.chan, []).append((pi, out))
            for inp in proc.inputs(state[pi]):
                ins.setdefault(inp.chan, []).append((pi, inp))
        for chan, writers in outs.items():
            if chan in self.visible_channels:
                # Environment always willing to observe visible events.
                for pi, out in writers:
                    ns = list(state)
                    ns[pi] = out.next_state
                    yield (chan, out.value), tuple(ns)
                continue
            for pi, out in writers:
                for qi, inp in ins.get(chan, []):
                    if pi == qi:
                        continue
                    nxt = inp.accept(out.value)
                    if nxt is None:
                        continue
                    ns = list(state)
                    ns[pi] = out.next_state
                    ns[qi] = nxt
                    yield (chan, out.value), tuple(ns)

    def is_hidden(self, event: Event) -> bool:
        return event[0] not in self.visible_channels

    def all_terminated(self, state: tuple) -> bool:
        return all(p.is_terminated(s) for p, s in zip(self.processes, state))
