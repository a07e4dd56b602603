"""Declarative process records mirroring the paper's (GPP-library) processes.

A ClusterBuilder specification instantiates these records exactly as Listing 2
of the paper does in Groovy::

    emit      = Emit(e_details=...)                 # {2:12}
    onrl      = OneNodeRequestedList()              # {2:13}
    nrfa      = NodeRequestingFanAny(destinations=cores)   # {2:16}
    group     = AnyGroupAny(workers=cores, function=Mdata.calculate)  # {2:17}
    afoc      = AnyFanOne(sources=cores)            # {2:20}
    afo       = AnyFanOne(sources=clusters)         # {2:28}
    collector = Collect(r_details=...)              # {2:29}

These records are *purely declarative* — they carry no channels.  The
``ClusterBuilder`` wires them (paper requirement 4: "define and build
application network interconnections with no user intervention") and the
runtime executes them; ``core.protocol``/``core.verify`` model-check the
resulting network.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


class ProcessRecord:
    """Marker base class for the declarative process records."""


@dataclass
class EmitDetails:
    """Mirror of the paper's ``DataDetails`` {2:7-11}.

    ``init`` is called once with ``init_data`` and returns the initial
    generator state; ``create`` is called repeatedly with the current state
    and must return ``(work_item | None, new_state)`` — ``None`` signals
    *normalTermination* (the generator is exhausted), after which the builder
    injects the Universal Terminator into the network.
    """

    name: str
    create: Callable[[Any], tuple[Any, Any]]
    init: Callable[..., Any] | None = None
    init_data: Sequence[Any] = ()

    def initial_state(self) -> Any:
        if self.init is None:
            return None
        return self.init(*self.init_data)


@dataclass
class ResultDetails:
    """Mirror of the paper's ``ResultDetails`` {2:23-27}.

    ``init`` returns the accumulator, ``collect(acc, item) -> acc`` folds one
    processed object in, ``finalise(acc)`` produces the final result (the
    paper prints counts; we return the value as well).
    """

    name: str
    collect: Callable[[Any, Any], Any]
    init: Callable[[], Any] = lambda: None
    finalise: Callable[[Any], Any] = lambda acc: acc


@dataclass
class Emit(ProcessRecord):
    """Produces work objects into the network (paper's ``Emit``)."""

    e_details: EmitDetails


@dataclass
class OneNodeRequestedList(ProcessRecord):
    """The ``onrl`` *server* process of the client-server pair.

    Reads one object from Emit, then waits for a *request* signal from any
    node's ``nrfa`` client and answers it with the object.  Responding to a
    client request in finite time, with no client-server loops, guarantees
    deadlock/livelock freedom (Welch et al. 1993) — model-checked in
    ``core.verify``.
    """


@dataclass
class NodeRequestingFanAny(ProcessRecord):
    """The ``nrfa`` *client* process resident on every node.

    Acts as a one-place buffer: it may only issue a new request to the server
    after it has delivered its current object to an idle worker.  This is the
    invariant that keeps the server unblocked (paper §5) and is asserted by
    the model checker.
    """

    destinations: int = 1  # number of workers it fans out to


@dataclass
class AnyGroupAny(ProcessRecord):
    """A group of identical worker processes (paper's ``group`` {2:17-19}).

    ``function`` is the user's sequential data-object method (e.g.
    ``Mdata.calculate``); workers read any, compute, and write any.
    """

    workers: int
    function: Callable[[Any], Any]


@dataclass
class AnyFanOne(ProcessRecord):
    """Merges ``sources`` input streams into one output stream.

    Used twice in the canonical network: per-node (``afoc``, merging that
    node's workers) and at the host (``afo``, merging the node streams into
    the collector).
    """

    sources: int


@dataclass
class Collect(ProcessRecord):
    """Folds processed objects into the final result (paper's ``Collect``)."""

    r_details: ResultDetails


@dataclass
class NodeNetwork:
    """The process group replicated on every cluster node (Figure 2)."""

    nrfa: NodeRequestingFanAny
    group: AnyGroupAny
    afoc: AnyFanOne

    def __post_init__(self) -> None:
        if self.nrfa.destinations != self.group.workers:
            raise ValueError(
                "nrfa.destinations must equal group.workers "
                f"({self.nrfa.destinations} != {self.group.workers})"
            )
        if self.afoc.sources != self.group.workers:
            raise ValueError(
                "afoc.sources must equal group.workers "
                f"({self.afoc.sources} != {self.group.workers})"
            )


@dataclass
class HostNetwork:
    """The process group resident on the host node (emit + collect phases)."""

    emit: Emit
    onrl: OneNodeRequestedList
    afo: AnyFanOne
    collector: Collect


@dataclass
class StageNetwork:
    """The record group of one pipeline stage.

    The paper's network (Figure 2) is the one-stage special case; a stage
    generalises it into a reusable hop: a host-side server (``onrl``) feeding
    ``nclusters`` replicas of the node fragment (``node_net``), merged back
    at the host by ``afo`` — whose output stream is either the next stage's
    server input or the collector.  Every hop is therefore exactly the
    client-server pattern whose deadlock/livelock freedom ``core.verify``
    proves; ``PipelineSpec`` chains the hops.
    """

    name: str
    nclusters: int
    node_net: NodeNetwork
    onrl: OneNodeRequestedList = field(default_factory=OneNodeRequestedList)
    afo: AnyFanOne | None = None
    # Per-stage data-plane knobs (None = inherit the cluster-wide values):
    # extra items beyond ``workers`` a node of this stage keeps buffered,
    # and the node-side result-flush interval in milliseconds.
    prefetch: int | None = None
    flush_ms: float | None = None
    # How this stage *receives* its input hop: None/"host" relays results
    # through the host (the paper's topology); "peer" ships them node-to-
    # node with the host keeping only the control plane.  ``key_fn``
    # (peer-only) turns the hop into a keyed shuffle: items land on the
    # target chosen by a stable hash of ``key_fn(value)``.
    route: str | None = None
    key_fn: Callable[[Any], Any] | None = None

    def __post_init__(self) -> None:
        if self.nclusters < 1:
            raise ValueError(
                f"stage {self.name!r}: nclusters must be >= 1, "
                f"got {self.nclusters}"
            )
        if self.afo is None:
            self.afo = AnyFanOne(sources=self.nclusters)
        elif self.afo.sources != self.nclusters:
            raise ValueError(
                f"stage {self.name!r}: afo.sources must equal nclusters "
                f"({self.afo.sources} != {self.nclusters}); the merge reads "
                "one stream per node"
            )

    @property
    def workers_per_node(self) -> int:
        return self.node_net.group.workers

    @property
    def function(self) -> Callable[[Any], Any]:
        return self.node_net.group.function
