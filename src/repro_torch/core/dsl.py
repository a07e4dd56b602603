"""The ClusterBuilder DSL.

The paper's DSL (Listing 1) is a Groovy source file with three cluster
annotations::

    01. ... constants used in definition
    02. //@emit host-ip
    03. ... emit process definition
    04. //@cluster Nclusters
    05. ... cluster process definition
    06. //@collect
    07. ... collect process definition

We keep the textual front end *faithful* — a ``.cgpp`` file with the same
``//@emit`` / ``//@cluster`` / ``//@collect`` annotations, whose sections are
Python instead of Groovy — and we additionally expose the same structure as a
plain Python API (:class:`ClusterSpec`).  Both produce identical specs; the
builder (``core.builder``) consumes a spec and derives the entire deployment
(requirements 3, 4 and 6: minimal user code, automatic network construction,
no knowledge of the interconnect).

Beyond the paper, the spec layer generalises the single
emit → cluster → collect topology to an ordered *pipeline* of stages
(:class:`PipelineSpec`): one emit, N chained cluster stages, one collect.
Three front ends produce it:

* the extended grammar — ``//@stage <name> <N>`` sections, repeatable,
  in place of the single ``//@cluster N`` (which still parses, as the
  one-stage special case);
* the fluent API —
  ``Pipeline(host=...).emit(d).stage(f, nodes=2, workers=4).stage(g)
  .collect(r).build()``;
* :meth:`PipelineSpec.simple` from a list of :class:`Stage` records.

:class:`ClusterSpec` is unchanged and remains the one-stage special case;
``ClusterSpec.as_pipeline()`` is the thin bridge every runtime consumes.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Sequence

from repro_torch.core.processes import (
    AnyFanOne,
    AnyGroupAny,
    Collect,
    Emit,
    EmitDetails,
    HostNetwork,
    NodeNetwork,
    NodeRequestingFanAny,
    OneNodeRequestedList,
    ProcessRecord,
    ResultDetails,
    StageNetwork,
)

_EMIT_RE = re.compile(r"^//@emit\s+(?P<host>\S+)\s*$")
_CLUSTER_RE = re.compile(r"^//@cluster\s+(?P<n>\S+)\s*$")
_STAGE_RE = re.compile(r"^//@stage\s+(?P<name>[A-Za-z_]\w*)\s+(?P<n>\S+)\s*$")
_COLLECT_RE = re.compile(r"^//@collect\s*$")


@dataclass
class ClusterSpec:
    """A parsed/constructed ClusterBuilder application specification.

    Attributes:
      host: IP (or symbolic name) of the host node — the only piece of
        network knowledge the user must supply (requirement 6).
      nclusters: number of cluster nodes (``//@cluster N``).
      workers_per_node: worker processes per node ("cores" in Listing 2).
      host_net / node_net: the declarative process records.
      constants: the constants section of the DSL file, for provenance.
    """

    host: str
    nclusters: int
    host_net: HostNetwork
    node_net: NodeNetwork
    constants: dict[str, Any] = field(default_factory=dict)

    @property
    def workers_per_node(self) -> int:
        return self.node_net.group.workers

    @property
    def total_workers(self) -> int:
        return self.nclusters * self.workers_per_node

    def validate(self) -> None:
        """Static validation of the canonical emit->cluster->collect topology.

        The paper's builder only accepts well-formed specs; violations are
        caught *before* deployment (this mirrors gppBuilder's checks).
        """
        if self.nclusters < 1:
            raise ValueError(f"nclusters must be >= 1, got {self.nclusters}")
        if self.workers_per_node < 1:
            raise ValueError(
                f"workers per node must be >= 1, got {self.workers_per_node}"
            )
        if self.host_net.afo.sources != self.nclusters:
            raise ValueError(
                "host AnyFanOne.sources must equal nclusters "
                f"({self.host_net.afo.sources} != {self.nclusters}); the "
                "result-merge process reads one stream per node"
            )
        # NodeNetwork.__post_init__ already enforced intra-node consistency.
        if not callable(self.node_net.group.function):
            raise TypeError("cluster group function must be callable")

    def as_pipeline(self) -> "PipelineSpec":
        """View this spec as the one-stage special case of a pipeline.

        Every runtime consumes a :class:`PipelineSpec`; this bridge is what
        keeps the paper-faithful ClusterSpec API working unchanged on top of
        the generalised machinery.
        """
        return PipelineSpec(
            host=self.host,
            emit=self.host_net.emit,
            stages=[
                StageNetwork(
                    name="cluster",
                    nclusters=self.nclusters,
                    node_net=self.node_net,
                    onrl=self.host_net.onrl,
                    afo=self.host_net.afo,
                )
            ],
            collector=self.host_net.collector,
            constants=dict(self.constants),
        )

    # -- convenience constructor -------------------------------------------

    @staticmethod
    def simple(
        *,
        host: str,
        nclusters: int,
        workers_per_node: int,
        emit_details: EmitDetails,
        work_function: Callable[[Any], Any],
        result_details: ResultDetails,
        constants: Mapping[str, Any] | None = None,
    ) -> "ClusterSpec":
        """Build the canonical network of Figure 2 from user callables only."""
        host_net = HostNetwork(
            emit=Emit(e_details=emit_details),
            onrl=OneNodeRequestedList(),
            afo=AnyFanOne(sources=nclusters),
            collector=Collect(r_details=result_details),
        )
        node_net = NodeNetwork(
            nrfa=NodeRequestingFanAny(destinations=workers_per_node),
            group=AnyGroupAny(workers=workers_per_node, function=work_function),
            afoc=AnyFanOne(sources=workers_per_node),
        )
        spec = ClusterSpec(
            host=host,
            nclusters=nclusters,
            host_net=host_net,
            node_net=node_net,
            constants=dict(constants or {}),
        )
        spec.validate()
        return spec


# ---------------------------------------------------------------------------
# The generalised spec: an ordered pipeline of stages.
# ---------------------------------------------------------------------------


@dataclass
class Stage:
    """User-facing stage descriptor for the fluent / ``simple`` APIs.

    A stage is ``nclusters`` nodes, each running ``workers_per_node``
    workers that apply ``fn`` to every item the stage receives.  The process
    records (nrfa/group/afoc + host-side onrl/afo) are derived, exactly as
    ``ClusterSpec.simple`` derives the Figure-2 network.
    """

    name: str
    fn: Callable[[Any], Any]
    nclusters: int = 1
    workers_per_node: int = 1
    # Per-stage data-plane overrides; None inherits the cluster-wide values
    # given to the runtime (HostLoader prefetch / flush_interval).
    prefetch: int | None = None
    flush_ms: float | None = None
    # How this stage receives its input hop: None/"host" relays through the
    # host, "peer" ships node-to-node (key_fn turns the hop into a keyed
    # shuffle).  Only meaningful on the cluster/service backends; the
    # threads backend ignores routing (it has no wire).
    route: str | None = None
    key_fn: Callable[[Any], Any] | None = None

    def to_network(self) -> StageNetwork:
        w = self.workers_per_node
        return StageNetwork(
            name=self.name,
            nclusters=self.nclusters,
            node_net=NodeNetwork(
                nrfa=NodeRequestingFanAny(destinations=w),
                group=AnyGroupAny(workers=w, function=self.fn),
                afoc=AnyFanOne(sources=w),
            ),
            prefetch=self.prefetch,
            flush_ms=self.flush_ms,
            route=self.route,
            key_fn=self.key_fn,
        )


@dataclass
class PipelineSpec:
    """A multi-stage ClusterBuilder specification.

    One emit, an ordered list of cluster stages, one collect.  Each result
    of stage *s* becomes one work item of stage *s+1* (the final stage's
    results are folded by the collector), so the single-stage case is
    byte-for-byte the paper's topology — :class:`ClusterSpec` converts via
    ``as_pipeline()`` and all three backends consume only this form.
    """

    host: str
    emit: Emit
    stages: list[StageNetwork]
    collector: Collect
    constants: dict[str, Any] = field(default_factory=dict)

    # -- shape ---------------------------------------------------------------

    @property
    def nstages(self) -> int:
        return len(self.stages)

    @property
    def total_nodes(self) -> int:
        return sum(st.nclusters for st in self.stages)

    @property
    def total_workers(self) -> int:
        return sum(st.nclusters * st.workers_per_node for st in self.stages)

    def node_assignments(self) -> list[tuple[str, int]]:
        """Flat ``(node_id, stage_index)`` assignment, stage order.

        Node ids stay ``node0..node{K-1}`` so the one-stage case reproduces
        the historical naming exactly (timing records, tests, logs).
        """
        out: list[tuple[str, int]] = []
        i = 0
        for s, st in enumerate(self.stages):
            for _ in range(st.nclusters):
                out.append((f"node{i}", s))
                i += 1
        return out

    def stage_of(self, node_id: str) -> int:
        """Stage index a node id belongs to.

        Respawn replacements (``node3r1``) map to their base id; unknown
        ids (elastic late joiners) default to stage 0.
        """
        mapping = dict(self.node_assignments())
        if node_id in mapping:
            return mapping[node_id]
        base = node_id.split("r", 1)[0]
        return mapping.get(base, 0)

    # -- one-stage compatibility views ---------------------------------------

    def _single(self) -> StageNetwork:
        if len(self.stages) != 1:
            raise ValueError(
                f"pipeline has {len(self.stages)} stages; the one-stage "
                "accessors (nclusters/workers_per_node/node_net) do not "
                "apply — iterate .stages"
            )
        return self.stages[0]

    @property
    def nclusters(self) -> int:
        return self._single().nclusters

    @property
    def workers_per_node(self) -> int:
        return self._single().workers_per_node

    @property
    def node_net(self) -> NodeNetwork:
        return self._single().node_net

    @property
    def host_net(self) -> HostNetwork:
        """The host-side record group (first stage's server feeds it, last
        stage's merge drains into the collector)."""
        return HostNetwork(
            emit=self.emit,
            onrl=self.stages[0].onrl,
            afo=self.stages[-1].afo,
            collector=self.collector,
        )

    def as_pipeline(self) -> "PipelineSpec":
        return self

    def as_cluster_spec(self) -> ClusterSpec:
        """Collapse a one-stage pipeline back to the paper's ClusterSpec."""
        st = self._single()
        return ClusterSpec(
            host=self.host,
            nclusters=st.nclusters,
            host_net=self.host_net,
            node_net=st.node_net,
            constants=dict(self.constants),
        )

    # -- validation ----------------------------------------------------------

    def validate(self) -> None:
        if not self.stages:
            raise ValueError("pipeline must have at least one stage")
        names = [st.name for st in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        for st in self.stages:
            if st.nclusters < 1:
                raise ValueError(
                    f"stage {st.name!r}: nclusters must be >= 1"
                )
            if st.workers_per_node < 1:
                raise ValueError(
                    f"stage {st.name!r}: workers per node must be >= 1"
                )
            if st.afo.sources != st.nclusters:
                raise ValueError(
                    f"stage {st.name!r}: AnyFanOne.sources must equal "
                    f"nclusters ({st.afo.sources} != {st.nclusters}); the "
                    "merge reads one stream per node"
                )
            if not callable(st.node_net.group.function):
                raise TypeError(
                    f"stage {st.name!r}: group function must be callable"
                )
        for s, st in enumerate(self.stages):
            route = getattr(st, "route", None)
            if route not in (None, "host", "peer"):
                raise ValueError(
                    f"stage {st.name!r}: route must be None, 'host' or "
                    f"'peer', got {route!r}"
                )
            key_fn = getattr(st, "key_fn", None)
            if key_fn is not None and route != "peer":
                raise ValueError(
                    f"stage {st.name!r}: key_fn only applies to "
                    "route='peer' hops"
                )
            if key_fn is not None and not callable(key_fn):
                raise TypeError(
                    f"stage {st.name!r}: key_fn must be callable"
                )
            if route == "peer" and s == 0:
                raise ValueError(
                    f"stage {st.name!r}: the first stage cannot use "
                    "route='peer' — its input comes from the host-side "
                    "emit, which has no peer edge"
                )

    def peer_routed_hops(self) -> dict[int, dict]:
        """Source stage -> hop descriptor for every ``route='peer'`` hop.

        Keyed by the *sending* stage ``s`` (the hop ``s -> s+1``); the
        ``route`` knob itself sits on the receiving stage.  The runtime
        builds routing tables from this, ``verify_spec`` the peer-channel
        model.
        """
        hops: dict[int, dict] = {}
        for s1, st in enumerate(self.stages):
            if getattr(st, "route", None) == "peer":
                hops[s1 - 1] = {"key_fn": getattr(st, "key_fn", None)}
        return hops

    # -- convenience constructor ---------------------------------------------

    @staticmethod
    def simple(
        *,
        host: str,
        emit_details: EmitDetails,
        stages: Sequence[Stage],
        result_details: ResultDetails,
        constants: Mapping[str, Any] | None = None,
    ) -> "PipelineSpec":
        spec = PipelineSpec(
            host=host,
            emit=Emit(e_details=emit_details),
            stages=[s.to_network() for s in stages],
            collector=Collect(r_details=result_details),
            constants=dict(constants or {}),
        )
        spec.validate()
        return spec


class Pipeline:
    """Fluent builder for :class:`PipelineSpec`.

    ::

        spec = (Pipeline(host="192.168.1.176")
                .emit(EmitDetails(...))
                .stage(render, nodes=2, workers=4)
                .stage(reduce_line)
                .collect(ResultDetails(...))
                .build())

    Each call returns the builder; ``build()`` validates completeness and
    produces the spec.  The one-stage form is exactly
    ``ClusterSpec.simple`` with different spelling.
    """

    def __init__(self, host: str, constants: Mapping[str, Any] | None = None):
        self._host = host
        self._constants = dict(constants or {})
        self._emit: EmitDetails | None = None
        self._stages: list[Stage] = []
        self._collect: ResultDetails | None = None

    def emit(self, details: EmitDetails) -> "Pipeline":
        if self._emit is not None:
            raise ValueError("emit() already called; a pipeline has one emit")
        if not isinstance(details, EmitDetails):
            raise TypeError(f"emit() takes EmitDetails, got {type(details)}")
        self._emit = details
        return self

    def stage(
        self,
        fn: Callable[[Any], Any],
        *,
        nodes: int = 1,
        workers: int = 1,
        name: str | None = None,
        prefetch: int | None = None,
        flush_ms: float | None = None,
        route: str | None = None,
        key_fn: Callable[[Any], Any] | None = None,
    ) -> "Pipeline":
        if self._collect is not None:
            raise ValueError("stage() must precede collect()")
        if self._emit is None:
            raise ValueError("emit() must precede the first stage()")
        name = name or f"stage{len(self._stages)}"
        if any(s.name == name for s in self._stages):
            raise ValueError(f"duplicate stage name {name!r}")
        if prefetch is not None and prefetch < 0:
            raise ValueError(f"stage {name!r}: prefetch must be >= 0")
        if flush_ms is not None and flush_ms < 0:
            raise ValueError(f"stage {name!r}: flush_ms must be >= 0")
        if route not in (None, "host", "peer"):
            raise ValueError(
                f"stage {name!r}: route must be None, 'host' or 'peer', "
                f"got {route!r}"
            )
        if key_fn is not None and route != "peer":
            raise ValueError(
                f"stage {name!r}: key_fn only applies to route='peer' hops"
            )
        if route == "peer" and not self._stages:
            raise ValueError(
                f"stage {name!r}: the first stage cannot use route='peer' — "
                "its input comes from the host-side emit"
            )
        self._stages.append(
            Stage(name=name, fn=fn, nclusters=nodes, workers_per_node=workers,
                  prefetch=prefetch, flush_ms=flush_ms, route=route,
                  key_fn=key_fn)
        )
        return self

    def collect(self, details: ResultDetails) -> "Pipeline":
        if self._collect is not None:
            raise ValueError("collect() already called; a pipeline has one "
                             "collect")
        if not isinstance(details, ResultDetails):
            raise TypeError(
                f"collect() takes ResultDetails, got {type(details)}"
            )
        self._collect = details
        return self

    def build(self) -> PipelineSpec:
        if self._emit is None:
            raise ValueError("pipeline is missing emit(...)")
        if not self._stages:
            raise ValueError("pipeline is missing at least one stage(...)")
        if self._collect is None:
            raise ValueError("pipeline is missing collect(...)")
        return PipelineSpec.simple(
            host=self._host,
            emit_details=self._emit,
            stages=self._stages,
            result_details=self._collect,
            constants=self._constants,
        )


def parse_cgpp(
    text: str, namespace: Mapping[str, Any] | None = None
) -> ClusterSpec | PipelineSpec:
    """Parse a ``.cgpp`` DSL file into a :class:`ClusterSpec`.

    The file has four sections delimited by the three annotations, exactly as
    Listing 1.  Section bodies are executed as Python with the process record
    classes pre-bound (the paper binds the Groovy GPP classes the same way via
    the ``cgpp`` file association, §6.1).  ``namespace`` supplies the user's
    data classes (e.g. ``Mdata``/``Mcollect`` equivalents).

    Two grammars share the frame:

    * **legacy** (Listing 1): one ``//@cluster N`` section → a
      :class:`ClusterSpec`, exactly as before;
    * **staged**: one or more ``//@stage <name> <N>`` sections in place of
      ``//@cluster`` → a :class:`PipelineSpec`.  Each stage section defines
      its ``AnyGroupAny`` (the nrfa/afoc records may be spelled out or are
      synthesised from ``group.workers``); the host-side per-stage server
      and merge are always synthesised, so the collect section needs only
      the ``Collect`` record.  The two forms cannot be mixed.
    """
    sections: dict[str, list[str]] = {
        "constants": [],
        "emit": [],
        "cluster": [],
        "collect": [],
    }
    # (name, n_expr, lineno, body lines) per //@stage section, in order.
    stage_sections: list[tuple[str, str, int, list[str]]] = []
    host: str | None = None
    ncluster_expr: str | None = None
    current = "constants"
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.rstrip()
        stripped = line.strip()
        m = _EMIT_RE.match(stripped)
        if m:
            if current != "constants":
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — "
                    + ("duplicate //@emit annotation" if host is not None
                       else "//@emit must appear before //@cluster and //@collect")
                )
            host = m.group("host")
            current = "emit"
            continue
        m = _CLUSTER_RE.match(stripped)
        if m:
            if stage_sections:
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — cannot mix //@cluster "
                    "with //@stage sections; use one grammar"
                )
            if current != "emit":
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — "
                    + ("duplicate //@cluster annotation"
                       if ncluster_expr is not None
                       else "//@cluster must follow the emit section")
                )
            ncluster_expr = m.group("n")
            current = "cluster"
            continue
        m = _STAGE_RE.match(stripped)
        if m:
            if ncluster_expr is not None:
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — cannot mix //@stage "
                    "with a //@cluster section; use one grammar"
                )
            if current == "collect":
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — //@stage must precede "
                    "//@collect"
                )
            if current not in ("emit", "stage"):
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — //@stage must follow "
                    "the emit section"
                )
            name = m.group("name")
            if any(name == s[0] for s in stage_sections):
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — duplicate //@stage "
                    f"{name!r} annotation"
                )
            stage_sections.append((name, m.group("n"), lineno, []))
            current = "stage"
            continue
        if _COLLECT_RE.match(stripped):
            if current == "collect":
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — duplicate //@collect "
                    "annotation"
                )
            if current not in ("cluster", "stage"):
                raise SyntaxError(
                    f"line {lineno}: {stripped!r} — //@collect must follow "
                    "the cluster (or final stage) section"
                )
            current = "collect"
            continue
        if stripped.startswith("//@"):
            # An annotation-looking line that matched none of the known
            # forms: report it rather than silently treating it as code.
            raise SyntaxError(
                f"line {lineno}: malformed annotation {stripped!r} — "
                "expected '//@emit <host-ip>', '//@cluster <N>', "
                "'//@stage <name> <N>' or '//@collect'"
            )
        if current == "stage":
            stage_sections[-1][3].append(line)
        else:
            sections[current].append(line)

    if host is None:
        raise SyntaxError("missing //@emit <host-ip> annotation")
    if ncluster_expr is None and not stage_sections:
        raise SyntaxError(
            "missing //@cluster <N> (or //@stage <name> <N>) annotation"
        )
    if current != "collect":
        raise SyntaxError("missing //@collect annotation")

    env: dict[str, Any] = {
        # Process records, bound like the GPP classes in the paper's IDE setup.
        "Emit": Emit,
        "OneNodeRequestedList": OneNodeRequestedList,
        "NodeRequestingFanAny": NodeRequestingFanAny,
        "AnyGroupAny": AnyGroupAny,
        "AnyFanOne": AnyFanOne,
        "Collect": Collect,
        "EmitDetails": EmitDetails,
        "DataDetails": EmitDetails,  # paper's name for the emit-side details
        "ResultDetails": ResultDetails,
    }
    env.update(namespace or {})

    exec("\n".join(sections["constants"]), env)  # noqa: S102 - DSL execution
    constants = {
        k: v
        for k, v in env.items()
        if isinstance(v, (int, float, str, bool)) and not k.startswith("_")
    }

    if stage_sections:
        return _build_pipeline_from_sections(
            host, env, constants, sections, stage_sections
        )

    # nclusters may reference a constant (Listing 2 uses `clusters`).
    nclusters = int(eval(ncluster_expr, env))  # noqa: S307 - DSL expression

    exec("\n".join(sections["emit"]), env)  # noqa: S102
    exec("\n".join(sections["cluster"]), env)  # noqa: S102
    exec("\n".join(sections["collect"]), env)  # noqa: S102

    records = {k: v for k, v in env.items() if isinstance(v, ProcessRecord)}

    def _one(cls: type) -> Any:
        found = [v for v in records.values() if type(v) is cls]
        if len(found) != 1 and cls is not AnyFanOne:
            raise SyntaxError(
                f"specification must define exactly one {cls.__name__}, "
                f"found {len(found)}"
            )
        return found[0] if found else None

    emit = _one(Emit)
    onrl = _one(OneNodeRequestedList)
    nrfa = _one(NodeRequestingFanAny)
    group = _one(AnyGroupAny)
    collector = _one(Collect)
    fans = [v for v in records.values() if type(v) is AnyFanOne]
    if len(fans) != 2:
        raise SyntaxError(
            f"specification must define exactly two AnyFanOne processes "
            f"(afoc per node + afo at host), found {len(fans)}"
        )
    # Disambiguate by sources: afoc merges the node's workers, afo the nodes.
    afoc = next((f for f in fans if f.sources == group.workers), None)
    afo = next((f for f in fans if f is not afoc), None)
    if afoc is None or afo is None:
        raise SyntaxError(
            "cannot identify afoc (sources == workers) among AnyFanOne records"
        )

    spec = ClusterSpec(
        host=host,
        nclusters=nclusters,
        host_net=HostNetwork(emit=emit, onrl=onrl, afo=afo, collector=collector),
        node_net=NodeNetwork(nrfa=nrfa, group=group, afoc=afoc),
        constants=constants,
    )
    spec.validate()
    return spec


def _build_pipeline_from_sections(
    host: str,
    env: dict[str, Any],
    constants: dict[str, Any],
    sections: dict[str, list[str]],
    stage_sections: list[tuple[str, str, int, list[str]]],
) -> PipelineSpec:
    """Execute the staged-grammar sections and assemble a PipelineSpec.

    Records are harvested *per section*: a section owns the records its
    body binds (assigns to a name), so two stages may reuse the natural
    names ``group``/``nrfa``/``afoc`` without colliding, and a prebuilt
    record supplied via ``namespace=`` counts for the section that binds
    it (``group = G``), not for whichever section ran first.
    """

    def _exec_section(body: list[str]) -> list[ProcessRecord]:
        before = dict(env)
        exec("\n".join(body), env)  # noqa: S102 - DSL execution
        out: list[ProcessRecord] = []
        ids: set[int] = set()
        for k, v in env.items():
            if (isinstance(v, ProcessRecord) and before.get(k) is not v
                    and id(v) not in ids):
                out.append(v)
                ids.add(id(v))
        return out

    emit_records = _exec_section(sections["emit"])
    emits = [v for v in emit_records if type(v) is Emit]
    if len(emits) != 1:
        raise SyntaxError(
            f"emit section must define exactly one Emit, found {len(emits)}"
        )
    onrls = [v for v in emit_records if type(v) is OneNodeRequestedList]
    first_onrl = onrls[0] if len(onrls) == 1 else None

    stage_nets: list[StageNetwork] = []
    for idx, (name, n_expr, lineno, body) in enumerate(stage_sections):
        try:
            nclusters = int(eval(n_expr, env))  # noqa: S307 - DSL expression
        except Exception as exc:
            raise SyntaxError(
                f"line {lineno}: //@stage {name}: cannot evaluate node "
                f"count {n_expr!r}: {exc}"
            ) from exc
        recs = _exec_section(body)
        groups = [v for v in recs if type(v) is AnyGroupAny]
        if len(groups) != 1:
            raise SyntaxError(
                f"line {lineno}: stage {name!r} must define exactly one "
                f"AnyGroupAny, found {len(groups)}"
            )
        group = groups[0]
        nrfas = [v for v in recs if type(v) is NodeRequestingFanAny]
        if len(nrfas) > 1:
            raise SyntaxError(
                f"line {lineno}: stage {name!r} defines {len(nrfas)} "
                "NodeRequestingFanAny records; at most one is allowed"
            )
        nrfa = nrfas[0] if nrfas else NodeRequestingFanAny(
            destinations=group.workers
        )
        fans = [v for v in recs if type(v) is AnyFanOne]
        if len(fans) > 1:
            raise SyntaxError(
                f"line {lineno}: stage {name!r} defines {len(fans)} "
                "AnyFanOne records; at most one (the per-node afoc) is "
                "allowed — the host-side merge is synthesised"
            )
        afoc = fans[0] if fans else AnyFanOne(sources=group.workers)
        onrl = (first_onrl if idx == 0 and first_onrl is not None
                else OneNodeRequestedList())
        stage_nets.append(
            StageNetwork(
                name=name,
                nclusters=nclusters,
                node_net=NodeNetwork(nrfa=nrfa, group=group, afoc=afoc),
                onrl=onrl,
            )
        )

    collect_records = _exec_section(sections["collect"])
    collectors = [v for v in collect_records if type(v) is Collect]
    if len(collectors) != 1:
        raise SyntaxError(
            "collect section must define exactly one Collect, found "
            f"{len(collectors)}"
        )

    spec = PipelineSpec(
        host=host,
        emit=emits[0],
        stages=stage_nets,
        collector=collectors[0],
        constants=constants,
    )
    spec.validate()
    return spec


def load_cgpp(
    path: str, namespace: Mapping[str, Any] | None = None
) -> ClusterSpec | PipelineSpec:
    with open(path, "r", encoding="utf-8") as fh:
        return parse_cgpp(fh.read(), namespace)
