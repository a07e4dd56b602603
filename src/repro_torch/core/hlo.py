"""Parsing of compiled (SPMD-partitioned) HLO text.

``compiled.cost_analysis()`` does not report collective traffic, so the
roofline pipeline extracts it from ``compiled.as_text()`` directly: every
``all-reduce`` / ``all-gather`` / ``reduce-scatter`` / ``all-to-all`` /
``collective-permute`` op line carries its result shape and replica groups,
from which per-device link traffic follows (ring algorithm).

Shapes in the partitioned module are per-device shards, so the byte counts
derived here are *per device*; the roofline collective term is
``per_device_bytes / link_bw`` == the assignment's
``collective_bytes / (chips * link_bw)`` with global ``collective_bytes``.

The text parser is the JAX package's, unchanged.  The port's own source of
the same figures is :class:`TraceRecorder`, a ``TorchDispatchMode`` that
sees every local op a traced step runs (under DTensor, after DTensor has
turned each op into local ops and ``c10d_functional`` collectives): each
collective becomes a :class:`CollectiveOp` with its per-device result bytes
and group size, so the ring formulas of ``link_bytes`` carry over; every op
adds its FLOPs (``torch.utils.flop_counter``'s registry, the one
``FlopCounterMode`` reads) and its bytes (inputs read plus outputs
written); the live bytes of the storages the step creates give its peak.
``TraceRecorder.hlo_text()`` writes the program one op a line in HLO's
syntax, collectives with their ``replica_groups``, so
``parse_collectives`` reads it as it reads XLA's.
"""

from __future__ import annotations

import re
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# e.g.  %all-reduce.2 = f32[2,128,512]{2,1,0} all-reduce(%x), channel_id=1,
#       replica_groups=[4,16]<=[64], ...
_OP_RE = re.compile(
    r"=\s*(?P<shape>\(?[\w\[\],{} ]+?\)?)\s+"
    r"(?P<op>all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?P<start>-start)?\(",
)
_ARRAY_RE = re.compile(r"(?P<dtype>[a-z][a-z0-9]*)\[(?P<dims>[\d,]*)\]")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(?P<ngroups>\d+),(?P<gsize>\d+)\]<=")
_EXPL_GROUPS_RE = re.compile(r"replica_groups=\{\{(?P<first>[\d,]+)\}")


def _array_bytes(text: str) -> int:
    """Sum byte sizes of every dtype[dims] array in a shape string."""
    total = 0
    for m in _ARRAY_RE.finditer(text):
        dt = m.group("dtype")
        if dt not in _DTYPE_BYTES:
            continue
        dims = m.group("dims")
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int  # per-device bytes of the op result
    group_size: int
    line: str

    @property
    def link_bytes(self) -> float:
        """Per-device bytes moved over ICI links (ring algorithm).

        all-reduce moves 2*B*(g-1)/g (reduce-scatter + all-gather phases);
        all-gather's result IS the gathered array: B*(g-1)/g received;
        reduce-scatter's result is the shard: each device sends/receives
        ~B_result*(g-1); all-to-all exchanges (g-1)/g of the buffer;
        collective-permute forwards the whole buffer once.
        """
        g = max(self.group_size, 1)
        b = float(self.result_bytes)
        if g == 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * b * (g - 1) / g
        if self.kind == "all-gather":
            return b * (g - 1) / g
        if self.kind == "reduce-scatter":
            return b * (g - 1)
        if self.kind == "all-to-all":
            return b * (g - 1) / g
        if self.kind == "collective-permute":
            return b
        return b


@dataclass
class CollectiveSummary:
    ops: list[CollectiveOp] = field(default_factory=list)

    @property
    def total_link_bytes(self) -> float:
        return sum(op.link_bytes for op in self.ops)

    @property
    def total_result_bytes(self) -> int:
        return sum(op.result_bytes for op in self.ops)

    def by_kind(self) -> dict[str, tuple[int, float]]:
        agg: dict[str, tuple[int, float]] = defaultdict(lambda: (0, 0.0))
        for op in self.ops:
            n, b = agg[op.kind]
            agg[op.kind] = (n + 1, b + op.link_bytes)
        return dict(agg)

    def schedule(self) -> list[str]:
        """The collective schedule in program order (kind x group size)."""
        return [f"{op.kind}(g={op.group_size}, {op.result_bytes}B)" for op in self.ops]

    def describe(self) -> str:
        lines = [f"{'kind':<22}{'count':>6}{'link MiB/device':>18}"]
        for kind, (n, b) in sorted(self.by_kind().items()):
            lines.append(f"{kind:<22}{n:>6}{b / 2**20:>18.3f}")
        lines.append(
            f"{'TOTAL':<22}{len(self.ops):>6}{self.total_link_bytes / 2**20:>18.3f}"
        )
        return "\n".join(lines)


def parse_collectives(hlo_text: str) -> CollectiveSummary:
    """Extract all collective ops (with per-device sizes) from HLO text.

    Ops inside ``while`` bodies appear once; callers lowering scanned
    programs must scale by trip count themselves (the roofline pipeline
    lowers unrolled probes precisely to avoid that).
    """
    summary = CollectiveSummary()
    for raw in hlo_text.splitlines():
        line = raw.strip()
        m = _OP_RE.search(line)
        if not m:
            continue
        if "-done" in line.split("=")[0]:
            continue  # async completion op: counted at its -start
        kind = m.group("op")
        result_bytes = _array_bytes(m.group("shape"))
        g = 1
        gm = _IOTA_GROUPS_RE.search(line)
        if gm:
            g = int(gm.group("gsize"))
        else:
            gm = _EXPL_GROUPS_RE.search(line)
            if gm:
                g = len(gm.group("first").split(","))
        summary.ops.append(
            CollectiveOp(kind=kind, result_bytes=result_bytes, group_size=g, line=line)
        )
    return summary


def count_op(hlo_text: str, opname: str) -> int:
    """Count occurrences of an HLO op (e.g. 'fusion', 'while', 'custom-call')."""
    return len(re.findall(rf"\b{re.escape(opname)}\(", hlo_text))


# ---------------------------------------------------------------------------
# The port's source: a recorder of the local ops a traced step runs.
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {
    "bool": "pred", "int8": "s8", "uint8": "u8", "int16": "s16",
    "int32": "s32", "int64": "s64", "float16": "f16", "bfloat16": "bf16",
    "float32": "f32", "float64": "f64", "complex64": "c64",
    "complex128": "c128", "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2",
}

# c10d_functional op -> the HLO collective it is
_TORCH_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "send": "collective-permute",
    "recv": "collective-permute",
}


# ``torch.tensor(...)`` lifts its real literal into the fake mode
_LIFTS = frozenset({"lift_fresh", "lift_fresh_copy", "lift"})


def _tensors(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def hlo_shape(t) -> str:
    dt = _TORCH_DTYPES.get(str(t.dtype).replace("torch.", ""), "f32")
    return f"{dt}[{','.join(str(int(d)) for d in t.shape)}]"


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _storage_key(t):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _group_size(func_name: str, args) -> int:
    """A c10d_functional op's group size: its ``group_size`` argument, or
    the size of the group its name resolves to."""
    import torch.distributed.distributed_c10d as c10d

    if func_name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                     "all_gather_into_tensor_coalesced",
                     "reduce_scatter_tensor_coalesced"):
        for a in args:
            if isinstance(a, int) and not isinstance(a, bool):
                return a
    for a in reversed(args):
        if isinstance(a, str):
            try:
                return c10d._resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                break
    return 1


class TraceRecorder:
    """Record a traced step's local ops: collectives, FLOPs, bytes and the
    peak of live storage.  Use as a context manager around the trace; it
    lets DTensor (and only DTensor) run first, so it sees each op as it
    runs on one device.  The ops DTensor runs on global shapes to find an
    output's shape (``ShardingPropagator``'s fake propagation) are not the
    program and are not recorded."""

    _SKIP = frozenset({
        "detach", "size", "sym_size", "stride", "sym_stride", "numel",
        "sym_numel", "dim", "is_contiguous", "sym_is_contiguous",
        "storage_offset", "sym_storage_offset", "_local_scalar_dense", "device",
    })

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        recorder = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return recorder._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()
        self._quiet = 0
        # set for a fake trace: the ops that were handed a real tensor (a
        # tensor the step closes over, or one made outside the fake mode)
        self.fake_only = False
        self.real_inputs: list[str] = []
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives = CollectiveSummary()
        self.lines: list[str] = []
        self.ops = 0
        self._live: dict = {}  # storage key -> [bytes, live tensors]
        self.live_bytes = 0
        self.peak_bytes = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        self._patched = getattr(ShardingPropagator, name, None)
        if self._patched is not None:
            def quiet(prop, *args, _orig=self._patched, **kw):
                self._quiet += 1
                try:
                    return _orig(prop, *args, **kw)
                finally:
                    self._quiet -= 1

            setattr(ShardingPropagator, name, quiet)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        try:
            return self._mode.__exit__(*exc)
        finally:
            if self._patched is not None:
                ShardingPropagator._propagate_tensor_meta_non_cached = self._patched

    # -- per op -----------------------------------------------------------------

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor lower it to local ops
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        ins = list(_tensors((args, kwargs)))
        packet = getattr(func, "_overloadpacket", None)
        name = getattr(packet, "__name__", str(func))
        if self.fake_only and not self._quiet and name not in _LIFTS:
            from torch._subclasses.fake_tensor import FakeTensor

            if any(not isinstance(t, FakeTensor) and not t.is_meta for t in ins):
                self.real_inputs.append(str(func))
        if self._quiet or any(t.is_meta for t in ins + outs):
            return out  # DTensor's own shape propagation, not the program
        if name in self._SKIP or name == "wait_tensor":
            return out
        returns = getattr(func, "_schema", None)
        returns = returns.returns if returns is not None else ()
        view = bool(returns) and all(
            r.alias_info is not None and not r.alias_info.is_write
            for r in returns)
        if not view:
            self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        flops = 0
        if packet in self._flop_registry:
            flops = int(self._flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += flops
        if not view and not any(r.alias_info is not None for r in returns):
            for t in outs:  # a new tensor: views and in-place ops allocate none
                self._track(t)
        self.ops += 1
        kind = _TORCH_COLLECTIVES.get(name)
        shape = (hlo_shape(outs[0]) if len(outs) == 1
                 else "(" + ", ".join(hlo_shape(t) for t in outs) + ")")
        operands = ", ".join(hlo_shape(t) for t in ins)
        if kind is not None:
            g = _group_size(name, args)
            result = sum(map(_nbytes, outs))
            line = (f"%{kind}.{self.ops} = {shape} {kind}({operands}), "
                    f"replica_groups=[1,{g}]<=[{g}]")
            self.collectives.ops.append(
                CollectiveOp(kind=kind, result_bytes=result, group_size=g,
                             line=line))
        else:
            line = f"%{name}.{self.ops} = {shape} {name}({operands})"
            if flops:
                line += f", flops={flops}"
        self.lines.append(line)
        return out

    def _track(self, t) -> None:
        key = _storage_key(t)
        if key is None:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += entry[0]
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self._live[key]

    def created(self, t) -> bool:
        """Whether ``t``'s storage was made by the recorded step."""
        return _storage_key(t) in self._live

    def hlo_text(self) -> str:
        return "\n".join(self.lines)
