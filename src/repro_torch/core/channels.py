"""Typed channels and automatic sharding derivation (the JAX package's
``core/channels.py`` over a ``torch.distributed`` ``DeviceMesh``).

Users annotate tensors with logical axis names like ``("batch", "seq",
"d_model")``; they never write a placement (the analogue of never writing a
channel address).  Derivation walks an ordered rule table (first applicable
rule wins) with two soundness checks per dimension:

* **divisibility** — the dimension size must divide evenly over the mesh
  axes (padded archs are handled upstream via :func:`padded_size`);
* **exclusivity** — a mesh axis may shard at most one dimension of a tensor.

``partition_spec`` returns the JAX package's ``PartitionSpec`` entries as a
plain tuple (trailing ``None`` trimmed); ``placements`` turns it into
DTensor placements, one per mesh dimension.  The rule engine reads only the
mesh's axis names and sizes, so it can be built over a :class:`MeshShape`
(no process group) as well as over a ``DeviceMesh``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import torch

from repro_torch.configs.base import padded_size
from repro_torch.kernels._shard import contiguous_stride, place

__all__ = [
    "Channel", "MeshShape", "ShardingRules", "training_rules", "decode_rules",
    "long_context_rules", "rules_for_shape_kind", "padded_size", "pad_axis_to",
]

# A rule maps a logical axis name to a tuple of mesh axis names (applied
# together, e.g. ("pod", "data") for global data parallelism) or to None
# (replicate).  Rules earlier in the table take priority.
Rule = tuple[str, "tuple[str, ...] | None"]


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices or a process group:
    what the rule engine reads of a ``DeviceMesh``."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


@dataclass(frozen=True)
class Channel:
    """A typed channel: the unit the builder wires between stages.

    ``shape`` and ``dtype`` replace the paper's serialised object class,
    ``logical_axes`` replaces the address: the builder resolves it to a
    placement on the mesh.
    """

    name: str
    shape: tuple[int, ...]
    dtype: Any
    logical_axes: tuple[str | None, ...]

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(
                f"channel {self.name!r}: shape {self.shape} and logical axes "
                f"{self.logical_axes} have different ranks"
            )


def _is_device_mesh(mesh) -> bool:
    return hasattr(mesh, "device_type") and hasattr(mesh, "get_group")


class ShardingRules:
    """Ordered logical-axis -> mesh-axes rule table bound to a mesh."""

    def __init__(self, mesh, rules: Sequence[Rule]):
        self.mesh = mesh
        self.axis_names: tuple[str, ...] = tuple(mesh.mesh_dim_names)
        self.axis_sizes: dict[str, int] = dict(
            zip(self.axis_names, tuple(mesh.shape)))
        # Keep only mesh axes that exist (one table serves single- and
        # multi-pod meshes: ("pod", "data") degrades to ("data",) off-pod).
        self.rules: list[Rule] = []
        for name, axes in rules:
            if axes is None:
                self.rules.append((name, None))
            else:
                kept = tuple(a for a in axes if a in self.axis_sizes)
                self.rules.append((name, kept if kept else None))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.axis_sizes.values())

    # -- core derivation -----------------------------------------------------

    def partition_spec(self, shape: Sequence[int],
                       logical_axes: Sequence[str | None]) -> tuple:
        if len(shape) != len(logical_axes):
            raise ValueError(f"rank mismatch: {shape} vs {logical_axes}")
        used: set[str] = set()
        entries = [self._dim_axes(size, name, used)
                   for size, name in zip(shape, logical_axes)]
        while entries and entries[-1] is None:  # canonical PartitionSpec form
            entries.pop()
        return tuple(entries)

    def _dim_axes(self, size: int, name: str | None, used: set[str]):
        if name is None:
            return None
        for rule_name, axes in self.rules:
            if rule_name != name:
                continue
            if axes is None:
                return None
            if any(a in used for a in axes):
                continue
            prod = math.prod(self.axis_sizes[a] for a in axes)
            if prod == 0 or size % prod != 0:
                continue
            used.update(axes)
            return axes if len(axes) > 1 else axes[0]
        return None  # no applicable rule: replicate (always sound)

    def placements(self, shape: Sequence[int],
                   logical_axes: Sequence[str | None]) -> tuple:
        """DTensor placements, one per mesh dimension: ``Shard(d)`` where
        the spec puts tensor dim ``d`` on that mesh axis, else
        ``Replicate()``.  A dim sharded over several mesh axes is
        ``Shard(d)`` on each of them, in mesh order (the rules list them
        in mesh order).  A mesh axis of one device shards nothing: it is
        ``Replicate()`` (DTensor will not flatten a dim of size 1 sharded
        over it, as a product of a batch-1 activation does)."""
        from torch.distributed.tensor import Replicate, Shard

        out: list[Any] = [Replicate()] * len(self.axis_names)
        for d, entry in enumerate(self.partition_spec(shape, logical_axes)):
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if self.axis_sizes[a] > 1:
                    out[self.axis_names.index(a)] = Shard(d)
        return tuple(out)

    def local_shape(self, shape: Sequence[int],
                    logical_axes: Sequence[str | None]) -> tuple[int, ...]:
        """One device's shard of ``shape`` (the rules shard evenly)."""
        local = list(shape)
        for d, entry in enumerate(self.partition_spec(shape, logical_axes)):
            if entry is not None:
                axes = entry if isinstance(entry, tuple) else (entry,)
                local[d] //= math.prod(self.axis_sizes[a] for a in axes)
        return tuple(local)

    def sharding(self, channel_or_shape, logical_axes=None) -> tuple:
        """``(mesh, placements)``: what ``distribute_tensor`` takes."""
        if isinstance(channel_or_shape, Channel):
            shape = channel_or_shape.shape
            logical_axes = channel_or_shape.logical_axes
        else:
            shape = channel_or_shape
        return self.mesh, self.placements(shape, logical_axes)

    def distribute(self, x: torch.Tensor, logical_axes) -> torch.Tensor:
        """A full tensor, the same on every rank, placed onto the mesh by
        the rules: each rank keeps its own shard (no collective)."""
        mesh, placements = self.sharding(tuple(x.shape), logical_axes)
        return place(x, mesh, placements)

    def struct(self, channel: Channel, mode=None) -> torch.Tensor:
        """A fake DTensor for ``channel``: shape, dtype and placements with
        no allocation (the dry-run's input).  ``mode`` is the
        ``FakeTensorMode`` to make it in (default: :func:`fake_mode`)."""
        return fake_struct(self, channel.shape, channel.dtype,
                           channel.logical_axes, mode=mode)

    def constraint(self, x, logical_axes: Sequence[str | None]):
        """Redistribute a DTensor to the placements the rules derive for
        ``logical_axes`` (the JAX package's ``with_sharding_constraint``).
        A plain tensor is returned unchanged on a one-device mesh."""
        from torch.distributed.tensor import DTensor

        if not isinstance(x, DTensor):
            if self.size == 1:
                return x
            raise TypeError(
                "constraint() on a plain tensor over a mesh of "
                f"{self.size} devices: place the inputs with the rules first")
        placements = self.placements(tuple(x.shape), tuple(logical_axes))
        if tuple(x.placements) == placements:
            return x
        return x.redistribute(x.device_mesh, placements)

    # -- diagnostics ----------------------------------------------------------

    def describe(self, channels: Sequence[Channel]) -> str:
        lines = [f"{'channel':<28}{'shape':<28}{'partition spec'}"]
        for ch in channels:
            spec = self.partition_spec(ch.shape, ch.logical_axes)
            lines.append(f"{ch.name:<28}{str(ch.shape):<28}{spec}")
        return "\n".join(lines)


_FAKE_MODE = None


def fake_mode():
    """The process's ``FakeTensorMode`` for dry-run structs (made once)."""
    global _FAKE_MODE
    if _FAKE_MODE is None:
        from torch._subclasses.fake_tensor import FakeTensorMode

        _FAKE_MODE = FakeTensorMode(allow_non_fake_inputs=True)
    return _FAKE_MODE


def fake_struct(rules: ShardingRules, shape, dtype, logical_axes,
                mode=None) -> torch.Tensor:
    """A fake DTensor of global ``shape`` placed by ``rules`` (no
    allocation); a plain fake tensor where the mesh is a :class:`MeshShape`
    of one device."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    with (mode or fake_mode()):
        device = rules.mesh.device_type if _is_device_mesh(rules.mesh) else "cpu"
        local = torch.empty(rules.local_shape(shape, logical_axes),
                            dtype=dtype, device=device)
        if not _is_device_mesh(rules.mesh):
            return local
        placements = rules.placements(shape, logical_axes)
        return DTensor.from_local(local, rules.mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))




# ---------------------------------------------------------------------------
# Preset rule tables (one per execution shape-kind).
# ---------------------------------------------------------------------------

def _common_weight_rules() -> list[Rule]:
    return [
        # Tensor parallelism: feature/head/expert dims over the model axis.
        ("vocab", ("model",)),
        ("d_ff", ("model",)),
        ("d_attn", ("model",)),  # flattened q heads * head_dim (projections)
        ("d_kv_attn", ("model",)),
        ("heads", ("model",)),
        ("kv_heads", ("model",)),
        ("experts", ("model",)),
        ("rnn_state", ("model",)),
        # FSDP (ZeRO-3): the non-TP dim of every weight over the data axes.
        ("d_model_fsdp", ("pod", "data")),
        ("d_model_fsdp", ("data",)),
        ("layers", None),
        ("head_dim", None),
    ]


def training_rules(mesh) -> ShardingRules:
    """train_4k / prefill_32k: batch over (pod, data), TP over model.

    ``seq_sp`` is the residual-stream sequence axis: sharding it over the
    model axis is Megatron-style sequence parallelism.  Attention-internal
    ``seq`` stays unsharded (full context per shard).
    """
    return ShardingRules(
        mesh,
        [
            ("batch", ("pod", "data")),
            ("batch", ("data",)),
            ("seq_sp", ("model",)),
            ("seq", None),
            ("d_model", None),  # activations replicated on feature dim
        ]
        + _common_weight_rules(),
    )


def decode_rules(mesh) -> ShardingRules:
    """decode_32k: batch over (pod, data); KV heads over model when they
    divide, otherwise KV *sequence* over model (FlashDecoding split)."""
    return ShardingRules(
        mesh,
        [
            ("batch", ("pod", "data")),
            ("batch", ("data",)),
            ("kv_seq", ("model",)),  # consumed only if kv_heads didn't take it
            ("seq", None),
            ("d_model", None),
        ]
        + _common_weight_rules(),
    )


def long_context_rules(mesh) -> ShardingRules:
    """long_500k: batch==1 is unshardable; the KV cache / state shards over
    (data, model) sequence-wise — the whole pod serves one stream."""
    return ShardingRules(
        mesh,
        [
            ("batch", None),
            ("kv_seq", ("data", "model")),
            ("kv_seq", ("data",)),
            ("seq", None),
            ("d_model", None),
        ]
        + _common_weight_rules(),
    )


def rules_for_shape_kind(mesh, kind: str) -> ShardingRules:
    if kind in ("train", "prefill"):
        return training_rules(mesh)
    if kind == "decode":
        return decode_rules(mesh)
    if kind == "long":
        return long_context_rules(mesh)
    raise ValueError(f"unknown shape kind {kind!r}")


def pad_axis_to(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` to ``size`` (no-op when already there)."""
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        raise ValueError(f"cannot pad axis {axis} from {cur} down to {size}")
    pad_shape = list(x.shape)
    pad_shape[axis] = size - cur
    return torch.cat([x, x.new_zeros(pad_shape)], dim=axis)
