"""Elastic re-meshing: resume the same job on a different node count.

Paper requirement 4 ("the application can be built and deployed ... using
different workstations, not restricted to a specific set") maps to: rebuild
the mesh from the surviving ranks, re-derive every placement through the
same rules, restore the checkpoint onto the new placements, continue.
``Nclusters`` is a *parameter* of the deployment, exactly as in the DSL.

SPMD cannot change topology mid-step, so elasticity is a step-boundary
operation: detect -> checkpoint (or use the last async one) -> rebuild ->
restore -> resume.  A node is ``devices_per_node * model_axis`` ranks of
the process group; the re-mesh is a ``DeviceMesh`` over the chosen nodes'
ranks (every rank of the group builds it, as ``DeviceMesh`` requires).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.channels import ShardingRules, rules_for_shape_kind


@dataclass
class ElasticController:
    """Owns the rank pool and builds (mesh, rules) for a node count."""

    model_axis: int = 1
    devices_per_node: int = 1
    shape_kind: str = "train"
    device_type: str = "cuda"

    def available_nodes(self, excluded: set[int] | None = None) -> list[int]:
        import torch.distributed as dist

        n_dev = dist.get_world_size() if dist.is_initialized() else 1
        nodes = n_dev // (self.devices_per_node * self.model_axis)
        return [n for n in range(nodes) if n not in (excluded or set())]

    def build(self, nodes: list[int]) -> tuple:
        """(DeviceMesh over the nodes' ranks as (data, model), its rules)."""
        from torch.distributed.device_mesh import DeviceMesh

        if not nodes:
            raise RuntimeError("no surviving nodes to build a mesh from")
        per_node = self.devices_per_node * self.model_axis
        ranks = [r for n in nodes for r in range(n * per_node, (n + 1) * per_node)]
        data = len(nodes) * self.devices_per_node
        grid = torch.tensor(ranks, dtype=torch.int64).reshape(data, self.model_axis)
        mesh = DeviceMesh(self.device_type, grid, mesh_dim_names=("data", "model"))
        rules: ShardingRules = rules_for_shape_kind(mesh, self.shape_kind)
        return mesh, rules

    def largest_batch_divisor_nodes(self, global_batch: int,
                                    excluded: set[int]) -> list[int]:
        """Pick the largest surviving node subset whose data-parallel degree
        divides the global batch (keeps the step semantics identical)."""
        nodes = self.available_nodes(excluded)
        while nodes:
            data = len(nodes) * self.devices_per_node
            if global_batch % data == 0:
                return nodes
            nodes = nodes[:-1]
        raise RuntimeError("no node subset divides the global batch")
