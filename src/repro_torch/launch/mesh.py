"""Production mesh construction and the H100's roofline constants.

Functions, never module-level meshes: importing this module touches no
process group.  The production meshes keep the JAX package's shapes, so
cell by cell the specs, the padding (tp = 16) and the cell list stay
comparable with it: one pod is 16 x 16 = 256 devices ("data", "model"),
two pods 2 x 16 x 16 = 512 ("pod", "data", "model").  They are built on a
*fake* process group of that many ranks (``torch.distributed``'s "fake"
backend: collectives are recorded, nothing is sent), which is what the
dry-run and the roofline trace on; a real run on one card uses
``make_smoke_mesh``.
"""

from __future__ import annotations

import contextlib
import functools

import torch

# NVIDIA H100 SXM5 (80 GB HBM3) constants, the roofline's denominators.
# Dense BF16 tensor-core peak (NVIDIA H100 datasheet, SXM5: 989.4 TFLOP/s
# without sparsity).
PEAK_FLOPS_BF16 = 989e12
# HBM3 bandwidth (same datasheet, SXM5: 3.35 TB/s).
HBM_BW = 3.35e12
# NVLink 4 within an 8-GPU HGX node: 900 GB/s per GPU in both directions,
# 450 GB/s each way (datasheet).  A collective whose group spans nodes runs
# over one 400 Gb/s NDR InfiniBand port per GPU: 50 GB/s each way.
NVLINK_BW = 450e9
NODE_GPUS = 8
INTERNODE_BW = 50e9


@functools.cache
def _card_bytes() -> int:
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return 80 * 10**9  # the H100 SXM5's 80 GB, where no card is present


def __getattr__(name: str):
    # HBM_BYTES: the card's own total memory, read when first asked for.
    if name == "HBM_BYTES":
        return _card_bytes()
    raise AttributeError(name)


def link_bw(group_size: int) -> float:
    """Per-direction link bandwidth of a collective over ``group_size``
    devices: NVLink within a node, one NDR port per GPU across nodes."""
    return NVLINK_BW if group_size <= NODE_GPUS else INTERNODE_BW


def init_fake_process_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks (this process is rank
    0).  One global group per process: an existing group of another size
    is destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape, axis_names, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the current process group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The 16 x 16 (or 2 x 16 x 16) mesh on a fake process group of 256
    (or 512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_process_group(int(torch.tensor(shape).prod()))
    return make_mesh(shape, axes, device_type)


def make_smoke_mesh(data: int = 1, model: int = 1, device_type: str = "cuda"):
    """A (data, model) mesh over the current process group, made a
    one-rank group on this process when none exists (one card)."""
    import torch.distributed as dist

    if not dist.is_initialized():  # one rank needs no peer: an in-memory store
        dist.init_process_group(
            "gloo" if device_type == "cpu" else "nccl", rank=0, world_size=1,
            store=dist.HashStore())
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return make_mesh((data, model), ("data", "model"), device_type)


def model_axis_size(mesh) -> int:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))).get("model", 1)


def use_mesh(mesh):
    """A context for code that runs over ``mesh``.  DTensors carry their
    mesh, so there is no ambient mesh to set: a no-op context, kept so that
    callers read as the JAX package's do."""
    return contextlib.nullcontext(mesh)
