"""Mesh construction on torch.distributed, and the card's hardware table.

Counterpart of `repro.launch.mesh`.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with ``mesh_dim_names``, built
over the process group that the caller initialised (its address, world
size and rank are the caller's to give).  Functions, not module
constants, so importing this module touches no process group.

The mesh's device type follows the group's backend: "cpu" for gloo
(its ranks may share one card: the compute stays on the card and the
collectives cross the host, `parallel.collectives`), "cuda" for NCCL
(one card a rank).
"""
from __future__ import annotations

import torch.distributed as dist


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """The serving and training mesh over nodes of 8 H100s: ``model``
    inside a node (NVLink), ``data`` across nodes, and a leading ``pod``
    axis for a multi-pod job.  The world size must be a multiple of 8
    (of 16 with ``multi_pod``)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world % (16 if multi_pod else 8):
        raise ValueError(f"a world of {world} ranks is not whole nodes of "
                         "8 cards" + (" in 2 pods" if multi_pod else ""))
    if multi_pod:
        return init_device_mesh(_device_type(), (2, world // 16, 8),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(_device_type(), (world // 8, 8),
                            mesh_dim_names=("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1):
    """A (data, model) mesh over the first data * model ranks of the
    initialised process group, which must have exactly that many."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=("data", "model"))


HARDWARE = {
    # NVIDIA H100 SXM (H100 80GB HBM3, 700 W), per card
    "peak_flops_bf16": 989e12,     # FLOP/s, dense tensor cores
    "hbm_bandwidth": 3.35e12,      # B/s
    "nvlink_bandwidth": 450e9,     # B/s per direction (NVLink 4, 18 links)
    "internode_bandwidth": 50e9,   # B/s per card (400 Gb/s InfiniBand NDR)
    "hbm_bytes": 80e9,
}
