"""Production mesh construction — port of ``repro/launch/mesh.py``.

FUNCTIONS (not module constants), so importing this module touches no
process group.  The single-pod mesh is 16 x 16 = 256 ranks ("data",
"model"); the multi-pod mesh is 2 x 16 x 16 = 512 ranks ("pod", "data",
"model").  Both are built over the live ``torch.distributed`` process
group (gloo on the CPU, NCCL on CUDA), one rank a device.
"""
from __future__ import annotations

import torch


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def production_mesh_shape(multi_pod: bool = False):
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh over the live process group; a world of
    another size than the mesh's is refused by name."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_mesh_shape(multi_pod)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} {axes} needs "
            f"{n} ranks, one a device; this process group has {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(n_devices: int = 1):
    """Small local mesh: (n, 1) ("data", "model") over the live process
    group's first n ranks (the whole group when n is its size)."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(_device_type(),
                      torch.arange(n_devices).reshape(n_devices, 1),
                      mesh_dim_names=("data", "model"))
