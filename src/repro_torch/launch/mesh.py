"""Production mesh construction — port of ``repro/launch/mesh.py``.

FUNCTIONS (not module constants), so importing this module touches no
process group.  The single-pod mesh is 16 x 16 = 256 ranks ("data",
"model"); the multi-pod mesh is 2 x 16 x 16 = 512 ranks ("pod", "data",
"model").  Both are built over the live ``torch.distributed`` process
group (gloo on the CPU, NCCL on CUDA), one rank a device.

``fake_production_mesh`` builds the production mesh over a fake process
group of 256 or 512 ranks in this one process (torch's ``"fake"``
backend: every collective returns at once, nothing crosses a wire), the
torch counterpart of the JAX dry run's 512 placeholder host devices: the
dry run traces a cell's step on fake tensors over it.
"""
from __future__ import annotations

import contextlib
import math

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


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """A CPU ``DeviceMesh`` of ``shape`` (named ``axes``) over a fake
    process group of prod(shape) ranks, this process rank 0; the group
    is destroyed on exit.  Refused by name when a process group already
    exists (the fake one cannot share the process with it), and when
    this torch has no fake process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            f"fake_mesh: a process group already exists (backend "
            f"{dist.get_backend()!r}, world size {dist.get_world_size()}); "
            f"a fake group of {math.prod(shape)} ranks cannot share the "
            f"process with it")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(f"torch {torch.__version__} has no fake process "
                           f"group (torch.testing._internal.distributed."
                           f"fake_pg): {e}") from e
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def fake_production_mesh(multi_pod: bool = False):
    """The production mesh (16 x 16, or 2 x 16 x 16) over a fake group of
    256 or 512 ranks: a context manager (see ``fake_mesh``)."""
    return fake_mesh(*production_mesh_shape(multi_pod))
