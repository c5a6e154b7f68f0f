"""Mesh construction, as the reference's ``launch/mesh.py``: functions,
not module-level constants, so importing this module touches no process
group and no device.

The production meshes need a process group of their world size already
started (``torchrun`` with 256 or 512 ranks, or the ``"fake"`` group of
the dry run); ``make_local_mesh`` starts a one-rank group when there is
none.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device


def production_shape(multi_pod: bool = False):
    """(shape, axis names) of the 16 x 16 pod or the 2 x 16 x 16 pair."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _device_type() -> str:
    """The mesh's device type from the default group's backend: NCCL's
    is the card, gloo's and the fake group's the CPU."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks per pod ``("data", "model")``; 2 pods = 512
    ranks ``("pod", "data", "model")`` when ``multi_pod``.  Raises,
    naming the world size, unless the default process group holds
    exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = production_shape(multi_pod)
    want = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != want:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} production mesh needs a "
            f"world of {want} ranks (torchrun --nproc-per-node ...); this "
            f"process runs in a world of size {world}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_local_mesh(device: DeviceLike = None):
    """Every rank of the world as a 1-D ``"data"`` mesh.  With no process
    group, starts a one-rank group: NCCL on the card (the default), gloo
    only when ``device="cpu"`` is asked for; a request for the card
    without one raises (no quiet fall back to gloo)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    elif (dev.type == "cuda") != (dist.get_backend() == "nccl"):
        raise ValueError(f"the process group's backend "
                         f"{dist.get_backend()!r} does not drive "
                         f"{dev.type!r} tensors")
    return init_device_mesh(dev.type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))
