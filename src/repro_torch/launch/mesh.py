"""Mesh construction: the PyTorch counterpart of the JAX package's
``launch/mesh.py`` (functions, not module constants: importing this module
touches no process group or device).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group's ranks, wrapped in ``sharding.ops.Mesh``.  Meshes are built on
``cuda`` unless the caller asks for the CPU.  Where no process group exists
and the mesh has one rank, ``compat_make_mesh`` makes a group of this
process alone (NCCL for the card, beside gloo for host tensors; gloo for
the CPU), which the mesh destroys when it is closed.  Several ranks need
the caller's group: NCCL with one rank per card, or gloo where several
ranks share one card.  A group whose size is not the mesh's raises: no
mesh is ever quietly made smaller.
"""
from __future__ import annotations

import math


def compat_make_mesh(shape, axes, *, device=None):
    """A mesh of ``shape`` over the named ``axes`` on ``device`` (``cuda``
    unless another is passed), ranks in row-major order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device
    from repro_torch.sharding.ops import Mesh

    dev = resolve_device(device)
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    owns = False
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {shape} over {axes} needs a process group of {n} "
                               "ranks; found none (a world of 1)")
        backend = "cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        owns = True
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a mesh of {shape} over {axes} needs {n} ranks; the process "
                           f"group has {world}")
    return Mesh(init_device_mesh(dev.type, shape, mesh_dim_names=axes), owns_world=owns)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``: 256 or 512 ranks, or it raises with the count found."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_make_mesh(shape, axes, device=device)


def make_host_mesh(*, device=None):
    """The one-rank mesh (axis sizes 1) the launchers run under."""
    return compat_make_mesh((1, 1), ("data", "model"), device=device)


def elastic_mesh_shape(n_devices: int, *, model: int = 16):
    """Pick the largest (pod, data, model) grid for a degraded device count.

    Fault-tolerance path: after node failures the job restarts with
    whatever is healthy; ``model`` is kept fixed (weight layout stability)
    and the data axis absorbs the loss; leftover devices idle.
    """
    model = min(model, n_devices)
    while n_devices % model:
        model //= 2
    rest = n_devices // model
    # prefer a pod axis of 2 when even (cross-pod DP), else single pod
    if rest % 2 == 0 and rest >= 4:
        return (2, rest // 2, model), ("pod", "data", "model")
    return (rest, model), ("data", "model")
