"""Mesh planning: the JAX package's ``launch/mesh.py`` in part.

Only ``elastic_mesh_shape``, pure integer arithmetic that the restart path
(``checkpoint.fault_tolerance.plan_elastic_remesh``) needs, is here.  The
mesh constructors (``compat_make_mesh``, ``make_production_mesh``,
``make_host_mesh``) wait for the sharding slice, where they become
``torch.distributed.device_mesh`` meshes (ROADMAP item 13c).
"""
from __future__ import annotations


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
