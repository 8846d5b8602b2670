"""Elastic scaling, as ``repro/runtime/elastic.py``: resume a run on a
different number of ranks or another mesh shape.

A checkpoint holds full logical arrays (``checkpoint.manager``), so scaling
is (1) choosing a mesh for the ranks there are, (2) the state's shardings
on that mesh, (3) each rank keeping its blocks on restore.
``choose_mesh_shape`` picks the (data, model) factorization for any rank
count, shrinking the data axis first (the model axis, and so each rank's
layer blocks, stay as they were).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.sharding import specs


def choose_mesh_shape(n_devices: int, *, model_parallel: int = 16,
                      with_pod_axis: bool = False
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (data, model) grid with model axis <= model_parallel that
    divides n_devices; shrinks model parallelism only when unavoidable."""
    mp = min(model_parallel, n_devices)
    while mp > 1 and n_devices % mp:
        mp //= 2
    dp = n_devices // mp
    if with_pod_axis and dp % 2 == 0 and dp > 1:
        return (2, dp // 2, mp), ("pod", "data", "model")
    return (dp, mp), ("data", "model")


def remesh(n_devices: Optional[int] = None, *, model_parallel: int = 16,
           device_type: str = "cuda"):
    """The mesh ``choose_mesh_shape`` gives for the process group's ranks
    (every rank calls it alike). ``n_devices``, where given, must be the
    group's size: a mesh here spans every rank of the group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"remesh: {n_devices} devices, but the process "
                         f"group has {world} ranks")
    shape, axes = choose_mesh_shape(world, model_parallel=model_parallel)
    return make_mesh(shape, axes, device_type)


def elastic_restore(manager, model, optimizer, *, mesh, step=None,
                    zero_stage: int = 3, device=None):
    """Restore a train state onto ``mesh`` (any shape): (state of DTensors,
    meta)."""
    from repro_torch.launch import steps as steps_mod
    with specs.use_mesh(mesh):
        shardings = steps_mod.state_shardings(
            model, steps_mod.train_state_shapes(model, optimizer), zero_stage)
    return manager.restore(step, shardings=shardings, device=device)
