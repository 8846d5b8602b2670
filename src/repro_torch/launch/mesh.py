"""Mesh construction, as in ``repro/launch/mesh.py``, over
``torch.distributed.device_mesh.init_device_mesh``.

Single pod : (data=16, model=16)            = 256 ranks
Multi-pod  : (pod=2, data=16, model=16)     = 512 ranks

Each is a function (never a module-level constant), so importing this
module touches no process group. The process group must exist before a
call (``torch.distributed.init_process_group``, or ``torchrun``), with
as many ranks as the mesh has; every rank calls it alike."""
from __future__ import annotations


def make_mesh(shape, axes, device_type: str = "cuda"):
    """An arbitrary mesh, e.g. (2, 2) over ("data", "model") on 4 ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def describe(mesh) -> str:
    names = tuple(mesh.mesh_dim_names or ())
    return (f"mesh{dict(zip(names, tuple(mesh.shape)))}"
            f" ({mesh.mesh.numel()} devices)")
