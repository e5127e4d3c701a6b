"""Device-mesh management for the multi-device frontend: the port of
easydist_tpu/jaxfront/mesh.py.

The mesh is a `torch.distributed` `DeviceMesh` of any rank, with per-axis
interconnect metadata (`MeshAxisSpec`) driving the solver's cost model:
"nvlink" within a host, "ib" across hosts (`ib_axes`, the JAX package's
`dcn_axes`).  A process group must exist before a mesh is built, and a
mesh before a multi-device compile: there is no silent fallback to a
one-device mesh.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from easydist_tpu_torch.autoflow.cost_model import MeshAxisSpec

_GLOBAL_MESH = None
_GLOBAL_AXIS_SPECS: Optional[List[MeshAxisSpec]] = None


def _default_specs(mesh, ib_axes: Sequence[str] = ()) -> List[MeshAxisSpec]:
    names = mesh.mesh_dim_names or tuple(f"mesh{i}"
                                         for i in range(mesh.ndim))
    return [MeshAxisSpec(name=str(n), size=int(s),
                         kind="ib" if n in ib_axes else "nvlink")
            for n, s in zip(names, mesh.mesh.shape)]


def set_device_mesh(mesh, axis_specs: Optional[Sequence[MeshAxisSpec]] = None):
    """Install `mesh` (a DeviceMesh) as the global mesh, or clear it
    (None).  `axis_specs` defaults to NVLink axes sized from the mesh."""
    global _GLOBAL_MESH, _GLOBAL_AXIS_SPECS
    _GLOBAL_MESH = mesh
    _GLOBAL_AXIS_SPECS = None if mesh is None else list(
        axis_specs if axis_specs is not None else _default_specs(mesh))


def get_device_mesh():
    return _GLOBAL_MESH


def get_axis_specs(mesh=None) -> List[MeshAxisSpec]:
    """Axis specs of `mesh`: the installed specs when it is the global
    mesh, else NVLink specs derived from the mesh itself."""
    if mesh is None or mesh is _GLOBAL_MESH:
        if _GLOBAL_AXIS_SPECS is None:
            raise RuntimeError("device mesh not set; call make_device_mesh "
                               "or pass mesh= to easydist_compile")
        return _GLOBAL_AXIS_SPECS
    return _default_specs(mesh)


def make_device_mesh(shape: Sequence[int], axis_names: Sequence[str],
                     device_type: str = "cuda",
                     ib_axes: Sequence[str] = ()):
    """Build a DeviceMesh over the initialised default process group
    (`init_device_mesh`) and install it.  `ib_axes` names the axes that
    cross hosts, which the solver prices at InfiniBand rates."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "(address, world size and rank) before building a mesh")
    unknown = set(ib_axes) - set(axis_names)
    if unknown:
        raise ValueError(f"ib_axes {sorted(unknown)} are not mesh axes "
                         f"{tuple(axis_names)}")
    mesh = init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))
    set_device_mesh(mesh, _default_specs(mesh, ib_axes))
    return mesh
