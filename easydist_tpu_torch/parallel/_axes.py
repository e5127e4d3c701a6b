"""A DeviceMesh axis as the manual parallel modes use it."""

from __future__ import annotations

from typing import NamedTuple


class Axis(NamedTuple):
    """One mesh axis seen from this rank: its process group, its size and
    this rank's coordinate on it."""
    group: object
    size: int
    index: int


def mesh_axis(mesh, axis: str) -> Axis:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"{axis!r} is not an axis of the mesh {names}")
    return Axis(mesh.get_group(axis), int(mesh.size(names.index(axis))),
                int(mesh.get_local_rank(axis)))


def local_block(x, dim: int, n: int, idx: int, what: str = "batch"):
    """This rank's `idx`-th of `n` equal blocks of `x` along `dim`."""
    if x.shape[dim] % n:
        raise ValueError(f"{what} dim {x.shape[dim]} is not divisible by "
                         f"the axis size {n}")
    size = x.shape[dim] // n
    return x.narrow(dim, idx * size, size)
