"""Device meshes, the port of ``src/repro/launch/mesh.py``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``"data"``, ``"model"``, and ``"pod"`` on the multi-pod shapes).  Every
rank of the default process group builds the same mesh: rank ``r`` sits
at the row-major coordinates of ``r`` in the mesh's shape, so on the
``(2, 2)`` debug mesh rank ``2 i + s`` is ``(data=i, model=s)``.

Axes are roles, not sizes: everything downstream reads sizes from the mesh
(``batch_axes`` and ``model_axis`` read only the dim names).
:func:`abstract_mesh` is the port of ``jax.sharding.AbstractMesh``: dim
names and sizes without ranks, on which the placement rules and the cell
builder run for the production shapes; a collective needs a
``DeviceMesh``.

:func:`axis_group` is the port of a JAX axis name inside ``shard_map``:
the process group a collective over one axis, or over the product of
several, runs on, this rank's row-major index over those axes
(``jax.lax.axis_index``), and the group ranks in that index's order.  A
group over an axis tuple is made once per mesh and kept on it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

#: (shape, dim names) of the production meshes, as the JAX package's
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
#: the debug meshes: the same roles at the smallest sizes
DEBUG = {False: ((2, 2), ("data", "model")),
         True: ((2, 2, 2), ("pod", "data", "model"))}


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    ranks of the default process group (which must hold
    ``prod(shape)`` ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(device_type: str = "cuda", *,
                         multi_pod: bool = False):
    return make_mesh(*PRODUCTION[multi_pod], device_type)


def make_debug_mesh(device_type: str = "cuda", *, multi_pod: bool = False):
    """The production roles at size 2 a dim: 4 ranks, or 8 with the pod
    axis."""
    return make_mesh(*DEBUG[multi_pod], device_type)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's dim names and sizes, with no process behind it.  ``mesh``
    is the row-major grid of rank numbers a ``DeviceMesh`` of this shape
    would hold."""

    shape: tuple
    mesh_dim_names: tuple

    @property
    def mesh(self):
        import torch

        return torch.arange(math.prod(self.shape)).reshape(self.shape)


def abstract_mesh(shape, axes) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"{len(shape)} sizes for {len(axes)} dim names")
    return AbstractMesh(tuple(int(s) for s in shape), tuple(axes))


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axes) -> int:
    """The size of one dim, or the product of a tuple of dims."""
    names = axis_names(mesh)
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(int(mesh.mesh.shape[names.index(a)]) for a in axes)


def batch_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod axis included when present)."""
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def model_axis(mesh) -> str:
    return "model"


def mesh_devices(mesh) -> int:
    return int(mesh.mesh.numel())


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """The ranks that share every coordinate but those of ``axes``."""

    group: Optional[object]   # the ProcessGroup; None when axes is empty
    axes: tuple
    index: int                # this rank's row-major index over ``axes``
    size: int
    order: tuple              # order[j] = group rank of linear index j
    backend: Optional[str]


def axis_group(mesh, axes) -> AxisGroup:
    """The :class:`AxisGroup` of ``axes`` (a dim name, a tuple of names,
    or None for no axis) on ``mesh``.  One name takes the mesh's own
    group of that dim; a tuple of several makes one group for each of its
    rank sets, on every rank in the same order (``new_group`` is
    collective), and keeps this rank's on the mesh."""
    import torch.distributed as dist

    if isinstance(mesh, AbstractMesh):
        raise TypeError("an abstract mesh has no ranks to run a collective "
                        "on: build the step over a DeviceMesh to call it")
    if axes is None:
        axes = ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if axes in cache:
        return cache[axes]
    if not axes:
        cache[axes] = AxisGroup(None, (), 0, 1, (0,), None)
        return cache[axes]
    names = list(mesh.mesh_dim_names)
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh has no dim(s) {missing} (has {names})")
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in dims]
    size = math.prod(mesh.mesh.shape[d] for d in dims)
    # one row per rank set, each row in row-major order over ``axes``
    rows = mesh.mesh.permute(rest + dims).reshape(-1, size).tolist()
    me = dist.get_rank()
    mine = next(r for r in rows if me in r)
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        group = None
        for r in rows:
            g = dist.new_group(ranks=r)
            if r is mine:
                group = g
    in_group = dist.get_process_group_ranks(group)
    cache[axes] = AxisGroup(
        group=group, axes=axes, index=mine.index(me), size=size,
        order=tuple(in_group.index(r) for r in mine),
        backend=str(dist.get_backend(group)))
    return cache[axes]


def lazy_groups(mesh, *axes_list):
    """A function that returns the :class:`AxisGroup` of each entry of
    ``axes_list`` on ``mesh``, resolved at its first call: a step built
    over an :class:`AbstractMesh` builds, and raises only when called."""
    resolved: list = []

    def groups() -> tuple:
        if not resolved:
            resolved.extend(axis_group(mesh, a) for a in axes_list)
        return tuple(resolved)

    return groups
