"""Production mesh descriptions and their binding to ranks (the counterpart
of ``repro/launch/mesh.py``).

A ``Mesh`` is a plain description: its shape, its axis names and its
device count.  It holds no devices and starts no process group; the
dry-run (``launch/dryrun.py``) reads only its device count, and the
logical rules (``models/common.py::LogicalRules``) read its axis sizes.

``DistMesh`` binds a ``Mesh`` to the ranks of the caller's
``torch.distributed`` process group, through a ``DeviceMesh`` whose axis
names are the mesh's: rank ``i`` sits at the row-major coordinate ``i`` of
the shape.  It may sit on the first ``devices`` ranks of a larger
world (the elastic trainer's phase at scale k uses the first
k * model_axis); the other ranks build it too (``new_group`` is collective
over the world) and get no coordinate.  With no process group a mesh of
one device is the world of one: no group, coordinate 0 on every axis.  A
mesh above one device with no process group raises.

``StandInMesh`` is a ``Mesh`` seen from rank 0 with no process group: the
dry-run counts a cell's sharded step on it (``launch/dryrun.py``), each
collective recorded in its ``log`` and not run (``distributed.py``).

The production meshes are the JAX package's: one pod of 16 x 16 devices,
axes ("data", "model"), and two such pods, axes ("pod", "data", "model").
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named device grid: ``shape[i]`` devices along axis ``axes[i]``."""

    shape: tuple[int, ...]
    axes: tuple[str, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "shape", tuple(int(n) for n in self.shape))
        object.__setattr__(self, "axes", tuple(self.axes))
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axes} differ in length")
        if len(set(self.axes)) != len(self.axes):
            raise ValueError(f"mesh axes {self.axes} repeat a name")
        if any(n < 1 for n in self.shape):
            raise ValueError(f"mesh shape {self.shape} has an axis below 1")

    @property
    def devices(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> dict[str, int]:
        """Axis name -> extent (the reference's ``mesh.shape``)."""
        return dict(zip(self.axes, self.shape))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Arbitrary mesh (elastic scaling uses smaller DP extents)."""
    return Mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


class DistMesh:
    """``mesh`` bound to ranks of the caller's process group.

    ``coords`` maps each axis to this rank's index on it (None on a rank
    outside the mesh); ``group(axis)`` is the process group of the ranks
    that differ from this one on ``axis`` alone; ``member`` says whether
    this rank is in the mesh.  ``device_type`` names the ``DeviceMesh``'s
    device type; the backend is the process group's."""

    def __init__(self, mesh: Mesh, device_type: str = "cpu"):
        import torch
        import torch.distributed as dist

        self.mesh = mesh
        self.device_mesh = None
        if not dist.is_available() or not dist.is_initialized():
            if mesh.devices != 1:
                raise ValueError(f"mesh {mesh.shape} spans {mesh.devices} devices: it needs "
                                 "the caller's torch.distributed process group")
            self.coords: dict = {a: 0 for a in mesh.axes}
            return
        world = dist.get_world_size()
        if mesh.devices > world:
            raise ValueError(f"Number of devices {world} must be >= the product of "
                             f"mesh_shape {mesh.shape}")
        from torch.distributed.device_mesh import DeviceMesh

        self.device_mesh = DeviceMesh(device_type, torch.arange(mesh.devices).view(mesh.shape),
                                      mesh_dim_names=mesh.axes)
        coord = self.device_mesh.get_coordinate()
        self.coords = ({a: None for a in mesh.axes} if coord is None
                       else dict(zip(mesh.axes, coord)))

    @property
    def axes(self) -> tuple[str, ...]:
        return self.mesh.axes

    @property
    def sizes(self) -> dict[str, int]:
        return self.mesh.sizes

    @property
    def member(self) -> bool:
        return all(c is not None for c in self.coords.values())

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)


class StandInMesh:
    """``mesh`` as its rank 0 sees it, with no process group: coordinate 0
    on every axis, ``group`` None, and ``log``, the ``distributed.Collective``
    of every collective the rank's program asks for, in order.  The tensors
    of such a program are ``meta`` tensors: a collective is recorded and its
    output left as its shape."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.coords: dict = {a: 0 for a in mesh.axes}
        self.log: list = []

    member = True

    @property
    def axes(self) -> tuple[str, ...]:
        return self.mesh.axes

    @property
    def sizes(self) -> dict[str, int]:
        return self.mesh.sizes

    def group(self, axis: str):
        return None
