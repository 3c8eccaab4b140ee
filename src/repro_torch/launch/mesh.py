"""Production mesh descriptions (the counterpart of ``repro/launch/mesh.py``).

A mesh here is a plain description: its shape, its axis names and its
device count.  It holds no devices and starts no process group; the
sharding layer maps it onto a ``torch.distributed`` ``DeviceMesh``.  The
dry-run (``launch/dryrun.py``) reads only its device count.

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


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """Arbitrary mesh (elastic scaling uses smaller DP extents)."""
    return Mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)
