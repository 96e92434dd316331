"""Mesh descriptors.

The port of ``repro/launch/mesh.py``.  The port keeps every tensor on one
device, so a mesh is a description, not a set of devices: axis names and
sizes, read by the sharding rules (``repro_torch.models.sharding``) and
the elastic planner.  ``make_production_mesh`` gives the reference's
production shapes (for the spec tables); ``make_host_mesh`` the one card.

Axis roles (DESIGN.md section 5):
    pod    pure data parallelism across pods (gradient sync crosses the
           inter-pod links exactly once per step)
    data   in-pod data parallelism + ZeRO/fsdp parameter sharding
    model  tensor parallelism (heads / ff / experts / vocab) and sequence
           parallelism for long-context cells
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names in order, with their sizes."""

    axes: tuple  # ((name, size), ...)

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)


def make_mesh(shape, axis_names) -> MeshSpec:
    return MeshSpec(tuple(zip(axis_names, (int(s) for s in shape))))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(num_devices: int | None = None,
                   name: str = "data") -> MeshSpec:
    """1-D mesh over the devices the port runs on: the one card (or the
    CPU) unless the caller names a count."""
    return make_mesh((num_devices or 1,), (name,))


def mesh_chips(mesh) -> int:
    return math.prod(dict(mesh.shape).values())
