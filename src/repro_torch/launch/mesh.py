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

# The card's constants for the roofline (``launch/dryrun.py``) and the
# graph kernels' cost model (``benchmarks/kernelbench.py``): the NVIDIA
# H100 SXM data sheet's figures at its 700 W limit.  A card set to a lower
# power limit runs slower under load; ``nvidia-smi`` reports the limit.
PEAK_FLOPS_BF16 = 989e12  # dense bf16 on the tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12    # float32 on the CUDA cores (TF32 off), FLOP/s
HBM_BW = 3.35e12          # HBM3, bytes/s
HBM_BYTES = 80e9          # device memory, bytes


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
