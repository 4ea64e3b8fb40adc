"""Production meshes (the counterpart of ``repro/launch/mesh.py``).

A ``Mesh`` here is a small value: its axis names and sizes, in order
(``shape``, as a jax mesh's).  The sharding policy is arithmetic on it
alone, so a 2x16x16 mesh exists in any process.  ``device_mesh()`` turns
it into a ``torch.distributed.device_mesh.DeviceMesh``, which needs a
process group of the mesh's size: gloo on the CPU, NCCL on the card, or
the fake group of the dry run.  Functions, never module-level
constants: importing this module touches no process group, device or
environment variable.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch.distributed as dist


class Mesh:
    """Named mesh axes and their sizes, major to minor."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self._device_meshes: Dict[str, object] = {}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def device_mesh(self, device_type: str = "cpu"):
        """The ``DeviceMesh`` over the default process group, whose world
        size must be ``size`` (built once per device type: building one is
        a collective that makes its sub-groups)."""
        if device_type not in self._device_meshes:
            from torch.distributed.device_mesh import init_device_mesh
            self._device_meshes[device_type] = init_device_mesh(
                device_type, tuple(self.shape.values()),
                mesh_dim_names=self.axis_names)
        return self._device_meshes[device_type]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16x16 = 256 chips ("data", "model").
    Multi-pod: 2x16x16 = 512 chips ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_mesh(shape, axes) -> Mesh:
    """Arbitrary mesh helper for tests/examples."""
    return Mesh(tuple(shape), tuple(axes))


def make_host_mesh() -> Mesh:
    """The default group's ranks as a 1-D ("data",) mesh (1 when no group
    is initialized)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n,), ("data",))
