"""Meshes (port of ``repro.launch.mesh``).

The reference's production mesh is a TPU pod: 16 x 16 = 256 chips, or two
pods, 512.  The port runs on one card, so its only mesh is a record of
that card: axes ("data", "model") of shape (1, 1).  Nothing here touches
the device; a mesh describes a layout for the sharding specs
(``models.sharding``) and places nothing.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class Mesh:
    """Named axes over devices: ``shape`` gives each axis's size."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: Tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16 x 16 pod (256 chips; 2 x 16 x 16 = 512 when
    multi_pod).  Raises: the port runs on one card."""
    chips = 512 if multi_pod else 256
    raise NotImplementedError(
        f"the production mesh is a {'2 x ' if multi_pod else ''}16 x 16 TPU "
        f"pod of {chips} chips; the port runs on one card "
        "(launch.mesh.make_host_mesh)")


def make_host_mesh(*, model: int = 1) -> Mesh:
    """The one-card mesh over ``cuda:0``: axes ("data", "model"), shape
    (1, 1)."""
    if model != 1:
        raise ValueError(f"make_host_mesh: a model axis of {model} needs "
                         f"{model} cards; the port runs on one")
    return Mesh(("data", "model"), (1, 1), ("cuda:0",))
