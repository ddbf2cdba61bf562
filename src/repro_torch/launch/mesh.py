"""Production mesh construction (PyTorch port of ``repro.launch.mesh``).

The port runs on one card and builds no device mesh: a ``Mesh`` here is
the abstract shape the dry-run (``launch.dryrun``) and the partition
specs (``models.shardings``) reason about, with the JAX mesh's
``axis_names``, ``shape`` dict and ``size``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh: axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry-run's target: 256 H100 SXM cards as a 16 x 16 mesh, or 2
    pods of them (512 cards), in 8-card NVLink nodes.

    Axes: ("data", "model") single pod; ("pod", "data", "model")
    multi-pod.  A 16-wide ``model`` axis spans two nodes, so its
    collectives ride 400 Gb/s NDR InfiniBand (the slow link of the
    roofline); "pod" rides the links between pods.  The cells' global
    batches are sized for these shapes, which the JAX package's TPU
    meshes share.
    """
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> Mesh:
    """A small mesh for tests and benchmarks; ``(1, 1)`` over ("data",
    "model") is one card."""
    return Mesh(tuple(axes), tuple(shape))
